// Backward pass of blockwise attention (FlashAttention-2 scheme), for
// Hopper (sm_90a).
//
// The gradient of src/repro_torch/kernels/flash_attention/csrc/
// flash_attention.cu, the port of the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention
//   (pallas_call at kernel.py:105),
// which has no backward in the JAX package: JAX's training path
// differentiates jnp attention (src/repro/models/attention.py::gqa_prefill).
// Given q [B,S,H,hd], k/v [B,T,KV,hd], the forward's output o and its
// per-row log-sum-exp lse [B,H,S] (f32, natural log of the sum over the
// kept keys of exp(score)), and dO [B,S,H,hd], it returns dq, dk, dv in the
// inputs' dtype, accumulated in f32.  The mask is the forward's: query row
// i sits at position i + T - S; key j counts when j < T, j <= pos if
// causal, j > pos - window if window > 0.  A score is s = scale * q.k,
// tanh-softcapped to c * tanh(s / c) when softcap > 0 (its derivative
// 1 - tanh^2); masked entries contribute exactly zero.
//
// Three launches, none with atomics, so the result is deterministic (the
// same bits on every run):
//   1. D[b,h,i] = sum_d dO * O, one warp a row;
//   2. dK/dV: one block per (tile of keys, kv head, batch row).  It walks
//      the G query heads of its kv head and the query tiles the mask lets
//      see its keys, recomputes P = exp(score - lse) and
//      dS = P * (dP - D) from K, V, Q and dO, and sums dV += P^T dO and
//      dK += dS^T Q over them in registers (the GQA sum needs no atomics);
//   3. dQ: one block per (tile of query rows, q head, batch row), walking
//      the key tiles its rows can reach, dQ += dS K.
//
// What bounds it on an H100: five products of 2 * hd operations per kept
// (query, key) pair and head, 10 * hd in all (2.5 times the forward's),
// against the bytes of q, k, v, o, dO, lse and the three gradients, read
// or written once.  At the training shape (S = T = 4096, H = KV = 32,
// hd 80, causal) the operations bind by far: ~0.22 ms a batch row at
// bf16's tensor-core peak.  The dQ pass recomputes S and dP, so this
// two-pass design does 7 products, 14 * hd: its own ceiling is ~0.30 ms.
// What the design does about it: the products run on wgmma, fed from
// shared memory that TMA fills a few tiles ahead of them (no thread spends
// time on staging), the probabilities and dS stay in registers as the
// products' A operands, and masked tiles are skipped, not computed.
//
// Three designs, chosen by shape (kernel_bwd.py::design mirrors the
// choice in ``dispatch``; each a hand-written kernel, none a fallback):
//   * "wgmma": bf16 with hd a multiple of 8 up to 192 and 16-byte-aligned
//     q, k, v, dO -- what a TMA tensor map takes (its strides must be
//     multiples of 16 bytes).  Warp-specialised blocks: a producer keeps a
//     ring of Q/dO (or K/V) tiles in flight by TMA behind mbarriers, two
//     consumer warpgroups run the products on wgmma with P^T and dS^T fed
//     from their accumulators as register operands (in the dK/dV pass one
//     forms P^T and dV, the other dS^T and dK, P^T passing between them
//     through shared memory), the mask is tested only on tiles that
//     straddle its edges, and the dQ pass starts its heaviest query tiles
//     first (section "bf16, wgmma + TMA"; the Hopper pieces are in
//     common/csrc/hopper.cuh).  Training's widths (hd 64, 80, 96, 128) and
//     MLA's 192 take it.
//   * "mma": the other bf16 widths up to 128 (hd 50, say, whose 100-byte
//     rows a TMA map cannot stride, or an unaligned view): mma.sync on 64
//     x 64 tiles staged synchronously (section "bf16, tensor cores").
//   * "cuda_cores": f32 at every width, whose exact products the float32
//     lockstep runs of training need, and bf16 above 192 or unaligned above
//     128: the CUDA cores in f32, bf16 inputs widened when staged.  Each
//     block stages its tiles in shared memory as f32 with a row stride of
//     16 * kC + 1 (odd, so the 16 rows a warp reads fall on 16 banks; the
//     pad columns are zeros), and each of its 256 threads owns a kR x kR
//     block of the score tile and kR rows of the accumulators.  Tiles are
//     64 rows (kR = 4) up to head_dim 128 and 32 rows (kR = 2) above, to
//     fit the four staged tiles in 227 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tc_attention.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Whether key j counts for query row i (position i + shift).
struct Mask {
  int seq_k, shift, causal, window;
  __device__ __forceinline__ bool keep(int i, int j) const {
    const int p = i + shift;
    bool ok = j < seq_k;
    if (causal) ok = ok && j <= p;
    if (window > 0) ok = ok && j > p - window;
    return ok;
  }
};

// Stage n rows (row stride ``stride``, hd live columns) into a kRows x ld
// f32 tile; rows past n and columns past hd become zeros.
template <typename T, int kRows, int ld>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      size_t stride, int n, int hd) {
  constexpr int cols = ld - 1;
  for (int i = threadIdx.x; i < kRows * cols; i += kThreads) {
    const int r = i / cols, d = i - r * cols;
    dst[r * ld + d] = (r < n && d < hd) ? to_f32(src[r * stride + d]) : 0.f;
  }
}

// P and dS of one score entry (0 when masked).  s: q.k; dp: dO.v.
__device__ __forceinline__ void p_ds(float s, float dp, float lse, float dd,
                                     float scale, float softcap, bool ok,
                                     float& p, float& ds) {
  p = 0.f;
  ds = 0.f;
  if (!ok) return;
  float x = s * scale, dcap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    x = t * softcap;
    dcap = 1.f - t * t;
  }
  p = expf(x - lse);
  ds = p * (dp - dd) * dcap * scale;
}

// D[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]; rows in [B, S, H]
// order (one warp a row).
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dot_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ dsum, long long rows, int seq_q, int heads, int hd) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o_r = o + row * hd;
  const T* do_r = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += to_f32(o_r[d]) * to_f32(do_r[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long h = row % heads, bi = row / heads;
    const long long i = bi % seq_q, b = bi / seq_q;
    dsum[(b * heads + h) * seq_q + i] = acc;
  }
}

template <int kR, int kC>
size_t dkdv_smem_bytes() {
  constexpr int kT = 16 * kR, ld = 16 * kC + 1;
  return sizeof(float) * (4 * kT * ld + 2 * kT * (kT + 1) + 2 * kT);
}

template <int kR, int kC>
size_t dq_smem_bytes() {
  constexpr int kT = 16 * kR, ld = 16 * kC + 1;
  return sizeof(float) * (4 * kT * ld + kT * (kT + 1) + 2 * kT);
}

template <typename T, int kR, int kC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    T* __restrict__ dk, T* __restrict__ dv, int seq_q, int seq_k, int heads,
    int kv_heads, int hd, float scale, int causal, int window,
    float softcap) {
  constexpr int kT = 16 * kR, ld = 16 * kC + 1, ldp = kT + 1;
  const int k0 = blockIdx.x * kT;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = heads / kv_heads;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                  // [kT][ld] keys of this block
  float* v_s = k_s + kT * ld;         // [kT][ld]
  float* q_s = v_s + kT * ld;         // [kT][ld] a query tile
  float* do_s = q_s + kT * ld;        // [kT][ld] its dO rows
  float* p_s = do_s + kT * ld;        // [kT keys][ldp] P^T
  float* ds_s = p_s + kT * ldp;       // [kT keys][ldp] dS^T
  float* lse_s = ds_s + kT * ldp;     // [kT]
  float* d_s = lse_s + kT;            // [kT]

  const int nk = min(kT, seq_k - k0);
  const size_t q_row = size_t(heads) * hd, kv_row = size_t(kv_heads) * hd;
  const size_t kv_off = (size_t(b) * seq_k + k0) * kv_row + size_t(kvh) * hd;
  stage<T, kT, ld>(k_s, k + kv_off, kv_row, nk, hd);
  stage<T, kT, ld>(v_s, v + kv_off, kv_row, nk, hd);

  // the query rows whose mask can reach a key of this tile
  const Mask mask{seq_k, seq_k - seq_q, causal, window};
  const int k_last = k0 + nk - 1;
  int i_begin = 0, i_end = seq_q;
  if (causal) i_begin = max(0, k0 - mask.shift);
  if (window > 0) i_end = min(seq_q, k_last + window - mask.shift);
  i_begin = (i_begin / kT) * kT;

  float dk_acc[kR][kC], dv_acc[kR][kC];
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int c = 0; c < kC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const size_t qh_off = size_t(b) * seq_q * q_row + size_t(h) * hd;
    const float* lse_h = lse + (size_t(b) * heads + h) * seq_q;
    const float* d_h = dsum + (size_t(b) * heads + h) * seq_q;
    for (int i0 = i_begin; i0 < i_end; i0 += kT) {
      const int nq = min(kT, seq_q - i0);
      __syncthreads();  // the previous tile's q_s / do_s / p_s are consumed
      stage<T, kT, ld>(q_s, q + qh_off + size_t(i0) * q_row, q_row, nq, hd);
      stage<T, kT, ld>(do_s, dout + qh_off + size_t(i0) * q_row, q_row, nq,
                       hd);
      for (int r = tid; r < kT; r += kThreads) {
        lse_s[r] = r < nq ? lse_h[i0 + r] : 0.f;
        d_s[r] = r < nq ? d_h[i0 + r] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this thread's kR keys x kR rows
      float s[kR][kR], dp[kR][kR];
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int bb = 0; bb < kR; ++bb) s[a][bb] = dp[a][bb] = 0.f;
      const float* kr = k_s + ty * ld;
      const float* vr = v_s + ty * ld;
      const float* qr = q_s + tx * ld;
      const float* dor = do_s + tx * ld;
      for (int d = 0; d < hd; ++d) {
        float ka[kR], va[kR], qb[kR], db[kR];
#pragma unroll
        for (int a = 0; a < kR; ++a) {
          ka[a] = kr[16 * a * ld + d];
          va[a] = vr[16 * a * ld + d];
          qb[a] = qr[16 * a * ld + d];
          db[a] = dor[16 * a * ld + d];
        }
#pragma unroll
        for (int a = 0; a < kR; ++a)
#pragma unroll
          for (int bb = 0; bb < kR; ++bb) {
            s[a][bb] = fmaf(ka[a], qb[bb], s[a][bb]);
            dp[a][bb] = fmaf(va[a], db[bb], dp[a][bb]);
          }
      }
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int bb = 0; bb < kR; ++bb) {
          const int key = ty + 16 * a, il = tx + 16 * bb;
          const bool ok = il < nq && key < nk && mask.keep(i0 + il, k0 + key);
          float p, ds;
          p_ds(s[a][bb], dp[a][bb], lse_s[il], d_s[il], scale, softcap, ok,
               p, ds);
          p_s[key * ldp + il] = p;
          ds_s[key * ldp + il] = ds;
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's rows
      for (int il = 0; il < kT; ++il) {
        float pa[kR], dsa[kR];
#pragma unroll
        for (int a = 0; a < kR; ++a) {
          pa[a] = p_s[(ty + 16 * a) * ldp + il];
          dsa[a] = ds_s[(ty + 16 * a) * ldp + il];
        }
        const float* do_r = do_s + il * ld + tx;
        const float* q_r = q_s + il * ld + tx;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float dov = do_r[16 * c], qv = q_r[16 * c];
#pragma unroll
          for (int a = 0; a < kR; ++a) {
            dv_acc[a][c] = fmaf(pa[a], dov, dv_acc[a][c]);
            dk_acc[a][c] = fmaf(dsa[a], qv, dk_acc[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int key = ty + 16 * a;
    if (key >= nk) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) {
        dk[kv_off + size_t(key) * kv_row + d] = from_f32<T>(dk_acc[a][c]);
        dv[kv_off + size_t(key) * kv_row + d] = from_f32<T>(dv_acc[a][c]);
      }
    }
  }
}

template <typename T, int kR, int kC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    T* __restrict__ dq, int seq_q, int seq_k, int heads, int kv_heads,
    int hd, float scale, int causal, int window, float softcap) {
  constexpr int kT = 16 * kR, ld = 16 * kC + 1, ldp = kT + 1;
  const int i0 = blockIdx.x * kT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // [kT][ld] this block's query rows
  float* do_s = q_s + kT * ld;        // [kT][ld]
  float* k_s = do_s + kT * ld;        // [kT][ld] a key tile
  float* v_s = k_s + kT * ld;         // [kT][ld]
  float* ds_s = v_s + kT * ld;        // [kT rows][ldp] dS
  float* lse_s = ds_s + kT * ldp;     // [kT]
  float* d_s = lse_s + kT;            // [kT]

  const int nq = min(kT, seq_q - i0);
  const size_t q_row = size_t(heads) * hd, kv_row = size_t(kv_heads) * hd;
  const size_t q_off = (size_t(b) * seq_q + i0) * q_row + size_t(h) * hd;
  const size_t kv_base = size_t(b) * seq_k * kv_row + size_t(kvh) * hd;
  stage<T, kT, ld>(q_s, q + q_off, q_row, nq, hd);
  stage<T, kT, ld>(do_s, dout + q_off, q_row, nq, hd);
  const size_t stat_off = (size_t(b) * heads + h) * seq_q + i0;
  for (int r = tid; r < kT; r += kThreads) {
    lse_s[r] = r < nq ? lse[stat_off + r] : 0.f;
    d_s[r] = r < nq ? dsum[stat_off + r] : 0.f;
  }

  // the key tiles the mask lets this block's rows reach (as the forward)
  const Mask mask{seq_k, seq_k - seq_q, causal, window};
  const int pos_first = i0 + mask.shift, pos_last = i0 + nq - 1 + mask.shift;
  int k_end = seq_k;
  if (causal) k_end = min(k_end, pos_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, pos_first - window + 1);
  k_begin = (k_begin / kT) * kT;

  float acc[kR][kC];
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[a][c] = 0.f;

  for (int j0 = k_begin; j0 < k_end; j0 += kT) {
    const int nk = min(kT, seq_k - j0);
    __syncthreads();  // the previous tile's k_s / v_s / ds_s are consumed
    stage<T, kT, ld>(k_s, k + kv_base + size_t(j0) * kv_row, kv_row, nk, hd);
    stage<T, kT, ld>(v_s, v + kv_base + size_t(j0) * kv_row, kv_row, nk, hd);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this thread's kR rows x kR keys
    float s[kR][kR], dp[kR][kR];
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int bb = 0; bb < kR; ++bb) s[a][bb] = dp[a][bb] = 0.f;
    const float* qr = q_s + ty * ld;
    const float* dor = do_s + ty * ld;
    const float* kr = k_s + tx * ld;
    const float* vr = v_s + tx * ld;
    for (int d = 0; d < hd; ++d) {
      float qa[kR], da[kR], kb[kR], vb[kR];
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        qa[a] = qr[16 * a * ld + d];
        da[a] = dor[16 * a * ld + d];
        kb[a] = kr[16 * a * ld + d];
        vb[a] = vr[16 * a * ld + d];
      }
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int bb = 0; bb < kR; ++bb) {
          s[a][bb] = fmaf(qa[a], kb[bb], s[a][bb]);
          dp[a][bb] = fmaf(da[a], vb[bb], dp[a][bb]);
        }
    }
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int bb = 0; bb < kR; ++bb) {
        const int il = ty + 16 * a, key = tx + 16 * bb;
        const bool ok = il < nq && key < nk && mask.keep(i0 + il, j0 + key);
        float p, ds;
        p_ds(s[a][bb], dp[a][bb], lse_s[il], d_s[il], scale, softcap, ok, p,
             ds);
        ds_s[il * ldp + key] = ds;
      }
    __syncthreads();

    // dQ += dS K over the tile's keys
    for (int jl = 0; jl < kT; ++jl) {
      float dsa[kR];
#pragma unroll
      for (int a = 0; a < kR; ++a) dsa[a] = ds_s[(ty + 16 * a) * ldp + jl];
      const float* k_r = k_s + jl * ld + tx;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float kv = k_r[16 * c];
#pragma unroll
        for (int a = 0; a < kR; ++a) acc[a][c] = fmaf(dsa[a], kv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int r = ty + 16 * a;
    if (r >= nq) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) dq[q_off + size_t(r) * q_row + d] = from_f32<T>(acc[a][c]);
    }
  }
}

// ------------------------------------------------------ bf16, tensor cores
// The same two passes for the bf16 inputs up to head_dim 128 that a TMA
// map cannot take (hd not a multiple of 8, or unaligned), on mma.sync
// (common/csrc/tc_attention.cuh's fragments, as the forward): 4 warps a
// block, each owning 16 rows of its 64-row tile (keys in the dK/dV pass,
// query rows in the dQ pass); tiles staged as bf16 with a row stride of
// kD + 8 and the head_dim zero-padded to kD.  The score products leave
// P and dS in f32 accumulator fragments, which become the A operands of
// dV += P^T dO, dK += dS^T Q and dQ += dS K in registers, as the forward
// feeds P to PV; the other operand is read with ldmatrix (.trans where
// its rows are the contraction).  Staging is plain 16-byte loads, one
// tile at a time.

// Stage n rows (row stride ``stride``, hd live columns) into a 64-row
// bf16 tile of row stride ld; rows past n become zeros (the pad columns
// hd..kD-1 are zeroed once by the caller).  vec: 16-byte loads.
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t stride, int n, int hd,
                                           int ld, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const int chunks = hd / 8;
    for (int i = tid; i < tc::kTileQ * chunks; i += tc::kThreads) {
      const int r = i / chunks, c = i - r * chunks;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < n)
        val = *reinterpret_cast<const uint4*>(src + r * stride + 8 * c);
      *reinterpret_cast<uint4*>(dst + r * ld + 8 * c) = val;
    }
  } else {
    for (int i = tid; i < tc::kTileQ * hd; i += tc::kThreads) {
      const int r = i / hd, d = i - r * hd;
      dst[r * ld + d] = r < n ? src[r * stride + d] : __float2bfloat16(0.f);
    }
  }
}

template <int kD>
size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * 4 * tc::kTileQ * (kD + 8)
         + sizeof(float) * 2 * tc::kTileQ;
}

// Zero the pad columns hd..kD-1 of the block's four consecutive tiles.
template <int kD>
__device__ __forceinline__ void zero_pads(__nv_bfloat16* tiles, int hd) {
  constexpr int ld = kD + 8;
  for (int i = threadIdx.x; i < 4 * tc::kTileQ * (kD - hd);
       i += tc::kThreads) {
    const int r = i / (kD - hd), d = hd + i - r * (kD - hd);
    tiles[r * ld + d] = __float2bfloat16(0.f);
  }
}

// s += A B^T and dp += A2 B2^T over kD columns for one warp: A, A2 the
// warp's 16 rows of a and a2, B, B2 the 64 rows of b and b2 (all [.][ld]).
template <int kD>
__device__ __forceinline__ void score_pair(float (&s)[tc::kTileK / 8][4],
                                           float (&dp)[tc::kTileK / 8][4],
                                           const __nv_bfloat16* a,
                                           const __nv_bfloat16* b,
                                           const __nv_bfloat16* a2,
                                           const __nv_bfloat16* b2) {
  constexpr int ld = kD + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < tc::kTileK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    uint32_t fa[4], fa2[4];
    const int a_off = (lane & 15) * ld + ks * 16 + (lane >> 4) * 8;
    tc::ldmatrix_x4(fa, a + a_off);
    tc::ldmatrix_x4(fa2, a2 + a_off);
#pragma unroll
    for (int n2 = 0; n2 < tc::kTileK / 16; ++n2) {
      const int b_off = (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                        ks * 16 + ((lane >> 3) & 1) * 8;
      uint32_t fb[4];
      tc::ldmatrix_x4(fb, b + b_off);
      tc::mma_bf16(s[2 * n2], fa, fb[0], fb[1]);
      tc::mma_bf16(s[2 * n2 + 1], fa, fb[2], fb[3]);
      tc::ldmatrix_x4(fb, b2 + b_off);
      tc::mma_bf16(dp[2 * n2], fa2, fb[0], fb[1]);
      tc::mma_bf16(dp[2 * n2 + 1], fa2, fb[2], fb[3]);
    }
  }
}

// acc += X M over the tile's 64 rows of m ([64][ld], the contraction):
// X the warp's 16 x 64 fragments in f32 (a score-shaped accumulator).
template <int kD>
__device__ __forceinline__ void accumulate(float (&acc)[kD / 8][4],
                                           const float (&x)[tc::kTileK / 8][4],
                                           const __nv_bfloat16* m) {
  constexpr int ld = kD + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < tc::kTileK / 16; ++j) {
    uint32_t a[4];
    a[0] = tc::pack_bf16(x[2 * j][0], x[2 * j][1]);
    a[1] = tc::pack_bf16(x[2 * j][2], x[2 * j][3]);
    a[2] = tc::pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
    a[3] = tc::pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
    const __nv_bfloat16* m_j =
        m + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
        (lane >> 4) * 8;
#pragma unroll
    for (int n2 = 0; n2 < kD / 16; ++n2) {
      uint32_t b[4];
      tc::ldmatrix_x4_trans(b, m_j + n2 * 16);
      tc::mma_bf16(acc[2 * n2], a, b[0], b[1]);
      tc::mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(tc::kThreads) flash_bwd_dkdv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int seq_q, int seq_k, int heads,
    int kv_heads, int hd, float scale, int causal, int window, float softcap,
    int vec) {
  constexpr int ld = kD + 8, kT = tc::kTileQ;
  const int k0 = blockIdx.x * kT;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = heads / kv_heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int row_w = warp * 16, g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kT * ld;
  __nv_bfloat16* q_s = v_s + kT * ld;
  __nv_bfloat16* do_s = q_s + kT * ld;
  float* lse_s = reinterpret_cast<float*>(do_s + kT * ld);
  float* d_s = lse_s + kT;
  zero_pads<kD>(k_s, hd);

  const int nk = min(kT, seq_k - k0);
  const size_t q_row = size_t(heads) * hd, kv_row = size_t(kv_heads) * hd;
  const size_t kv_off = (size_t(b) * seq_k + k0) * kv_row + size_t(kvh) * hd;
  stage_bf16(k_s, k + kv_off, kv_row, nk, hd, ld, vec);
  stage_bf16(v_s, v + kv_off, kv_row, nk, hd, ld, vec);

  const Mask mask{seq_k, seq_k - seq_q, causal, window};
  const int k_last = k0 + nk - 1;
  int i_begin = 0, i_end = seq_q;
  if (causal) i_begin = max(0, k0 - mask.shift);
  if (window > 0) i_end = min(seq_q, k_last + window - mask.shift);
  i_begin = (i_begin / kT) * kT;

  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const size_t qh_off = size_t(b) * seq_q * q_row + size_t(h) * hd;
    const float* lse_h = lse + (size_t(b) * heads + h) * seq_q;
    const float* d_h = dsum + (size_t(b) * heads + h) * seq_q;
    for (int i0 = i_begin; i0 < i_end; i0 += kT) {
      const int nq = min(kT, seq_q - i0);
      __syncthreads();  // the previous tile's q_s / do_s are consumed
      stage_bf16(q_s, q + qh_off + size_t(i0) * q_row, q_row, nq, hd, ld,
                 vec);
      stage_bf16(do_s, dout + qh_off + size_t(i0) * q_row, q_row, nq, hd,
                 ld, vec);
      for (int r = threadIdx.x; r < kT; r += tc::kThreads) {
        lse_s[r] = r < nq ? lse_h[i0 + r] : 0.f;
        d_s[r] = r < nq ? d_h[i0 + r] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T, dP^T = V dO^T: the warp's 16 keys x 64 rows
      float s[tc::kTileK / 8][4], dp[tc::kTileK / 8][4];
      score_pair<kD>(s, dp, k_s + row_w * ld, q_s, v_s + row_w * ld, do_s);
#pragma unroll
      for (int n = 0; n < tc::kTileK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = row_w + g + 8 * (e >> 1);
          const int il = n * 8 + 2 * t + (e & 1);
          const bool ok =
              il < nq && key < nk && mask.keep(i0 + il, k0 + key);
          float p, ds;
          p_ds(s[n][e], dp[n][e], lse_s[il], d_s[il], scale, softcap, ok, p,
               ds);
          s[n][e] = p;
          dp[n][e] = ds;
        }
      accumulate<kD>(dv_acc, s, do_s);   // dV += P^T dO
      accumulate<kD>(dk_acc, dp, q_s);   // dK += dS^T Q
    }
  }

#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = row_w + g + 8 * (e >> 1);
      const int d = n * 8 + 2 * t + (e & 1);
      if (key < nk && d < hd) {
        const size_t off = kv_off + size_t(key) * kv_row + d;
        dk[off] = __float2bfloat16(dk_acc[n][e]);
        dv[off] = __float2bfloat16(dv_acc[n][e]);
      }
    }
}

template <int kD>
__global__ void __launch_bounds__(tc::kThreads) flash_bwd_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq,
    int seq_q, int seq_k, int heads, int kv_heads, int hd, float scale,
    int causal, int window, float softcap, int vec) {
  constexpr int ld = kD + 8, kT = tc::kTileQ;
  const int i0 = blockIdx.x * kT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int row_w = warp * 16, g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + kT * ld;
  __nv_bfloat16* k_s = do_s + kT * ld;
  __nv_bfloat16* v_s = k_s + kT * ld;
  float* lse_s = reinterpret_cast<float*>(v_s + kT * ld);
  float* d_s = lse_s + kT;
  zero_pads<kD>(q_s, hd);

  const int nq = min(kT, seq_q - i0);
  const size_t q_row = size_t(heads) * hd, kv_row = size_t(kv_heads) * hd;
  const size_t q_off = (size_t(b) * seq_q + i0) * q_row + size_t(h) * hd;
  const size_t kv_base = size_t(b) * seq_k * kv_row + size_t(kvh) * hd;
  stage_bf16(q_s, q + q_off, q_row, nq, hd, ld, vec);
  stage_bf16(do_s, dout + q_off, q_row, nq, hd, ld, vec);
  const size_t stat_off = (size_t(b) * heads + h) * seq_q + i0;
  for (int r = threadIdx.x; r < kT; r += tc::kThreads) {
    lse_s[r] = r < nq ? lse[stat_off + r] : 0.f;
    d_s[r] = r < nq ? dsum[stat_off + r] : 0.f;
  }

  const Mask mask{seq_k, seq_k - seq_q, causal, window};
  const int pos_first = i0 + mask.shift, pos_last = i0 + nq - 1 + mask.shift;
  int k_end = seq_k;
  if (causal) k_end = min(k_end, pos_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, pos_first - window + 1);
  k_begin = (k_begin / kT) * kT;

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j0 = k_begin; j0 < k_end; j0 += kT) {
    const int nk = min(kT, seq_k - j0);
    __syncthreads();  // the previous tile's k_s / v_s are consumed
    stage_bf16(k_s, k + kv_base + size_t(j0) * kv_row, kv_row, nk, hd, ld,
               vec);
    stage_bf16(v_s, v + kv_base + size_t(j0) * kv_row, kv_row, nk, hd, ld,
               vec);
    __syncthreads();

    // S = Q K^T, dP = dO V^T: the warp's 16 rows x 64 keys
    float s[tc::kTileK / 8][4], dp[tc::kTileK / 8][4];
    score_pair<kD>(s, dp, q_s + row_w * ld, k_s, do_s + row_w * ld, v_s);
#pragma unroll
    for (int n = 0; n < tc::kTileK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = row_w + g + 8 * (e >> 1);
        const int key = n * 8 + 2 * t + (e & 1);
        const bool ok = il < nq && key < nk && mask.keep(i0 + il, j0 + key);
        float p, ds;
        p_ds(s[n][e], dp[n][e], lse_s[il], d_s[il], scale, softcap, ok, p,
             ds);
        dp[n][e] = ds;
      }
    accumulate<kD>(acc, dp, k_s);   // dQ += dS K
  }

#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row_w + g + 8 * (e >> 1);
      const int d = n * 8 + 2 * t + (e & 1);
      if (r < nq && d < hd)
        dq[q_off + size_t(r) * q_row + d] = __float2bfloat16(acc[n][e]);
    }
}

template <int kD>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* dsum,
                      void* dq, void* dk, void* dv, int batch, int seq_q,
                      int seq_k, int heads, int kv_heads, int hd, float scale,
                      int causal, int window, float softcap,
                      cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_tc_kernel<kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<kD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const int vec = hd % 8 == 0 &&
                  (reinterpret_cast<uintptr_t>(q) |
                   reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v) |
                   reinterpret_cast<uintptr_t>(dout)) % 16 == 0;
  const auto* qt = static_cast<const __nv_bfloat16*>(q);
  const auto* kt = static_cast<const __nv_bfloat16*>(k);
  const auto* vt = static_cast<const __nv_bfloat16*>(v);
  const auto* dot = static_cast<const __nv_bfloat16*>(dout);
  const int kT = tc::kTileQ;
  const dim3 grid_kv((seq_k + kT - 1) / kT, kv_heads, batch);
  flash_bwd_dkdv_tc_kernel<kD><<<grid_kv, tc::kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), seq_q, seq_k, heads, kv_heads, hd,
      scale, causal, window, softcap, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((seq_q + kT - 1) / kT, heads, batch);
  flash_bwd_dq_tc_kernel<kD><<<grid_q, tc::kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<__nv_bfloat16*>(dq), seq_q,
      seq_k, heads, kv_heads, hd, scale, causal, window, softcap, vec);
  return cudaGetLastError();
}

// ------------------------------------------------------ bf16, wgmma + TMA
// The two passes for bf16 with hd a multiple of 8 up to 192 and 16-byte
// aligned inputs (what a TMA map takes), warp-specialised: 3 warpgroups a
// block, one block an SM.  Warpgroup 2 produces: one of its threads loads
// the block's resident tile pair once, then keeps a ring of 2 to 4 stages
// (Rings) of the streamed pair in flight by TMA, each behind a "full"
// mbarrier that the consumers wait on and an "empty" one they release.
// Warpgroups 0 and 1 consume on wgmma, each holding one f32 accumulator:
//   dK/dV, one block per 64 keys: the resident pair is the keys' K and V,
//     the streamed one a 64-row tile of Q and dO with the rows' lse and D
//     (cp.async copies by the producer's first warp, which arrive on the
//     stage's barrier as they land).  Keys are the M dimension.
//     Warpgroup 0 forms S^T = K Q^T, P^T and dV += P^T dO; it hands
//     P^T dcap (bf16, each thread its own fragment) to warpgroup 1
//     through shared memory behind a "p" mbarrier.  Warpgroup 1 forms
//     dP^T = V dO^T, dS^T = P^T dcap (dP^T - D) and dK += dS^T Q.  S^T and
//     dP^T read both operands K-major from shared memory; P^T and dS^T are
//     register A operands of the gradient products, which read dO and Q
//     MN-major: 4 products of 2 hd operations per kept pair.
//   dQ, one block per 128 query rows (64 a consumer): the resident pair is
//     the rows' Q and dO, the streamed one a 64-key tile of K and V; each
//     consumer forms S = Q K^T, dP = dO V^T, dS and dQ += dS K (K
//     MN-major).  Its query tiles launch heaviest first.
// Splitting dK/dV by role keeps each consumer within 168 registers with
// no spill up to hd 128: ptxas compiles the block's 384 threads at 168 a
// thread whatever setmaxnreg asks (so the kernel does not use it), and
// one warpgroup holding both 64 x hd accumulators and the two score tiles
// spills from hd 80 on.  A consumer skips a tile that the mask
// hides from all its rows (it still waits for and releases the stage) and
// tests the mask element by element only on tiles that straddle the
// causal diagonal, the window's edge or the last key.  Rows past S load as
// zeros: in the dQ pass they get lse = +inf (P = 0); in the dK/dV pass
// lse = D = 0, so P = 1 meets a zero dO row and dS = 1 (0 - 0) = 0 meets
// a zero Q row, and they add exactly 0.  No atomics:
// every sum runs in one fixed order, so the bits repeat.
namespace wg {

constexpr int kRows = 64;                  // rows of a box and of a consumer
constexpr int kBox = kRows * 16;           // bf16 elements of a 64-row box
constexpr int kConsumers = 2;              // warpgroups 0, 1; then the producer
constexpr int kThreads = 128 * (kConsumers + 1);
using tc::kLog2e;

struct Params {
  const float* lse;
  const float* dsum;
  __nv_bfloat16* out0;  // dk (dK/dV pass) or dq
  __nv_bfloat16* out1;  // dv
  int seq_q, seq_k, heads, kv_heads, hd, causal, window;
  float scale, softcap;
  __device__ __forceinline__ bool keep(int i, int j) const {
    return Mask{seq_k, seq_k - seq_q, causal, window}.keep(i, j);
  }
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Zero boxes [live, chunks) of ``n`` consecutive tiles of ``chunks`` boxes
// of kBox elements: the columns past the last 16-column box TMA writes.
__device__ __forceinline__ void zero_dead(__nv_bfloat16* tiles, int n,
                                          int live, int chunks) {
  for (int t = 0; t < n; ++t) {
    uint4* p = reinterpret_cast<uint4*>(tiles + (t * chunks + live) * kBox);
    for (int i = threadIdx.x; i < (chunks - live) * kBox / 8; i += kThreads)
      p[i] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The live 16-column boxes of one head's rows [row0, row0 + 64 * halves)
// into ``dst`` (a tile of 64 * halves rows), completing on ``bar``.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int live,
                                          int halves, int head, int row0,
                                          int b) {
  for (int c = 0; c < live; ++c)
    for (int r = 0; r < halves; ++r)
      hopper::tma_load_4d(dst + (c * halves + r) * kBox, map, bar, 16 * c,
                          head, row0 + kRows * r, b);
}

// acc = A B^T over kD columns: A 64 rows of a tile whose boxes are
// ``a_box`` elements apart, B a 64-row tile.
template <int kD>
__device__ __forceinline__ void score(float (&acc)[32],
                                      const __nv_bfloat16* a, int a_box,
                                      const __nv_bfloat16* b) {
  const uint32_t da = hopper::desc_lo(a, 16), db = hopper::desc_lo(b, 16);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    hopper::mma_ss_n64(acc, da + kk * a_box / 8, db + kk * kBox / 8, kk > 0);
}

// acc += X M: X the 64 x 64 operand as A fragments (4 k-steps), M a
// 64-row tile ([64 rows][kD]) read MN-major.
template <int kD>
__device__ __forceinline__ void grad(float (&acc)[kD / 2],
                                     const uint32_t (&x)[4][4],
                                     const __nv_bfloat16* m) {
  const uint32_t dm = hopper::desc_lo(m, kBox * 2);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hopper::Rs<kD>::mma(acc, x[kk], dm + kk * 32);
}

// Elements 2r, 2r + 1 of k-step kk of a 64 x 64 accumulator, in bf16: its
// A fragment for the next product.
__device__ __forceinline__ uint32_t frag(const float (&x)[32], int kk,
                                         int r) {
  return tc::pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// Accumulator element n of a thread (lane = 4 g + q of warp w): row
// 16 w + g + 8 (n % 4 / 2), column 8 (n / 4) + 2 q + n % 2 of the tile.
__device__ __forceinline__ int acc_row(int n) {
  return (threadIdx.x % 128) / 32 * 16 + (threadIdx.x % 32) / 4 +
         8 * ((n & 3) >> 1);
}
__device__ __forceinline__ int acc_col(int n) {
  return 8 * (n >> 2) + 2 * (threadIdx.x % 4) + (n & 1);
}

// P of one score (s = q.k), from the query's lse * log2(e); with softcap
// also its derivative dcap = 1 - tanh^2.
template <bool kCap>
__device__ __forceinline__ float prob(float s, float lse2, const Params& p,
                                      float& dcap) {
  if (kCap) {
    const float t = tanhf(s * p.scale / p.softcap);
    dcap = 1.f - t * t;
    return tc::exp2_approx(t * p.softcap * kLog2e - lse2);
  }
  dcap = 1.f;
  return tc::exp2_approx(fmaf(s, p.scale * kLog2e, -lse2));
}

// Stages of the rings: as many as fit 227 KB beside the resident tiles, up
// to 4 (a refill waits for the consumers' release, then for TMA).
template <int kD>
struct Rings {
  static constexpr int kv = kD <= 128 ? 4 : 3;  // the dK/dV pass's stages
  static constexpr int q = kD <= 128 ? 4 : 2;   // the dQ pass's
};

template <int kD>
size_t dkdv_smem() {
  const size_t stage = size_t(2) * (kD / 16) * kBox * 2 + 9216;
  return 1024 + size_t(2) * (kD / 16) * kBox * 2 + Rings<kD>::kv * stage +
         64;
}

template <int kD>
size_t dq_smem() {
  const size_t tiles = size_t(2) * (kD / 16) * kBox * 2;
  return 1024 + 2 * tiles + Rings<kD>::q * tiles + 64;
}

// What a dK/dV consumer needs of the block.
struct KvBlock {
  const __nv_bfloat16* k;   // resident K, V: kD / 16 boxes of 64 keys
  const __nv_bfloat16* v;
  uint8_t* ring;            // stages: Q, dO, lse2 | D, P^T dcap
  int stage_bytes;
  uint64_t *full, *empty, *pfull, *res;
  int k0, i_begin, n_tiles, total, b, kvh;
};

// Stage ``stage``'s tiles: Q, dO (kD / 16 boxes each), then 64 lse * log2e
// and 64 D, then the P^T dcap fragments (16 words a consumer thread).
template <int kD>
struct Stage {
  const __nv_bfloat16* q;
  const __nv_bfloat16* dout;
  const float* stats;
  uint4* px;
  __device__ __forceinline__ Stage(const KvBlock& kb, int stage) {
    uint8_t* base = kb.ring + stage * kb.stage_bytes;
    q = reinterpret_cast<const __nv_bfloat16*>(base);
    dout = q + (kD / 16) * kBox;
    stats = reinterpret_cast<const float*>(dout + (kD / 16) * kBox);
    px = reinterpret_cast<uint4*>(base + 2 * (kD / 16) * kBox * 2 + 1024);
  }
};

// Whether the mask hides the block's 64 keys from every row of the query
// tile at i0 (skip), or from some of its pairs (masked).
__device__ __forceinline__ void tile_mask(const Params& p, int k0, int i0,
                                          bool& skip, bool& masked) {
  const int shift = p.seq_k - p.seq_q;
  const int i_hi = min(i0 + kRows, p.seq_q) - 1;
  skip = (p.causal && k0 > i_hi + shift) ||
         (p.window > 0 && k0 + kRows - 1 <= i0 + shift - p.window);
  masked = k0 + kRows > p.seq_k || (p.causal && k0 + kRows - 1 > i0 + shift) ||
           (p.window > 0 && k0 <= i_hi + shift - p.window);
}

// A consumer's 64 x kD accumulator times ``scale`` into rows
// [row0, row0 + 64) of ``out`` (row ``r`` at base + r * stride), rows
// below ``rows`` and columns below hd only; two columns a 4-byte store.
template <int kD>
__device__ __forceinline__ void store_tile(__nv_bfloat16* out,
                                           const float (&acc)[kD / 2],
                                           float scale, size_t base,
                                           size_t stride, int row0, int rows,
                                           int hd) {
#pragma unroll
  for (int n = 0; n < kD / 2; n += 2) {
    const int r = row0 + acc_row(n), d = acc_col(n);
    if (r < rows && d < hd)
      *reinterpret_cast<uint32_t*>(out + base + size_t(r) * stride + d) =
          tc::pack_bf16(acc[n] * scale, acc[n + 1] * scale);
  }
}

// Warpgroup 0 of the dK/dV pass: S^T, P^T and dV; P^T dcap to warpgroup 1.
template <int kD, bool kCap>
__device__ __forceinline__ void dv_consumer(const Params& p,
                                            const KvBlock& kb) {
  float dv[kD / 2];
#pragma unroll
  for (int n = 0; n < kD / 2; ++n) dv[n] = 0.f;
  hopper::mbar_wait(kb.res, 0);
  int stage = 0, phase = 0;
  for (int it = 0; it < kb.total; ++it) {
    const int i0 = kb.i_begin + (it % kb.n_tiles) * kRows;
    hopper::mbar_wait(&kb.full[stage], phase);
    const Stage<kD> st(kb, stage);
    bool skip, masked;
    tile_mask(p, kb.k0, i0, skip, masked);
    if (!skip) {
      float s[32];
      hopper::wgmma_fence();
      score<kD>(s, kb.k, kBox, st.q);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      uint32_t xf[4][4];  // P^T dcap, for warpgroup 1 (with softcap)
#pragma unroll
      for (int n = 0; n < 32; n += 2) {
        float dc0, dc1;
        float p0 = prob<kCap>(s[n], st.stats[acc_col(n)] * kLog2e, p, dc0);
        float p1 =
            prob<kCap>(s[n + 1], st.stats[acc_col(n + 1)] * kLog2e, p, dc1);
        if (masked) {
          const int key = kb.k0 + acc_row(n);
          if (!p.keep(i0 + acc_col(n), key)) p0 = 0.f;
          if (!p.keep(i0 + acc_col(n + 1), key)) p1 = 0.f;
        }
        s[n] = p0;
        s[n + 1] = p1;
        if (kCap)
          xf[n >> 3][(n & 7) >> 1] = tc::pack_bf16(p0 * dc0, p1 * dc1);
      }
      uint32_t pf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pf[kk][r] = frag(s, kk, r);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t(&w)[4] = kCap ? xf[kk] : pf[kk];
        st.px[kk * 128 + threadIdx.x % 128] =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
      hopper::mbar_arrive(&kb.pfull[stage]);
      hopper::wgmma_fence();
      grad<kD>(dv, pf, st.dout);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv);
    } else {
      hopper::mbar_arrive(&kb.pfull[stage]);
    }
    hopper::mbar_arrive(&kb.empty[stage]);
    if (++stage == Rings<kD>::kv) { stage = 0; phase ^= 1; }
  }
  const size_t kv_row = size_t(p.kv_heads) * p.hd;
  store_tile<kD>(p.out1, dv, 1.f,
                 size_t(kb.b) * p.seq_k * kv_row + size_t(kb.kvh) * p.hd,
                 kv_row, kb.k0, p.seq_k, p.hd);
}

// Warpgroup 1 of the dK/dV pass: dP^T, dS^T from warpgroup 0's P^T dcap,
// and dK.
template <int kD>
__device__ __forceinline__ void dk_consumer(const Params& p,
                                            const KvBlock& kb) {
  float dk[kD / 2];
#pragma unroll
  for (int n = 0; n < kD / 2; ++n) dk[n] = 0.f;
  hopper::mbar_wait(kb.res, 0);
  int stage = 0, phase = 0;
  for (int it = 0; it < kb.total; ++it) {
    const int i0 = kb.i_begin + (it % kb.n_tiles) * kRows;
    hopper::mbar_wait(&kb.full[stage], phase);
    const Stage<kD> st(kb, stage);
    bool skip, masked;
    tile_mask(p, kb.k0, i0, skip, masked);
    if (!skip) {
      float dp[32];
      hopper::wgmma_fence();
      score<kD>(dp, kb.v, kBox, st.dout);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
      hopper::mbar_wait(&kb.pfull[stage], phase);
      uint32_t dsf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint4 x4 = st.px[kk * 128 + threadIdx.x % 128];
        const uint32_t x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 8 * kk + 2 * r;
          const float x0 = __uint_as_float(x[r] << 16);
          const float x1 = __uint_as_float(x[r] & 0xffff0000u);
          dsf[kk][r] = tc::pack_bf16(
              x0 * (dp[n] - st.stats[kRows + acc_col(n)]),
              x1 * (dp[n + 1] - st.stats[kRows + acc_col(n + 1)]));
        }
      }
      hopper::wgmma_fence();
      grad<kD>(dk, dsf, st.q);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk);
    }
    hopper::mbar_arrive(&kb.empty[stage]);
    if (++stage == Rings<kD>::kv) { stage = 0; phase ^= 1; }
  }
  const size_t kv_row = size_t(p.kv_heads) * p.hd;
  store_tile<kD>(p.out0, dk, p.scale,
                 size_t(kb.b) * p.seq_k * kv_row + size_t(kb.kvh) * p.hd,
                 kv_row, kb.k0, p.seq_k, p.hd);
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_do, const Params p) {
  constexpr int kChunks = kD / 16;
  constexpr int kStages = Rings<kD>::kv;
  constexpr int kStageBytes = 2 * kChunks * kBox * 2 + 9216;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* v_s = k_s + kChunks * kBox;
  uint8_t* ring = reinterpret_cast<uint8_t*>(v_s + kChunks * kBox);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* pfull = empty + kStages;
  uint64_t* res = pfull + kStages;

  const int kvh = blockIdx.x % p.kv_heads, b = blockIdx.x / p.kv_heads;
  const int k0 = blockIdx.y * kRows;
  const int group = p.heads / p.kv_heads, shift = p.seq_k - p.seq_q;
  const int live = (p.hd + 15) / 16;
  // the query tiles the mask lets see a key of this block
  int i_begin = 0, i_end = p.seq_q;
  if (p.causal) i_begin = max(0, k0 - shift);
  if (p.window > 0)
    i_end = min(p.seq_q, min(k0 + kRows, p.seq_k) - 1 + p.window - shift);
  i_begin = (i_begin / kRows) * kRows;
  const int n_tiles =
      i_end > i_begin ? (i_end - i_begin + kRows - 1) / kRows : 0;

  if (live < kChunks) {
    zero_dead(k_s, 2, live, kChunks);  // K and V
    for (int s = 0; s < kStages; ++s)  // Q and dO
      zero_dead(reinterpret_cast<__nv_bfloat16*>(ring + s * kStageBytes), 2,
                live, kChunks);
    hopper::fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], 128 * kConsumers);
      hopper::mbar_init(&pfull[s], 128);
    }
    hopper::mbar_init(res, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const KvBlock kb{k_s,   v_s,     ring,   kStageBytes, full,
                   empty, pfull,   res,    k0,          i_begin,
                   n_tiles, group * n_tiles, b, kvh};
  // the warpgroup's index, warp-uniform as the compiler can see
  const int wg_idx = __shfl_sync(0xffffffffu, int(threadIdx.x) / 128, 0);
  if (wg_idx == kConsumers) {
    // producer: its first warp loads the stages' lse and D rows, its first
    // thread issues the TMA copies
    if (threadIdx.x >= 128 * kConsumers + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      hopper::tma_prefetch(&map_q);
      hopper::tma_prefetch(&map_do);
      hopper::mbar_arrive_expect_tx(res, 2 * live * kBox * 2);
      load_rows(k_s, &map_k, res, live, 1, kvh, k0, b);
      load_rows(v_s, &map_v, res, live, 1, kvh, k0, b);
    }
    int stage = 0, phase = 0;
    for (int it = 0; it < kb.total; ++it) {
      const int h = kvh * group + it / n_tiles;
      const int i0 = i_begin + (it % n_tiles) * kRows;
      hopper::mbar_wait(&empty[stage], phase ^ 1);
      const Stage<kD> st(kb, stage);
      if (lane == 0) {  // the tiles first: their copies overlap the loads
        __nv_bfloat16* q_t = const_cast<__nv_bfloat16*>(st.q);
        hopper::mbar_expect_tx(&full[stage], 2 * live * kBox * 2);
        load_rows(q_t, &map_q, &full[stage], live, 1, h, i0, b);
        load_rows(q_t + kChunks * kBox, &map_do, &full[stage], live, 1, h,
                  i0, b);
      }
      // lse and D of the tile's rows, zeros past S, copied asynchronously
      float* stats = const_cast<float*>(st.stats);
      const size_t row = (size_t(b) * p.heads + h) * p.seq_q;
      for (int r = lane; r < kRows; r += 32) {
        const bool in = i0 + r < p.seq_q;
        const size_t o = row + (in ? i0 + r : 0);
        tc::cp_async4(stats + r, p.lse + o, in);
        tc::cp_async4(stats + kRows + r, p.dsum + o, in);
      }
      hopper::mbar_arrive_cp_async(&full[stage]);
      if (++stage == kStages) { stage = 0; phase ^= 1; }
    }
  } else if (wg_idx == 0) {
    if (p.softcap > 0.f) dv_consumer<kD, true>(p, kb);
    else dv_consumer<kD, false>(p, kb);
  } else {
    dk_consumer<kD>(p, kb);
  }
}

// What a dQ consumer needs of the block.
struct QBlock {
  const __nv_bfloat16* q;   // resident Q, dO: kD / 16 boxes of 128 rows
  const __nv_bfloat16* dout;
  uint8_t* ring;            // stages: K, V
  int stage_bytes;
  uint64_t *full, *empty, *res;
  int i0, k_begin, total, b, h;
};

// A consumer of the dQ pass: rows [iw0, iw0 + 64), dQ += dS K over the
// ring's key tiles.
template <int kD, bool kCap>
__device__ __forceinline__ void dq_consumer(const Params& p, const QBlock& qb,
                                            int ci) {
  constexpr int kChunks = kD / 16;
  const int shift = p.seq_k - p.seq_q;
  const int iw0 = qb.i0 + kRows * ci;
  const int iw_hi = min(iw0 + kRows, p.seq_q) - 1;
  // this thread's two rows: lse * log2(e) (+inf past S) and D
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = iw0 + acc_row(2 * r);
    const size_t o = (size_t(qb.b) * p.heads + qb.h) * p.seq_q + i;
    lse2[r] = i < p.seq_q ? p.lse[o] * kLog2e : __int_as_float(0x7f800000);
    dd[r] = i < p.seq_q ? p.dsum[o] : 0.f;
  }
  float acc[kD / 2];
#pragma unroll
  for (int n = 0; n < kD / 2; ++n) acc[n] = 0.f;
  hopper::mbar_wait(qb.res, 0);

  int stage = 0, phase = 0;
  for (int it = 0; it < qb.total; ++it) {
    const int j0 = qb.k_begin + it * kRows;
    hopper::mbar_wait(&qb.full[stage], phase);
    const __nv_bfloat16* k_t = reinterpret_cast<const __nv_bfloat16*>(
        qb.ring + stage * qb.stage_bytes);
    const __nv_bfloat16* v_t = k_t + kChunks * kBox;
    const bool skip =
        iw0 >= p.seq_q || (p.causal && j0 > iw_hi + shift) ||
        (p.window > 0 && j0 + kRows - 1 <= iw0 + shift - p.window);
    if (!skip) {
      const bool masked =
          j0 + kRows > p.seq_k || (p.causal && j0 + kRows - 1 > iw0 + shift) ||
          (p.window > 0 && j0 <= iw_hi + shift - p.window);
      float s[32], dp[32];
      hopper::wgmma_fence();
      score<kD>(s, qb.q + ci * kBox, 2 * kBox, k_t);
      score<kD>(dp, qb.dout + ci * kBox, 2 * kBox, v_t);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
#pragma unroll
      for (int n = 0; n < 32; ++n) {
        const int r = (n & 3) >> 1;
        float dcap;
        float pv = prob<kCap>(s[n], lse2[r], p, dcap);
        if (masked && !p.keep(iw0 + acc_row(n), j0 + acc_col(n))) pv = 0.f;
        dp[n] = kCap ? pv * (dp[n] - dd[r]) * dcap : pv * (dp[n] - dd[r]);
      }
      uint32_t dsf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) dsf[kk][r] = frag(dp, kk, r);
      hopper::wgmma_fence();
      grad<kD>(acc, dsf, k_t);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
    hopper::mbar_arrive(&qb.empty[stage]);
    if (++stage == Rings<kD>::q) { stage = 0; phase ^= 1; }
  }
  const size_t q_row = size_t(p.heads) * p.hd;
  store_tile<kD>(p.out0, acc, p.scale,
                 size_t(qb.b) * p.seq_q * q_row + size_t(qb.h) * p.hd, q_row,
                 iw0, p.seq_q, p.hd);
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_do, const Params p) {
  constexpr int kChunks = kD / 16;
  constexpr int kStages = Rings<kD>::q;
  constexpr int kStageBytes = 2 * kChunks * kBox * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* do_s = q_s + kChunks * 2 * kBox;
  uint8_t* ring = reinterpret_cast<uint8_t*>(do_s + kChunks * 2 * kBox);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* res = empty + kStages;

  const int h = blockIdx.x % p.heads, b = blockIdx.x / p.heads;
  const int kvh = h / (p.heads / p.kv_heads);
  // heaviest first: under a causal mask the last query tiles see most keys
  const int i0 = (gridDim.y - 1 - blockIdx.y) * 2 * kRows;
  const int shift = p.seq_k - p.seq_q;
  const int live = (p.hd + 15) / 16;
  int k_end = p.seq_k, k_begin = 0;
  if (p.causal) k_end = min(k_end, min(i0 + 2 * kRows, p.seq_q) + shift);
  if (p.window > 0) k_begin = max(0, i0 + shift - p.window + 1);
  k_begin = (k_begin / kRows) * kRows;
  const int total =
      k_end > k_begin ? (k_end - k_begin + kRows - 1) / kRows : 0;

  if (live < kChunks) {
    zero_dead(q_s, 2, 2 * live, 2 * kChunks);  // Q, dO: 2 boxes a chunk
    for (int s = 0; s < kStages; ++s)  // K and V
      zero_dead(reinterpret_cast<__nv_bfloat16*>(ring + s * kStageBytes), 2,
                live, kChunks);
    hopper::fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128 * kConsumers);
    }
    hopper::mbar_init(res, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg_idx = __shfl_sync(0xffffffffu, int(threadIdx.x) / 128, 0);
  if (wg_idx == kConsumers) {
    // producer: one thread issues the TMA copies
    if (threadIdx.x != 128 * kConsumers) return;
    hopper::tma_prefetch(&map_k);
    hopper::tma_prefetch(&map_v);
    hopper::mbar_arrive_expect_tx(res, 2 * live * 2 * kBox * 2);
    load_rows(q_s, &map_q, res, live, 2, h, i0, b);
    load_rows(do_s, &map_do, res, live, 2, h, i0, b);
    int stage = 0, phase = 0;
    for (int it = 0; it < total; ++it) {
      const int j0 = k_begin + it * kRows;
      hopper::mbar_wait(&empty[stage], phase ^ 1);
      __nv_bfloat16* k_t =
          reinterpret_cast<__nv_bfloat16*>(ring + stage * kStageBytes);
      hopper::mbar_arrive_expect_tx(&full[stage], 2 * live * kBox * 2);
      load_rows(k_t, &map_k, &full[stage], live, 1, kvh, j0, b);
      load_rows(k_t + kChunks * kBox, &map_v, &full[stage], live, 1, kvh, j0,
                b);
      if (++stage == kStages) { stage = 0; phase ^= 1; }
    }
  } else {
    const QBlock qb{q_s, do_s, ring,  kStageBytes, full, empty, res,
                    i0,  k_begin, total, b,          h};
    if (p.softcap > 0.f) dq_consumer<kD, true>(p, qb, wg_idx);
    else dq_consumer<kD, false>(p, qb, wg_idx);
  }
}

}  // namespace wg

template <int kD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* dsum, void* dq, void* dk, void* dv,
                         int batch, int seq_q, int seq_k, int heads,
                         int kv_heads, int hd, float scale, int causal,
                         int window, float softcap, cudaStream_t stream) {
  const long long tiles_k = (seq_k + wg::kRows - 1) / wg::kRows;
  const long long tiles_q = (seq_q + 2 * wg::kRows - 1) / (2 * wg::kRows);
  if (tiles_k > 65535 || tiles_q > 65535 ||
      static_cast<long long>(heads) * batch >= (1LL << 31))
    return cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v, map_do;
  cudaError_t err =
      hopper::encode_rows_map(&map_q, q, batch, seq_q, heads, hd, wg::kRows);
  if (err == cudaSuccess)
    err = hopper::encode_rows_map(&map_k, k, batch, seq_k, kv_heads, hd,
                                  wg::kRows);
  if (err == cudaSuccess)
    err = hopper::encode_rows_map(&map_v, v, batch, seq_k, kv_heads, hd,
                                  wg::kRows);
  if (err == cudaSuccess)
    err = hopper::encode_rows_map(&map_do, dout, batch, seq_q, heads, hd,
                                  wg::kRows);
  if (err != cudaSuccess) return err;
  const size_t smem_kv = wg::dkdv_smem<kD>(), smem_q = wg::dq_smem<kD>();
  err = cudaFuncSetAttribute(wg::flash_bwd_dkdv_wgmma_kernel<kD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem_kv));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wg::flash_bwd_dq_wgmma_kernel<kD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem_q));
  if (err != cudaSuccess) return err;
  wg::Params p{lse, dsum, static_cast<__nv_bfloat16*>(dk),
               static_cast<__nv_bfloat16*>(dv), seq_q, seq_k, heads,
               kv_heads, hd, causal, window, scale, softcap};
  wg::flash_bwd_dkdv_wgmma_kernel<kD>
      <<<dim3(kv_heads * batch, unsigned(tiles_k)), wg::kThreads, smem_kv,
         stream>>>(map_q, map_k, map_v, map_do, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  p.out0 = static_cast<__nv_bfloat16*>(dq);
  p.out1 = nullptr;
  wg::flash_bwd_dq_wgmma_kernel<kD>
      <<<dim3(heads * batch, unsigned(tiles_q)), wg::kThreads, smem_q,
         stream>>>(map_q, map_k, map_v, map_do, p);
  return cudaGetLastError();
}

template <typename T, int kR, int kC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dsum,
                   void* dq, void* dk, void* dv, int batch, int seq_q,
                   int seq_k, int heads, int kv_heads, int hd, float scale,
                   int causal, int window, float softcap,
                   cudaStream_t stream) {
  constexpr int kT = 16 * kR;
  const size_t smem_kv = dkdv_smem_bytes<kR, kC>();
  const size_t smem_q = dq_smem_bytes<kR, kC>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, kR, kC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_kv));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, kR, kC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem_q));
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const dim3 grid_kv((seq_k + kT - 1) / kT, kv_heads, batch);
  flash_bwd_dkdv_kernel<T, kR, kC><<<grid_kv, kThreads, smem_kv, stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
      seq_q, seq_k, heads, kv_heads, hd, scale, causal, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((seq_q + kT - 1) / kT, heads, batch);
  flash_bwd_dq_kernel<T, kR, kC><<<grid_q, kThreads, smem_q, stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dq), seq_q, seq_k, heads,
      kv_heads, hd, scale, causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* dsum, void* dq, void* dk, void* dv, int batch,
                     int seq_q, int seq_k, int heads, int kv_heads, int hd,
                     float scale, int causal, int window, float softcap,
                     cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * seq_q * heads;
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  bwd_dot_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), dsum, rows,
      seq_q, heads, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define FA_BWD_LAUNCH(R, C)                                                  \
  return launch<T, R, C>(q, k, v, dout, lse, dsum, dq, dk, dv, batch, seq_q, \
                         seq_k, heads, kv_heads, hd, scale, causal, window,  \
                         softcap, stream)
  if constexpr (sizeof(T) == 2) {
    // the design by shape (kernel_bwd.py::design mirrors it): wgmma where
    // a TMA map can take the rows, else mma.sync up to hd 128, else the
    // CUDA cores
    const bool aligned = (reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(dout)) % 16 == 0;
    if (aligned && hd % 8 == 0 && hd <= 192) {
#define FA_BWD_WG_LAUNCH(D)                                                  \
  return launch_wgmma<D>(q, k, v, dout, lse, dsum, dq, dk, dv, batch, seq_q, \
                         seq_k, heads, kv_heads, hd, scale, causal, window,  \
                         softcap, stream)
      if (hd <= 32) FA_BWD_WG_LAUNCH(32);
      if (hd <= 64) FA_BWD_WG_LAUNCH(64);
      if (hd <= 80) FA_BWD_WG_LAUNCH(80);
      if (hd <= 96) FA_BWD_WG_LAUNCH(96);
      if (hd <= 128) FA_BWD_WG_LAUNCH(128);
      FA_BWD_WG_LAUNCH(192);
#undef FA_BWD_WG_LAUNCH
    }
#define FA_BWD_TC_LAUNCH(D)                                                  \
  return launch_tc<D>(q, k, v, dout, lse, dsum, dq, dk, dv, batch, seq_q,    \
                      seq_k, heads, kv_heads, hd, scale, causal, window,     \
                      softcap, stream)
    if (hd <= 64) FA_BWD_TC_LAUNCH(64);
    if (hd <= 80) FA_BWD_TC_LAUNCH(80);
    if (hd <= 96) FA_BWD_TC_LAUNCH(96);
    if (hd <= 128) FA_BWD_TC_LAUNCH(128);
#undef FA_BWD_TC_LAUNCH
    if (hd <= 192) FA_BWD_LAUNCH(2, 12);
    if (hd <= 256) FA_BWD_LAUNCH(2, 16);
  } else {
    if (hd <= 64) FA_BWD_LAUNCH(4, 4);
    if (hd <= 80) FA_BWD_LAUNCH(4, 5);
    if (hd <= 96) FA_BWD_LAUNCH(4, 6);
    if (hd <= 128) FA_BWD_LAUNCH(4, 8);
    if (hd <= 192) FA_BWD_LAUNCH(2, 12);
    if (hd <= 256) FA_BWD_LAUNCH(2, 16);
  }
#undef FA_BWD_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes shared with kernel_bwd.py: 0 float32, 1 bfloat16.  ``dsum``
// is f32 scratch of [B, H, S] the caller allocates.  softcap <= 0 means
// none; window <= 0 means none.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const float* lse, const void* dout,
                                   float* dsum, void* dq, void* dk, void* dv,
                                   int batch, int seq_q, int seq_k, int heads,
                                   int kv_heads, int hd, float scale,
                                   int causal, int window, float softcap,
                                   int dtype, void* stream_handle) {
  cudaGetLastError();  // start from a clean error state
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (dtype == 0)
    return int(dispatch<float>(q, k, v, o, dout, lse, dsum, dq, dk, dv, batch,
                               seq_q, seq_k, heads, kv_heads, hd, scale,
                               causal, window, softcap, stream));
  if (dtype == 1)
    return int(dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, dsum, dq, dk,
                                       dv, batch, seq_q, seq_k, heads,
                                       kv_heads, hd, scale, causal, window,
                                       softcap, stream));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
