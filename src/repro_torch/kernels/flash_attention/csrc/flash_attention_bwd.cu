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
// Three launches, none with atomics, so the result is deterministic:
//   1. D[b,h,i] = sum_d dO * O, one warp a row;
//   2. dK/dV: one block per (tile of keys, kv head, batch row).  It walks
//      the G query heads of its kv head and the query tiles the mask lets
//      see its keys, recomputes P = exp(score - lse) and
//      dS = P * (dP - D) from K, V, Q and dO, and sums dV += P^T dO and
//      dK += dS^T Q over them in registers (the GQA sum needs no atomics);
//   3. dQ: one block per (tile of query rows, q head, batch row), walking
//      the key tiles its rows can reach, dQ += dS K.
// Two designs, by dtype and width:
//   * bf16 up to head_dim 128 (the training path): the five products run
//     on the tensor cores (mma.sync, common/csrc/tc_attention.cuh), 4
//     warps a block, each owning 16 rows of the block's 64-row tile; the
//     f32 score fragments become P and dS in registers and feed the
//     gradient products as A operands (section "bf16, tensor cores").
//   * f32 (exact products, which the float32 parity runs need) and bf16
//     above head_dim 128 (MLA's 192): the CUDA cores in f32, bf16 inputs
//     widened when staged.  Each block stages its tiles in shared memory
//     as f32 with a row stride of 16 * kC + 1 (odd, so the 16 rows a warp
//     reads fall on 16 banks; the pad columns are zeros), and each of its
//     256 threads owns a kR x kR block of the score tile and kR rows of
//     the accumulators.  Tiles are 64 rows (kR = 4) up to head_dim 128 and
//     32 rows (kR = 2) above, to fit the four staged tiles in 227 KB.
//
// What bounds it on an H100: five products of 2 * hd operations per kept
// (query, key) pair and head, 2.5 times the forward's (the dQ pass
// recomputes two of them, so the kernel does 3.5 times), against the
// bytes of q, k, v, o, dO, lse and the three gradients.  At the training
// shape (S = T = 4096, H = KV = 32, hd 80, causal) the operations bind by
// far: ~0.22 ms a batch row at bf16's tensor-core peak.  Neither design
// pipelines its loads (cp.async or TMA) nor uses wgmma; both are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// The same two passes for bf16 inputs up to head_dim 128, on mma.sync
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
  if constexpr (sizeof(T) == 2) {
#define FA_BWD_TC_LAUNCH(D)                                                  \
  return launch_tc<D>(q, k, v, dout, lse, dsum, dq, dk, dv, batch, seq_q,    \
                      seq_k, heads, kv_heads, hd, scale, causal, window,     \
                      softcap, stream)
    if (hd <= 64) FA_BWD_TC_LAUNCH(64);
    if (hd <= 80) FA_BWD_TC_LAUNCH(80);
    if (hd <= 96) FA_BWD_TC_LAUNCH(96);
    if (hd <= 128) FA_BWD_TC_LAUNCH(128);
#undef FA_BWD_TC_LAUNCH
  }
#define FA_BWD_LAUNCH(R, C)                                                  \
  return launch<T, R, C>(q, k, v, dout, lse, dsum, dq, dk, dv, batch, seq_q, \
                         seq_k, heads, kv_heads, hd, scale, causal, window,  \
                         softcap, stream)
  if (hd <= 64) FA_BWD_LAUNCH(4, 4);
  if (hd <= 80) FA_BWD_LAUNCH(4, 5);
  if (hd <= 96) FA_BWD_LAUNCH(4, 6);
  if (hd <= 128) FA_BWD_LAUNCH(4, 8);
  if (hd <= 192) FA_BWD_LAUNCH(2, 12);
  if (hd <= 256) FA_BWD_LAUNCH(2, 16);
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
