// Blockwise prefill attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention
//   (body _attn_kernel, pallas_call at kernel.py:105).
// It computes the same function: q [B,S,H,hd], k/v [B,T,KV,hd]; query row i
// sits at position i + T - S (end-aligned); key j counts for row i when
// j < T, and j <= pos_q if causal, and j > pos_q - window if window > 0;
// scores are scaled, optionally tanh-softcapped, and reduced by an online
// softmax in f32; GQA head h reads kv head h / (H / KV).  A row that no key
// reaches gives 0 (acc / (l + 1e-30)).  Output has q's dtype.
//
// What bounds it on an H100: at the serving path's prefill shapes
// (S = T = 1024, H = KV = 32, hd = 80) the least time is the bytes of q, k,
// v and the output (21 MB -> 6.3 us) against 5.4 Gop of QK^T and PV
// (5.4 us on the bf16 tensor cores), so bytes bind by a little.
//
// Two designs, by dtype:
//   * bf16 (the serving path): the products run on the tensor cores
//     (common/csrc/tc_attention.cuh).  One block of 4 warps per (q head,
//     batch, tile of 64 query rows); each warp owns 16 rows and keeps their
//     Q fragments in registers for the whole walk (head_dim <= 128; above
//     that they are reloaded from shared memory each tile, for registers).
//     K/V tiles of 64 keys are copied in bf16 with 16-byte cp.async in two
//     stages, so the next tile loads while this one computes.  S = QK^T,
//     the mask, softcap's tanh and the online softmax stay in the f32
//     accumulator fragments, and P is fed to PV from registers.  The
//     head_dim is zero-padded in shared memory to a multiple of 16 (80 and
//     128 need none; any hd <= 256).  A head_dim that is not a multiple of
//     8, or a misaligned tensor, is staged element by element instead.  A
//     warp masks only the tiles that reach past its rows' causal limit,
//     the window's edge or T.  The query tiles sit in the grid's slowest
//     dimension, the longest causal walks first.  A GQA block still serves
//     one q head, so a K/V tile is staged once per q head; sharing it among
//     the G heads of a kv head is later work, as are wgmma and TMA (the
//     mma.sync products stay well below the tensor cores' rate).
//   * f32: the CUDA-core design of the first port, unchanged: the float32
//     engine parity run must be token-identical to the plain version, and
//     TF32 or bf16 products would not be.  One block of 256 threads per
//     (64 query rows, q head, batch); each thread owns a 4 x 4 block of the
//     64 x 64 score tile and the same four rows of the accumulator; Q and
//     each K/V tile staged as f32 with a row stride of hd + 1; the products
//     on fmaf (67 TFLOP/s caps it at ~80 us at the main shape).
// Both walk only the 64-key tiles the mask can reach: they stop after the
// causal limit of the tile's last row and start at the window's edge for
// its first row (the Pallas grid visits every kv block and masks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_attention.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileQ = 64;          // query rows per block
constexpr int kTileK = 64;          // keys per staged tile
constexpr int kLdp = kTileK + 16;   // probability tile row stride (no bank
                                    // conflict between the two rows of a warp)
constexpr float kNegInf = -2.0e38f;

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

// kCols: 16-wide column groups of the accumulator a thread keeps, so
// 16 * kCols >= hd.
size_t smem_bytes(int hd, int cols) {
  return sizeof(float) * (kTileQ * (hd + 1)          // q tile
                          + kTileK * (hd + 1)        // k tile
                          + kTileK * 16 * cols       // v tile (zero-padded)
                          + kTileQ * kLdp);          // probabilities
}

template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int seq_q, int seq_k, int heads, int kv_heads,
    int hd, float scale, int causal, int window, float softcap) {
  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int ldq = hd + 1, ldv = 16 * kCols;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                        // [kTileQ, ldq]
  float* k_s = q_s + kTileQ * ldq;          // [kTileK, ldq]
  float* v_s = k_s + kTileK * ldq;          // [kTileK, ldv]
  float* p_s = v_s + kTileK * ldv;          // [kTileQ, kLdp]

  const int nq = min(kTileQ, seq_q - q0);
  const size_t q_row = size_t(heads) * hd;          // stride of a q row
  const size_t kv_row = size_t(kv_heads) * hd;      // stride of a k/v row
  const T* q_base = q + (size_t(b) * seq_q + q0) * q_row + size_t(h) * hd;
  const T* k_base = k + size_t(b) * seq_k * kv_row + size_t(kvh) * hd;
  const T* v_base = v + size_t(b) * seq_k * kv_row + size_t(kvh) * hd;

  for (int i = tid; i < kTileQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    q_s[r * ldq + d] = r < nq ? to_f32(q_base[r * q_row + d]) : 0.f;
  }
  // zero the v tile's pad columns once; the loads below never touch them
  for (int i = tid; i < kTileK * (ldv - hd); i += kThreads) {
    const int j = i / (ldv - hd), d = hd + i - j * (ldv - hd);
    v_s[j * ldv + d] = 0.f;
  }

  // positions of this tile's first and last live rows, and the keys the
  // mask lets them reach
  const int shift = seq_k - seq_q;
  const int pos_first = q0 + shift, pos_last = q0 + nq - 1 + shift;
  int k_end = seq_k;
  if (causal) k_end = min(k_end, pos_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, pos_first - window + 1);
  k_begin = (k_begin / kTileK) * kTileK;

  float acc[4][kCols];
  float m_row[4], l_row[4];
  int pos_row[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_row[a] = kNegInf;
    l_row[a] = 0.f;
    pos_row[a] = q0 + ty + 16 * a + shift;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;
  }

  for (int t0 = k_begin; t0 < k_end; t0 += kTileK) {
    const int nt = min(kTileK, seq_k - t0);
    __syncthreads();  // the previous tile's k_s / v_s / p_s are consumed
    for (int i = tid; i < kTileK * hd; i += kThreads) {
      const int j = i / hd, d = i - j * hd;
      float kx = 0.f, vx = 0.f;
      if (j < nt) {
        const size_t off = size_t(t0 + j) * kv_row + d;
        kx = to_f32(k_base[off]);
        vx = to_f32(v_base[off]);
      }
      k_s[j * ldq + d] = kx;
      v_s[j * ldv + d] = vx;
    }
    __syncthreads();

    // scores of this thread's 4 x 4 block
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) s[a][bb] = 0.f;
    const float* qr = q_s + ty * ldq;
    const float* kr = k_s + tx * ldq;
    for (int d = 0; d < hd; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = qr[(16 * a) * ldq + d];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) kb[bb] = kr[(16 * bb) * ldq + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) s[a][bb] = fmaf(qa[a], kb[bb], s[a][bb]);
    }

    // mask, online softmax update, probabilities to shared memory
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int pq = pos_row[a];
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int kj = t0 + tx + 16 * bb;
        bool ok = kj < seq_k;
        if (causal) ok = ok && kj <= pq;
        if (window > 0) ok = ok && kj > pq - window;
        float sc = s[a][bb] * scale;
        if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
        s[a][bb] = ok ? sc : kNegInf;
        valid[bb] = ok;
        mx = fmaxf(mx, s[a][bb]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_cur = fmaxf(m_row[a], mx);
      const float alpha = expf(m_row[a] - m_cur);
      float sum = 0.f;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const float p = valid[bb] ? expf(s[a][bb] - m_cur) : 0.f;
        p_s[(ty + 16 * a) * kLdp + tx + 16 * bb] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_row[a] = l_row[a] * alpha + sum;
      m_row[a] = m_cur;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();

    // acc += P . V over the tile's keys
    const float* pr = p_s + ty * kLdp;
    for (int j = 0; j < nt; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = pr[(16 * a) * kLdp + j];
      const float* vr = v_s + j * ldv + tx;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vx = vr[16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pa[a], vx, acc[a][c]);
      }
    }
  }

  T* o_base = out + (size_t(b) * seq_q + q0) * q_row + size_t(h) * hd;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (r >= nq) continue;
    const float inv = 1.f / (l_row[a] + 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) o_base[r * q_row + d] = from_f32<T>(acc[a][c] * inv);
    }
  }
}

template <typename T, int kCols>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int seq_q, int seq_k, int heads, int kv_heads,
                   int hd, float scale, int causal, int window, float softcap,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, kCols);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, kCols>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + kTileQ - 1) / kTileQ, heads, batch);
  flash_attention_kernel<T, kCols><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), seq_q, seq_k, heads,
      kv_heads, hd, scale, causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int batch, int seq_q, int seq_k, int heads, int kv_heads,
                     int hd, float scale, int causal, int window,
                     float softcap, cudaStream_t stream) {
#define FA_LAUNCH(COLS)                                                    \
  return launch<T, COLS>(q, k, v, out, batch, seq_q, seq_k, heads,        \
                         kv_heads, hd, scale, causal, window, softcap, stream)
  if (hd <= 64) FA_LAUNCH(4);
  if (hd <= 80) FA_LAUNCH(5);
  if (hd <= 128) FA_LAUNCH(8);
  if (hd <= 256) FA_LAUNCH(16);
#undef FA_LAUNCH
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- bf16
// Stage n rows of a bf16 tensor (row stride ``stride``, hd live columns)
// into a 64-row shared tile of row stride ld; rows past n become zeros.
// vec: hd % 8 == 0 and 16-byte aligned rows, copied with cp.async (the
// caller commits); otherwise element by element.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t stride, int n, int hd,
                                           int ld, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const int chunks = hd / 8;
    for (int i = tid; i < tc::kTileQ * chunks; i += tc::kThreads) {
      const int r = i / chunks, c = i - r * chunks;
      const bool live = r < n;
      tc::cp_async16(dst + r * ld + 8 * c,
                     live ? src + r * stride + 8 * c : src, live);
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
  return sizeof(__nv_bfloat16) * 5 * tc::kTileQ * (kD + 8);  // q, 2 x (k, v)
}

// three blocks an SM for a head_dim up to 80 caps the registers at 170 a
// thread, the faster build at StableLM's shapes; above, the accumulators
// need more
template <int kD>
__global__ void __launch_bounds__(tc::kThreads, kD <= 80 ? 3 : 1)
    flash_attention_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int seq_q, int seq_k, int heads, int kv_heads, int hd, float scale,
    int causal, int window, float softcap, int vec) {
  constexpr bool kQRegs = kD <= 128;
  constexpr int ld = kD + 8;
  // query tiles in the grid's slowest dimension, last (longest causal
  // walk) first, so the long blocks start first and the short ones fill in
  const int q0 = (gridDim.z - 1 - blockIdx.z) * tc::kTileQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (heads / kv_heads);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + tc::kTileQ * ld;          // [2][kTileK][ld]
  __nv_bfloat16* v_s = k_s + 2 * tc::kTileK * ld;      // [2][kTileK][ld]

  const int nq = min(tc::kTileQ, seq_q - q0);
  const size_t q_row = size_t(heads) * hd;
  const size_t kv_row = size_t(kv_heads) * hd;
  const __nv_bfloat16* q_base =
      q + (size_t(b) * seq_q + q0) * q_row + size_t(h) * hd;
  const __nv_bfloat16* k_base =
      k + size_t(b) * seq_k * kv_row + size_t(kvh) * hd;
  const __nv_bfloat16* v_base =
      v + size_t(b) * seq_k * kv_row + size_t(kvh) * hd;

  // the pad columns hd..kD-1 of every tile are zeros, written once (the
  // copies below never touch them)
  for (int i = tid; i < 5 * tc::kTileQ * (kD - hd); i += tc::kThreads) {
    const int r = i / (kD - hd), d = hd + i - r * (kD - hd);
    q_s[r * ld + d] = __float2bfloat16(0.f);
  }

  const int shift = seq_k - seq_q;
  const int pos_first = q0 + shift, pos_last = q0 + nq - 1 + shift;
  int k_end = seq_k;
  if (causal) k_end = min(k_end, pos_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, pos_first - window + 1);
  k_begin = (k_begin / tc::kTileK) * tc::kTileK;
  const int n_tiles = k_end > k_begin
                          ? (k_end - k_begin + tc::kTileK - 1) / tc::kTileK
                          : 0;

  auto stage_kv = [&](int stage, int t0) {
    const int nt = min(tc::kTileK, seq_k - t0);
    stage_rows(k_s + stage * tc::kTileK * ld, k_base + size_t(t0) * kv_row,
               kv_row, nt, hd, ld, vec);
    stage_rows(v_s + stage * tc::kTileK * ld, v_base + size_t(t0) * kv_row,
               kv_row, nt, hd, ld, vec);
  };
  stage_rows(q_s, q_base, q_row, nq, hd, ld, vec);
  if (n_tiles > 0) stage_kv(0, k_begin);
  tc::cp_async_commit();

  // this thread's two rows (g and g + 8 of the warp's 16) and the warp's
  // position range
  const int row_w = warp * 16;
  const int pos_lo = q0 + row_w + lane / 4 + shift;
  const int pos_w_first = q0 + row_w + shift, pos_w_last = pos_w_first + 15;
  const bool warp_live = row_w < nq;

  tc::WarpState<kD> st;
  st.init();
  uint32_t qf[kQRegs ? kD / 16 : 1][4];

  const auto score = [=](float x) {
    return softcap > 0.f ? tanhf(x / softcap) * softcap : x;
  };

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = k_begin + it * tc::kTileK;
    if (it + 1 < n_tiles) stage_kv((it + 1) & 1, t0 + tc::kTileK);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    if constexpr (kQRegs) {
      if (it == 0 && warp_live)
        tc::load_q_frags<kD>(qf, q_s + row_w * ld, ld);
    }
    // a warp skips a tile that no key of which reaches any of its rows,
    // and masks only a tile that some key of which misses one of them
    const int t_last = t0 + tc::kTileK - 1;
    bool live = warp_live, whole = t_last < seq_k;
    if (causal) {
      live = live && t0 <= pos_w_last;
      whole = whole && t_last <= pos_w_first;
    }
    if (window > 0) {
      live = live && t_last > pos_w_first - window;
      whole = whole && t0 > pos_w_last - window;
    }
    const int stage = it & 1;
    const __nv_bfloat16* k_t = k_s + stage * tc::kTileK * ld;
    const __nv_bfloat16* v_t = v_s + stage * tc::kTileK * ld;
    if (live && whole) {
      tc::attend_tile<kD, kQRegs>(st, qf, q_s + row_w * ld, k_t, v_t, ld,
                                  scale, score, tc::AllKeys{});
    } else if (live) {
      const auto keep = [=](int half, int j) {
        const int kj = t0 + j, pq = pos_lo + 8 * half;
        bool ok = kj < seq_k;
        if (causal) ok = ok && kj <= pq;
        if (window > 0) ok = ok && kj > pq - window;
        return ok;
      };
      tc::attend_tile<kD, kQRegs>(st, qf, q_s + row_w * ld, k_t, v_t, ld,
                                  scale, score, keep);
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  if (!warp_live) return;
  __nv_bfloat16* o_base =
      out + (size_t(b) * seq_q + q0 + row_w) * q_row + size_t(h) * hd;
  tc::finish<kD>(st, hd, [&](int half, int d, float x) {
    const int r = lane / 4 + 8 * half;
    if (row_w + r < nq) o_base[r * q_row + d] = __float2bfloat16(x);
  });
}

template <int kD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      int batch, int seq_q, int seq_k, int heads,
                      int kv_heads, int hd, float scale, int causal,
                      int window, float softcap, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int vec = hd % 8 == 0 &&
                  (reinterpret_cast<uintptr_t>(q) |
                   reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const dim3 grid(heads, batch, (seq_q + tc::kTileQ - 1) / tc::kTileQ);
  flash_attention_tc_kernel<kD><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      seq_q, seq_k, heads, kv_heads, hd, scale, causal, window, softcap, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v,
                        void* out, int batch, int seq_q, int seq_k, int heads,
                        int kv_heads, int hd, float scale, int causal,
                        int window, float softcap, cudaStream_t stream) {
#define FA_TC_LAUNCH(D)                                                   \
  return launch_tc<D>(q, k, v, out, batch, seq_q, seq_k, heads, kv_heads, \
                      hd, scale, causal, window, softcap, stream)
  if (hd <= 64) FA_TC_LAUNCH(64);
  if (hd <= 80) FA_TC_LAUNCH(80);
  if (hd <= 128) FA_TC_LAUNCH(128);
  if (hd <= 256) FA_TC_LAUNCH(256);
#undef FA_TC_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes shared with kernel.py: 0 float32, 1 bfloat16.  softcap <= 0
// means none; window <= 0 means none.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int batch, int seq_q, int seq_k,
                               int heads, int kv_heads, int hd, float scale,
                               int causal, int window, float softcap,
                               int dtype, void* stream_handle) {
  cudaGetLastError();  // start from a clean error state
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (dtype == 0)
    return int(dispatch<float>(q, k, v, out, batch, seq_q, seq_k, heads,
                               kv_heads, hd, scale, causal, window, softcap,
                               stream));
  if (dtype == 1)
    return int(dispatch_tc(q, k, v, out, batch, seq_q, seq_k, heads,
                           kv_heads, hd, scale, causal, window, softcap,
                           stream));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
