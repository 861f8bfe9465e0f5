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
// (5.4 us on the bf16 tensor cores), so bytes bind by a little; this
// kernel runs the products on the CUDA cores in f32, where 67 TFLOP/s caps
// it at ~80 us.
//
// What this first design does about it, and what it leaves for later:
//   * one block of 256 threads per (tile of 64 query rows, q head, batch);
//     the Pallas grid's sequential kv axis becomes a loop inside the block,
//     so m, l and the accumulator never leave registers;
//   * the loop visits only the 64-key tiles the mask can reach: it stops
//     after the causal limit of the tile's last row and starts at the
//     window's edge for its first row (the Pallas grid visits every kv
//     block and masks);
//   * each thread owns a 4 x 4 block of the 64 x 64 score tile (rows
//     ty + 16a, keys tx + 16b) and the same four rows of the accumulator
//     (columns tx + 16c), so a row's max and sum are a 16-lane shuffle and
//     the rescale by alpha is thread-local;
//   * Q and each K/V tile are staged in shared memory as f32; the Q and K
//     rows have a stride of hd + 1 so the dot products do not collide on
//     banks; K/V rows past T are staged as zeros, so a pad row can never
//     poison the accumulator;
//   * any head_dim up to 256 (80 for StableLM), with no power-of-two
//     padding of the loads.  Tensor cores (mma.sync / wgmma) and TMA are
//     later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
    return int(dispatch<__nv_bfloat16>(q, k, v, out, batch, seq_q, seq_k,
                                       heads, kv_heads, hd, scale, causal,
                                       window, softcap, stream));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
