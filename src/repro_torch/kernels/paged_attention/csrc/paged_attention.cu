// Ragged paged attention over a KV page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/paged_attention/kernel.py::paged_attention_mixed
//   (body _mixed_kernel, pallas_call at kernel.py:137).
// It computes the same function: every lane b carries Q query rows with a
// per-row sequence position; GQA head h reads kv head h / (H / KV); key slot
// t of the lane's pages counts for row i only if t <= q_positions[b, i];
// the softmax is online and in f32; int8 pages are dequantized in registers
// with their per-page-row f32 scales.  Output has q's dtype.
//
// What bounds it on an H100: memory.  Each key costs 4 * hd flops per query
// row that reads it against 2 * hd * sizeof(page element) bytes of K and V,
// so with the serving path's one- or few-row lanes the work sits far below
// the ~295 flop/byte ridge of the bf16 tensor cores; the least time is the
// distinct K/V pages the rows touch over 3.35 TB/s.
//
// What this first design does about it, and what it leaves for later:
//   * one block per (lane, kv head, group of <= 16 query rows); all Q x G
//     rows that share a kv head sit in one block, so a gathered K/V tile is
//     read from device memory once per block and reused by every row;
//   * the page walk stops at the key holding the block's largest position
//     (the TPU grid walks every page; a fully masked page leaves m, l and
//     acc unchanged, so the result is the same);
//   * a tile of 64 key slots (any page size: several small pages or part of
//     a large one) is gathered through the block table and staged in shared
//     memory as f32, dequantized on the way in; the K tile's row stride is
//     hd + 1 so the per-key dot products do not collide on banks;
//   * the hd loops take any head_dim up to 256 (80 for StableLM), with no
//     power-of-two padding;
//   * scores and the P.V product run on the CUDA cores in f32.  wgmma, TMA
//     and a per-lane Q-block launch that gathers a lane's pages once for a
//     whole prefill chunk are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileK = 64;      // key slots staged per tile
constexpr int kRows = 16;       // query rows (Q x G) per block
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int hd) {
  return kTileK * sizeof(long long) +
         sizeof(float) * (2 * kRows * hd          // q rows, accumulators
                          + kTileK * (hd + 1)     // K tile (padded stride)
                          + kTileK * hd           // V tile
                          + kRows * kTileK        // scores / probabilities
                          + 3 * kRows) +          // m, l, alpha
         sizeof(int) * kRows;                     // row positions
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_attention_mixed_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ q_positions, QT* __restrict__ out, int qn,
    int heads, int kv_heads, int hd, int page, int pps, float scale) {
  const int lane = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = heads / kv_heads;
  const int row0 = blockIdx.z * kRows;
  const int nrows = min(kRows, qn * group - row0);
  const int tid = threadIdx.x;
  const int ldk = hd + 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* key_row = reinterpret_cast<long long*>(smem_raw);  // [kTileK]
  float* q_s = reinterpret_cast<float*>(key_row + kTileK);      // [kRows, hd]
  float* acc = q_s + kRows * hd;                                // [kRows, hd]
  float* k_s = acc + kRows * hd;                                // [kTileK, ldk]
  float* v_s = k_s + kTileK * ldk;                              // [kTileK, hd]
  float* s_s = v_s + kTileK * hd;                               // [kRows, kTileK]
  float* m_s = s_s + kRows * kTileK;                            // [kRows]
  float* l_s = m_s + kRows;                                     // [kRows]
  float* alpha_s = l_s + kRows;                                 // [kRows]
  int* pos_s = reinterpret_cast<int*>(alpha_s + kRows);         // [kRows]
  __shared__ int n_keys_s;

  // local row r is global row row0 + r = qi * group + g, head kvh*group + g
  for (int i = tid; i < nrows * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int rr = row0 + r, qi = rr / group;
    const int h = kvh * group + (rr - qi * group);
    q_s[i] = to_f32(q[((size_t(lane) * qn + qi) * heads + h) * hd + d]);
    acc[i] = 0.f;
  }
  if (tid < nrows) {
    pos_s[tid] = q_positions[size_t(lane) * qn + (row0 + tid) / group];
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int max_pos = -1;
    for (int r = 0; r < nrows; ++r) max_pos = max(max_pos, pos_s[r]);
    n_keys_s = min(max_pos + 1, pps * page);
  }
  __syncthreads();
  const int n_keys = n_keys_s;
  const int32_t* table = tables + size_t(lane) * pps;
  const int warp = tid / 32, wl = tid % 32;

  for (int t0 = 0; t0 < n_keys; t0 += kTileK) {
    const int nt = min(kTileK, n_keys - t0);
    if (tid < nt) {
      const int t = t0 + tid, slot = t / page;
      key_row[tid] =
          ((long long)table[slot] * page + (t - slot * page)) * kv_heads + kvh;
    }
    __syncthreads();
    // gather the tile through the block table, dequantizing on the way in
    for (int i = tid; i < nt * hd; i += kThreads) {
      const int j = i / hd, d = i - j * hd;
      const long long row = key_row[j];
      float kx = to_f32(k_pages[row * hd + d]);
      float vx = to_f32(v_pages[row * hd + d]);
      if (k_scales != nullptr) kx *= k_scales[row];
      if (v_scales != nullptr) vx *= v_scales[row];
      k_s[j * ldk + d] = kx;
      v_s[j * hd + d] = vx;
    }
    __syncthreads();
    // scores, causal by position
    for (int i = tid; i < nrows * kTileK; i += kThreads) {
      const int r = i / kTileK, j = i - r * kTileK;
      float sc = kNegInf;
      if (j < nt && t0 + j <= pos_s[r]) {
        const float* qr = q_s + r * hd;
        const float* kr = k_s + j * ldk;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot * scale;
      }
      s_s[i] = sc;
    }
    __syncthreads();
    // online softmax update, one warp per row
    for (int r = warp; r < nrows; r += kThreads / 32) {
      float* sr = s_s + r * kTileK;
      float mx = kNegInf;
      for (int j = wl; j < kTileK; j += 32) mx = fmaxf(mx, sr[j]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = wl; j < kTileK; j += 32) {
        const bool valid = j < nt && t0 + j <= pos_s[r];
        const float p = valid ? expf(sr[j] - m_cur) : 0.f;
        sr[j] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (wl == 0) {
        const float a = expf(m_prev - m_cur);
        alpha_s[r] = a;
        l_s[r] = l_s[r] * a + sum;
        m_s[r] = m_cur;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P . V
    for (int i = tid; i < nrows * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const float* pr = s_s + r * kTileK;
      float a = acc[i] * alpha_s[r];
      for (int j = 0; j < nt; ++j) a = fmaf(pr[j], v_s[j * hd + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < nrows * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int rr = row0 + r, qi = rr / group;
    const int h = kvh * group + (rr - qi * group);
    out[((size_t(lane) * qn + qi) * heads + h) * hd + d] =
        from_f32<QT>(acc[i] / (l_s[r] + 1e-30f));
  }
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scales, const void* v_scales,
                   const void* tables, const void* q_positions, void* out,
                   int batch, int qn, int heads, int kv_heads, int hd,
                   int page, int pps, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_mixed_kernel<QT, KT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int rows = qn * (heads / kv_heads);
  const dim3 grid(batch, kv_heads, (rows + kRows - 1) / kRows);
  paged_attention_mixed_kernel<QT, KT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(q_positions), static_cast<QT*>(out), qn,
      heads, kv_heads, hd, page, pps, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes shared with kernel.py: 0 float32, 1 bfloat16, 2 int8 (pages)
extern "C" int paged_attention_mixed(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* q_positions, void* out, int batch, int qn, int heads,
    int kv_heads, int hd, int page, int pps, float scale, int q_dtype,
    int kv_dtype, void* stream_handle) {
  cudaGetLastError();  // start from a clean error state
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
#define PA_LAUNCH(QT, KT)                                                    \
  return int(launch<QT, KT>(q, k_pages, v_pages, k_scales, v_scales, tables, \
                            q_positions, out, batch, qn, heads, kv_heads,   \
                            hd, page, pps, scale, stream))
  if (q_dtype == 0 && kv_dtype == 0) PA_LAUNCH(float, float);
  if (q_dtype == 0 && kv_dtype == 1) PA_LAUNCH(float, __nv_bfloat16);
  if (q_dtype == 0 && kv_dtype == 2) PA_LAUNCH(float, int8_t);
  if (q_dtype == 1 && kv_dtype == 0) PA_LAUNCH(__nv_bfloat16, float);
  if (q_dtype == 1 && kv_dtype == 1) PA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 2) PA_LAUNCH(__nv_bfloat16, int8_t);
#undef PA_LAUNCH
  return int(cudaErrorInvalidValue);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
