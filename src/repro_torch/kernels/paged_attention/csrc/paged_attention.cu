// Ragged paged attention over a KV page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/paged_attention/kernel.py::paged_attention_mixed
//   (body _mixed_kernel, pallas_call at kernel.py:137).
// It computes the same function: every lane b carries Q query rows with a
// per-row sequence position; GQA head h reads kv head h / (H / KV); key slot
// t of the lane's pages counts for row i only if t <= q_positions[b, i];
// the softmax is online and in f32; int8 pages are dequantized with their
// per-page-row f32 scales.  Output has q's dtype.
//
// What bounds it on an H100: memory.  Each key costs 4 * hd flops per query
// row that reads it against 2 * hd * sizeof(page element) bytes of K and V,
// so a decode lane (one row) sits far below the ~295 flop/byte ridge of the
// bf16 tensor cores; the least time is the distinct K/V pages the rows
// touch over 3.35 TB/s.  What a call reads beyond that is set by its shape:
// the serving runtime calls lane-major (serving/paged_runtime.py), one lane
// per sequence with all of its rows (a decode lane's 1 + draft rows, a
// prefill chunk's rows) and pad rows at position 0, so a block gathers its
// lane's pages once for up to 64 rows.  Called row-major (one row per lane,
// the JAX runtime's shape), a 64-row chunk gathers its pages 64 times.
// Lane-major padding was chosen over a varlen entry (row offsets per
// lane): it keeps this function, [B,Q,H,hd] with per-row positions, and its
// plain version exactly the TPU kernel's, and a pad row costs little here
// (below).
//
// Two designs, by q's dtype; both give one block per (lane, kv head, tile
// of that lane's Q x G rows, a row being (query, head of the group)), so
// a gathered K/V tile is read once per block and reused by every row, and
// both stop the page walk at the key holding the block's largest position
// (the TPU grid walks every page; a fully masked page leaves m, l and acc
// unchanged).  Any page size (a 64-key tile spans several small pages or
// part of a large one) and any head_dim up to 256 (80 for StableLM).
//   * bf16 q (the serving path; bf16, int8 or f32 pages): the products run
//     on the tensor cores (common/csrc/tc_attention.cuh).  Tiles of up to
//     64 rows, 4 warps of 16.  bf16 pages are gathered through the block
//     table with 16-byte cp.async into two stages, the next tile loading
//     while this one computes; int8 (and f32) pages are dequantized with
//     their scales into bf16 in shared memory on the way in, through
//     registers, so those loads do not overlap the products.  The head_dim
//     is zero-padded in shared memory to a multiple of 16.  A warp skips
//     every tile that starts past its rows' largest position, so a warp of
//     pad rows (position 0) computes one tile and a warp past the lane's
//     rows none, and it masks only a tile that reaches past one of its
//     rows' positions.  Each thread reads the block table an iteration
//     ahead of the copy that needs it.  Rounding: int8 pages dequantize to
//     bf16 (the plain version keeps f32), and P enters PV as bf16; both
//     stay inside bf16's 2e-2.
//   * f32 q: the CUDA-core design of the first port, unchanged, for the
//     float32 engine parity (TF32 or bf16 products would change tokens).
//     Tiles of 16 rows; the 64-key tile staged as f32 in shared memory,
//     dequantized on the way in; scores and P.V on fmaf.
// wgmma, TMA, and overlapping int8 dequantization with the products are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tc_attention.cuh"

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

// ---------------------------------------------------------------- bf16 q
// Stage one key row (hd live columns at pages[row * hd]) into shared
// memory as bf16, dequantized with scales[row] when given; row < 0 stages
// zeros.  The two threads of a key split its 8-column chunks (vec: hd % 8
// == 0 and 16-byte aligned pages; bf16 goes by cp.async, the caller
// commits) or its columns.
__device__ __forceinline__ void stage_key(__nv_bfloat16* dst,
                                          const __nv_bfloat16* pages,
                                          const float*, long long row, int hd,
                                          bool vec, int half) {
  if (vec) {
    for (int c = half; c < hd / 8; c += 2)
      tc::cp_async16(dst + 8 * c, row >= 0 ? pages + row * hd + 8 * c : pages,
                     row >= 0);
  } else {
    for (int d = half; d < hd; d += 2)
      dst[d] = row >= 0 ? pages[row * hd + d] : __float2bfloat16(0.f);
  }
}

template <typename KT>
__device__ __forceinline__ void stage_key(__nv_bfloat16* dst, const KT* pages,
                                          const float* scales, long long row,
                                          int hd, bool vec, int half) {
  const float sc = row >= 0 && scales != nullptr ? scales[row] : 1.f;
  if (vec) {
    for (int c = half; c < hd / 8; c += 2) {
      float x[8];
      if (row < 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = 0.f;
      } else if constexpr (sizeof(KT) == 1) {
        const uint2 w =
            *reinterpret_cast<const uint2*>(pages + row * hd + 8 * c);
        const int8_t* b = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(b[i]) * sc;
      } else {
        const float4* p4 =
            reinterpret_cast<const float4*>(pages + row * hd + 8 * c);
        const float4 lo = p4[0], hi = p4[1];
        const float y[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = y[i] * sc;
      }
      tc::store_bf16x8(dst + 8 * c, x);
    }
  } else {
    for (int d = half; d < hd; d += 2)
      dst[d] = __float2bfloat16(
          row >= 0 ? to_f32(pages[row * hd + d]) * sc : 0.f);
  }
}

// K/V tiles in shared memory: one computes while the next loads.  Three
// and four stages measured no faster on the H100 at the main shape: the
// copies are bound by the pool's layout (a kv head's keys of a page lie
// KV * hd elements apart, so each key is a separate 160-byte read at
// StableLM's shapes), not by their latency.
constexpr int kStages = 2;

template <int kD>
size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * (1 + 2 * kStages) * tc::kTileQ * (kD + 8)
         + sizeof(int) * tc::kTileQ;                        // row positions
}

// three blocks an SM for a head_dim up to 80 caps the registers at 170 a
// thread, the faster build at StableLM's shapes; above, the accumulators
// need more
template <typename KT, int kD>
__global__ void __launch_bounds__(tc::kThreads, kD <= 80 ? 3 : 1)
    paged_attention_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ q_positions, __nv_bfloat16* __restrict__ out,
    int qn, int heads, int kv_heads, int hd, int page, int pps, float scale,
    int vec) {
  constexpr bool kQRegs = kD <= 128;
  constexpr int ld = kD + 8;
  const int lane_b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = heads / kv_heads;
  const int row0 = blockIdx.z * tc::kTileQ;
  const int nrows = min(tc::kTileQ, qn * group - row0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + tc::kTileQ * ld;      // [kStages][kTileK][ld]
  __nv_bfloat16* v_s = k_s + kStages * tc::kTileK * ld;
  int* pos_s = reinterpret_cast<int*>(v_s + kStages * tc::kTileK * ld);

  // local row r is row row0 + r = qi * group + g of the lane: query qi,
  // head kvh * group + g; rows past the lane's Q x G sit at position -1
  const auto q_offset = [&](int r) {
    const int rr = row0 + r, qi = rr / group;
    return ((size_t(lane_b) * qn + qi) * heads + kvh * group +
            (rr - qi * group)) * size_t(hd);
  };
  for (int i = tid; i < (1 + 2 * kStages) * tc::kTileQ * (kD - hd);
       i += tc::kThreads) {
    const int r = i / (kD - hd), d = hd + i - r * (kD - hd);
    q_s[r * ld + d] = __float2bfloat16(0.f);
  }
  if (tid < tc::kTileQ)
    pos_s[tid] = tid < nrows
                     ? q_positions[size_t(lane_b) * qn + (row0 + tid) / group]
                     : -1;
  if (vec) {
    const int chunks = hd / 8;
    for (int i = tid; i < tc::kTileQ * chunks; i += tc::kThreads) {
      const int r = i / chunks, c = i - r * chunks;
      tc::cp_async16(q_s + r * ld + 8 * c,
                     r < nrows ? q + q_offset(r) + 8 * c : q, r < nrows);
    }
  } else {
    for (int i = tid; i < tc::kTileQ * hd; i += tc::kThreads) {
      const int r = i / hd, d = i - r * hd;
      q_s[r * ld + d] =
          r < nrows ? q[q_offset(r) + d] : __float2bfloat16(0.f);
    }
  }
  __syncthreads();
  // the block's largest position, and the warp's rows' largest and least
  // (-1 when one of its rows lies past the lane's rows)
  const int row_w = warp * 16;
  int max_pos = -1, warp_max = -1, warp_min = INT_MAX;
  for (int r = 0; r < tc::kTileQ; ++r) {
    max_pos = max(max_pos, pos_s[r]);
    if (r >= row_w && r < row_w + 16) {
      warp_max = max(warp_max, pos_s[r]);
      warp_min = min(warp_min, pos_s[r]);
    }
  }
  const int pos_row[2] = {pos_s[row_w + lane / 4], pos_s[row_w + lane / 4 + 8]};
  const int n_keys = min(max_pos + 1, pps * page);
  const int n_tiles = (n_keys + tc::kTileK - 1) / tc::kTileK;
  const int32_t* table = tables + size_t(lane_b) * pps;

  // two threads per key of the tile; the page of a thread's key is read
  // from the block table an iteration ahead of its copy, so the copies
  // never wait on the table (-1: a key past the walk, staged as zeros)
  const int key = tid / 2, half = tid % 2;
  const auto page_of = [&](int t0) {
    const int t = t0 + key;
    return t < n_keys ? table[t / page] : -1;
  };
  const auto stage_kv = [&](int stage, int t0, int pid) {
    const int t = t0 + key;
    const long long row =
        pid < 0 ? -1 : ((long long)pid * page + t % page) * kv_heads + kvh;
    const int off = (stage * tc::kTileK + key) * ld;
    stage_key(k_s + off, k_pages, k_scales, row, hd, vec, half);
    stage_key(v_s + off, v_pages, v_scales, row, hd, vec, half);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) stage_kv(i, i * tc::kTileK, page_of(i * tc::kTileK));
    tc::cp_async_commit();
  }
  int pid_next = page_of((kStages - 1) * tc::kTileK);

  tc::WarpState<kD> st;
  st.init();
  uint32_t qf[kQRegs ? kD / 16 : 1][4];
  const auto score = [](float x) { return x; };

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * tc::kTileK;
    const int ahead = it + kStages - 1;
    if (ahead < n_tiles)
      stage_kv(ahead % kStages, ahead * tc::kTileK, pid_next);
    pid_next = page_of((ahead + 1) * tc::kTileK);
    tc::cp_async_commit();
    tc::cp_async_wait<kStages - 1>();
    __syncthreads();
    if constexpr (kQRegs) {
      if (it == 0 && warp_max >= 0)
        tc::load_q_frags<kD>(qf, q_s + row_w * ld, ld);
    }
    // a warp skips a tile past its rows' positions, and masks only a tile
    // that reaches past one of them
    const int stage = it % kStages;
    const __nv_bfloat16* k_t = k_s + stage * tc::kTileK * ld;
    const __nv_bfloat16* v_t = v_s + stage * tc::kTileK * ld;
    const __nv_bfloat16* q_w = q_s + row_w * ld;
    if (t0 + tc::kTileK - 1 <= warp_min) {
      tc::attend_tile<kD, kQRegs>(st, qf, q_w, k_t, v_t, ld, scale, score,
                                  tc::AllKeys{});
    } else if (t0 <= warp_max) {
      const auto keep = [=](int h, int j) { return t0 + j <= pos_row[h]; };
      tc::attend_tile<kD, kQRegs>(st, qf, q_w, k_t, v_t, ld, scale, score,
                                  keep);
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  if (row_w >= nrows) return;
  tc::finish<kD>(st, hd, [&](int h, int d, float x) {
    const int r = row_w + lane / 4 + 8 * h;
    if (r < nrows) out[q_offset(r) + d] = __float2bfloat16(x);
  });
}

template <typename KT, int kD>
cudaError_t launch_tc(const void* q, const void* k_pages, const void* v_pages,
                      const void* k_scales, const void* v_scales,
                      const void* tables, const void* q_positions, void* out,
                      int batch, int qn, int heads, int kv_heads, int hd,
                      int page, int pps, float scale, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_tc_kernel<KT, kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int vec = hd % 8 == 0 &&
                  (reinterpret_cast<uintptr_t>(q) |
                   reinterpret_cast<uintptr_t>(k_pages) |
                   reinterpret_cast<uintptr_t>(v_pages)) % 16 == 0;
  const int rows = qn * (heads / kv_heads);
  const dim3 grid(batch, kv_heads, (rows + tc::kTileQ - 1) / tc::kTileQ);
  paged_attention_tc_kernel<KT, kD><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(q_positions),
      static_cast<__nv_bfloat16*>(out), qn, heads, kv_heads, hd, page, pps,
      scale, vec);
  return cudaGetLastError();
}

template <typename KT>
cudaError_t dispatch_tc(const void* q, const void* k_pages,
                        const void* v_pages, const void* k_scales,
                        const void* v_scales, const void* tables,
                        const void* q_positions, void* out, int batch, int qn,
                        int heads, int kv_heads, int hd, int page, int pps,
                        float scale, cudaStream_t stream) {
#define PA_TC_LAUNCH(D)                                                      \
  return launch_tc<KT, D>(q, k_pages, v_pages, k_scales, v_scales, tables,   \
                          q_positions, out, batch, qn, heads, kv_heads, hd, \
                          page, pps, scale, stream)
  if (hd <= 64) PA_TC_LAUNCH(64);
  if (hd <= 80) PA_TC_LAUNCH(80);
  if (hd <= 128) PA_TC_LAUNCH(128);
  if (hd <= 256) PA_TC_LAUNCH(256);
#undef PA_TC_LAUNCH
  return cudaErrorInvalidValue;
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
#undef PA_LAUNCH
#define PA_TC(KT)                                                            \
  return int(dispatch_tc<KT>(q, k_pages, v_pages, k_scales, v_scales,       \
                             tables, q_positions, out, batch, qn, heads,    \
                             kv_heads, hd, page, pps, scale, stream))
  if (q_dtype == 1 && kv_dtype == 0) PA_TC(float);
  if (q_dtype == 1 && kv_dtype == 1) PA_TC(__nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 2) PA_TC(int8_t);
#undef PA_TC
  return int(cudaErrorInvalidValue);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
