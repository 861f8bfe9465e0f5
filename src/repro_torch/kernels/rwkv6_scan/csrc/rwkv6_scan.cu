// RWKV-6 WKV recurrence, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/rwkv6_scan/kernel.py::rwkv6_scan
//   (body _wkv_kernel, pallas_call at kernel.py:71).
// It computes the same function, per (batch, head), with an f32 state
// S [hd, hd] (row i: key channel, column j: value channel):
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// from s0 (the caller passes zeros for none), returning y in the inputs'
// dtype and the final state in f32.  Any sequence length: the Pallas
// kernel's S % chunk restriction is a BlockSpec artefact.
//
// What bounds it on an H100: at the RWKV-6 1.6B prefill shape (S = 1024,
// 32 heads of 64, f32 inputs) the inputs, y and the states are ~43 MB
// (12.8 us at 3.35 TB/s) against ~0.68 Gop of f32 work (10 us at
// 67 TFLOP/s: 5 operations per state element and step, since the u term
// factors as v_t[j] * sum_i r_t[i] u[i] k_t[i]), so bytes bind, but not by
// much; and the recurrence is sequential in t.  A decode step (S = 1) is
// all state traffic: 2 x 16 KB of f32 state per (b, h).
//
// The first design gave each (b, h) one block of hd threads, thread j
// walking all hd rows of column j every step: 32 blocks of 2 warps at
// B = 1, each step a 64-long chain of dependent FMAs fed by shared-memory
// broadcasts, staging that did not overlap compute; 43x the bound.  This
// design, for calls of 8 steps or more:
//   * splits each (b, h) by value column, which the recurrence never
//     mixes: a block holds 16 columns, so the RWKV-6 prefill runs 128
//     blocks of 4 warps (4 per head);
//   * splits the key rows among 16 lanes of a warp (hd / 16 rows each) and
//     gives each half-warp 2 columns: a thread keeps its rows x 2 columns
//     of S in registers for the whole sequence, so S is read and written
//     once (through shared memory, coalesced) and a step's update is one
//     FMA per element, with no chain between elements.  Of the layouts
//     measured (2 rows x 4 columns over 32 lanes, 8 x 1 over 8 lanes, 8
//     columns a block), this one was fastest;
//   * forms y as sum_i r_i S_ij + v_j * sum_i r_i u_i k_i: a thread sums its
//     rows' share of both, and the shares of 8 steps x 2 columns meet in one
//     reduce-scatter across the 16 lanes (15 shuffles a lane, not 64 for an
//     all-reduce of each), after which each lane owns one y value and
//     stores it; groups run in pairs, so one group's sums meet while the
//     next group computes;
//   * stages r, k, w (every row) and v (the block's columns) 64 steps at a
//     time with 16-byte cp.async into two buffers, so the next chunk loads
//     while this one computes (one barrier a chunk: with one block an SM,
//     32-step chunks, twice the barriers, measured slower); each thread
//     copies fixed pieces, so a copy costs a few instructions; steps past
//     the sequence are staged as w = 1, r = k = v = 0, which leave S as it
//     is, so no step is checked;
//   * leaves the chunked matrix ("linear attention") form for later: its
//     division by cumulative per-channel decays underflows for small w,
//     and TF32 products cannot hold the f32 state to 1e-4.
// A call of fewer than 8 steps (a decode step, hd <= 64) keeps the first
// design: it is all state traffic, which a thread per column reads and
// writes coalesced, with no sum across threads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence.cuh"

namespace {

using rec::from_f32;
using rec::load_run;

constexpr int kRowLanes = 16;      // lanes splitting a head's key rows
constexpr int kCols = 2;           // value columns a thread holds
constexpr int kTile = 16;          // value columns a block holds
constexpr int kThreads = kRowLanes * kTile / kCols;   // 128
constexpr int kGroup = 8;          // steps whose y sums meet
constexpr int kMaxChunk = 64;      // steps staged per round
constexpr int kStages = 2;

// One stage of `len` steps in shared memory, in the inputs' type: r, k
// and w [len][hd] (every row of the head), v [len][kTile] (the block's
// columns).
template <typename T, int kHd>
struct StageView {
  T* r;
  T* k;
  T* w;
  T* v;
  __device__ __forceinline__ StageView(T* base, int len)
      : r(base), k(base + len * kHd), w(base + 2 * len * kHd),
        v(base + 3 * len * kHd) {}
};

// 16 bytes of T(1) / T(0): what a step past the sequence stages for w /
// for r, k and v, so that it leaves S as it is (S <- 1 * S + 0 * v).
template <typename T>
__device__ __forceinline__ uint4 pad16(bool one) {
  const uint32_t w = !one ? 0u
                          : (sizeof(T) == 4 ? 0x3f800000u : 0x3f803f80u);
  return make_uint4(w, w, w, w);
}

// Copies steps t0 .. t0 + len of one (b, h) into a stage; steps past seq
// become pad steps (w = 1, r = k = v = 0).  vec: the four tensors are
// 16-byte aligned, copied with cp.async (the caller commits); otherwise
// element by element.
template <typename T, int kHd>
__device__ __forceinline__ void stage_chunk(
    const StageView<T, kHd>& sv, int len, const T* __restrict__ r,
    const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, size_t base, size_t row, int col0, int t0,
    int seq, bool vec) {
  const int tid = threadIdx.x;
  const int nt = min(len, seq - t0);
  if (vec) {
    // each thread copies one 16-byte piece of every kPass-th step
    constexpr int kPer = 16 / int(sizeof(T));   // elements a copy
    constexpr int kRowCopies = kHd / kPer, kRowPass = kThreads / kRowCopies;
    constexpr int kTileCopies = kTile / kPer;
    constexpr int kTilePass = kThreads / kTileCopies;
    const int c_row = tid / kRowCopies, p_row = tid % kRowCopies * kPer;
    const size_t first = base + size_t(t0 + c_row) * row + p_row;
    auto rows = [&](T* dst, const T* src, bool one) {
      const T* from = src + first;
      for (int c = c_row; c < len; c += kRowPass, from += kRowPass * row) {
        T* to = dst + c * kHd + p_row;
        if (c < nt)
          tc::cp_async16(to, from, true);
        else
          *reinterpret_cast<uint4*>(to) = pad16<T>(one);
      }
    };
    rows(sv.r, r, false);
    rows(sv.k, k, false);
    rows(sv.w, w, true);
    const int c_tile = tid / kTileCopies, p_tile = tid % kTileCopies * kPer;
    const T* from = v + base + size_t(t0 + c_tile) * row + col0 + p_tile;
    for (int c = c_tile; c < len; c += kTilePass, from += kTilePass * row) {
      T* to = sv.v + c * kTile + p_tile;
      if (c < nt)
        tc::cp_async16(to, from, true);
      else
        *reinterpret_cast<uint4*>(to) = pad16<T>(false);
    }
  } else {
    const T zero = from_f32<T>(0.f);
    auto rows = [&](T* dst, const T* src, T pad) {
      for (int e = tid; e < len * kHd; e += kThreads) {
        const int c = e / kHd, i = e - c * kHd;
        dst[c * kHd + i] =
            c < nt ? src[base + size_t(t0 + c) * row + i] : pad;
      }
    };
    rows(sv.r, r, zero);
    rows(sv.k, k, zero);
    rows(sv.w, w, from_f32<T>(1.f));
    for (int e = tid; e < len * kTile; e += kThreads) {
      const int c = e / kTile, j = e - c * kTile;
      sv.v[c * kTile + j] =
          c < nt ? v[base + size_t(t0 + c) * row + col0 + j] : zero;
    }
  }
}

// kGroup steps from step c0 of a staged chunk: each thread updates its
// rows x kCols block of S and leaves its share of y for every step and
// column in acc (pad steps change nothing).
template <typename T, int kHd>
__device__ __forceinline__ void wkv_group(
    const StageView<T, kHd>& sv, int c0, int i0, int jl,
    const float (&uu)[kHd / kRowLanes], float (&st)[kHd / kRowLanes][kCols],
    float (&acc)[kGroup * kCols]) {
  constexpr int kRows = kHd / kRowLanes;
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int c = c0 + u;
    float rr[kRows], kk[kRows], ww[kRows], vv[kCols];
    load_run<kRows>(sv.r + c * kHd + i0, rr);
    load_run<kRows>(sv.k + c * kHd + i0, kk);
    load_run<kRows>(sv.w + c * kHd + i0, ww);
    load_run<kCols>(sv.v + c * kTile + jl, vv);
    float p = 0.f;   // this thread's rows of sum_i r_i u_i k_i
#pragma unroll
    for (int i = 0; i < kRows; ++i) p = fmaf(rr[i] * uu[i], kk[i], p);
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      float a = vv[cc] * p;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        a = fmaf(rr[i], st[i][cc], a);
        st[i][cc] = fmaf(ww[i], st[i][cc], kk[i] * vv[cc]);
      }
      acc[u * kCols + cc] = a;
    }
  }
}

// The shares of y of one group (steps t .. t + kGroup) meet across the
// row lanes; the lane that ends up owning a value stores it, if its step
// is before `end`.
template <typename T>
__device__ __forceinline__ void wkv_store(float (&acc)[kGroup * kCols],
                                          int lane, int t, int end,
                                          T* __restrict__ y, size_t yoff,
                                          size_t row) {
  int first = 0;   // kGroup * kCols sums over 16 lanes: one a lane
  rec::reduce_scatter<kRowLanes, kGroup * kCols>(acc, lane, first);
  const int u = first / kCols, cc = first % kCols;
  if (t + u < end) y[yoff + size_t(t + u) * row + cc] = from_f32<T>(acc[0]);
}

template <typename T, int kHd>
__global__ void __launch_bounds__(kThreads) rwkv6_scan_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ s0, T* __restrict__ y,
    float* __restrict__ s_out, int seq, int heads, int len, int vec) {
  constexpr int kRows = kHd / kRowLanes;   // key rows a thread holds
  constexpr int kTiles = kHd / kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const stage0 = reinterpret_cast<T*>(smem);
  const int stage_elems = len * (3 * kHd + kTile);
  // the block's [hd][kTile] tile of the state, read and written coalesced
  float* const tile_s = reinterpret_cast<float*>(
      smem + size_t(kStages) * stage_elems * sizeof(T));

  const int tile = blockIdx.x % kTiles;
  const int h = blockIdx.x / kTiles;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int i0 = (tid % kRowLanes) * kRows;   // first row (lane bits 0-3)
  const int jl = (tid / kRowLanes) * kCols;   // first column in the tile
  const int col0 = tile * kTile;
  const size_t state = (size_t(b) * heads + h) * kHd * kHd + col0;
  for (int e = tid; e < kHd * kTile; e += kThreads)
    tile_s[e] = s0[state + size_t(e / kTile) * kHd + e % kTile];

  const size_t row = size_t(heads) * kHd;      // stride of one time step
  const size_t base = size_t(b) * seq * row + size_t(h) * kHd;
  const int chunks = (seq + len - 1) / len;
  // kStages - 1 chunks in flight ahead of the one computed
  for (int ci = 0; ci < kStages - 1; ++ci) {
    if (ci < chunks)
      stage_chunk<T, kHd>(StageView<T, kHd>(stage0 + ci * stage_elems, len),
                          len, r, k, v, w, base, row, col0, ci * len, seq,
                          vec);
    tc::cp_async_commit();
  }
  __syncthreads();
  float uu[kRows], st[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    uu[i] = u[h * kHd + i0 + i];
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      st[i][cc] = tile_s[(i0 + i) * kTile + jl + cc];
  }

  // groups run in pairs (a and b), and the y sums of one group meet while
  // the next group computes; b first holds the pair before's second group
  // (steps b_t .., stored up to b_end)
  float acc_a[kGroup * kCols], acc_b[kGroup * kCols] = {};
  int b_t = 0, b_end = 0;
  const size_t yoff = base + col0 + jl;
  for (int ci = 0; ci < chunks; ++ci) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk ci has landed; every thread is past ci - 1
    const int t0 = ci * len;
    const int next = ci + kStages - 1;
    if (next < chunks)
      stage_chunk<T, kHd>(
          StageView<T, kHd>(stage0 + (next % kStages) * stage_elems, len),
          len, r, k, v, w, base, row, col0, next * len, seq, vec);
    tc::cp_async_commit();
    const StageView<T, kHd> sv(stage0 + (ci % kStages) * stage_elems, len);
    const int nt = min(len, seq - t0);
    for (int c0 = 0; c0 < nt; c0 += 2 * kGroup) {
      wkv_group<T, kHd>(sv, c0, i0, jl, uu, st, acc_a);
      wkv_store<T>(acc_b, lane, b_t, b_end, y, yoff, row);
      wkv_group<T, kHd>(sv, c0 + kGroup, i0, jl, uu, st, acc_b);
      wkv_store<T>(acc_a, lane, t0 + c0, seq, y, yoff, row);
      b_t = t0 + c0 + kGroup;
      b_end = seq;
    }
  }
  wkv_store<T>(acc_b, lane, b_t, b_end, y, yoff, row);

  // each thread writes back the tile entries it read
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      tile_s[(i0 + i) * kTile + jl + cc] = st[i][cc];
  __syncthreads();
  for (int e = tid; e < kHd * kTile; e += kThreads)
    s_out[state + size_t(e / kTile) * kHd + e % kTile] = tile_s[e];
}

// A call of fewer than kGroup steps (a decode step) is all state
// traffic: one block of hd threads per (b, h), thread j holding column j
// of S (the first design's layout), so S is read and written coalesced and
// y needs no sum across threads.
template <typename T, int kHd>
__global__ void __launch_bounds__(kHd) rwkv6_scan_short_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ s0, T* __restrict__ y,
    float* __restrict__ s_out, int seq, int heads) {
  __shared__ float r_s[kGroup][kHd];
  __shared__ float k_s[kGroup][kHd];
  __shared__ float w_s[kGroup][kHd];
  __shared__ float v_s[kGroup][kHd];
  __shared__ float u_s[kHd];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;
  const size_t state = (size_t(b) * heads + h) * kHd * kHd;
  float st[kHd];
#pragma unroll
  for (int i = 0; i < kHd; ++i) st[i] = s0[state + size_t(i) * kHd + j];
  u_s[j] = u[h * kHd + j];
  const size_t row = size_t(heads) * kHd;      // stride of one time step
  const size_t base = size_t(b) * seq * row + size_t(h) * kHd + j;
  for (int c = 0; c < seq; ++c) {
    const size_t off = base + size_t(c) * row;
    r_s[c][j] = rec::to_f32(r[off]);
    k_s[c][j] = rec::to_f32(k[off]);
    w_s[c][j] = rec::to_f32(w[off]);
    v_s[c][j] = rec::to_f32(v[off]);
  }
  __syncthreads();
  for (int c = 0; c < seq; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kHd; ++i) {
      const float kv = k_s[c][i] * v_s[c][j];
      acc = fmaf(r_s[c][i], st[i] + u_s[i] * kv, acc);
      st[i] = fmaf(w_s[c][i], st[i], kv);
    }
    y[base + size_t(c) * row] = from_f32<T>(acc);
  }
#pragma unroll
  for (int i = 0; i < kHd; ++i) s_out[state + size_t(i) * kHd + j] = st[i];
}

template <typename T, int kHd>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* s_out, int batch, int seq, int heads,
                   cudaStream_t stream) {
  // (hd 128's column of S does not fit a thread's registers)
  if constexpr (kHd <= 64) {
    if (seq < kGroup) {
      rwkv6_scan_short_kernel<T, kHd><<<dim3(heads, batch), kHd, 0, stream>>>(
          static_cast<const T*>(r), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(w),
          static_cast<const float*>(u), static_cast<const float*>(s0),
          static_cast<T*>(y), static_cast<float*>(s_out), seq, heads);
      return cudaGetLastError();
    }
  }
  // steps a stage holds: a whole chunk, or a short call rounded up to a
  // pair of groups (at hd 128 in f32 two whole stages and the state tile
  // take 208 KB)
  constexpr int kPair = 2 * kGroup;
  const int len =
      seq >= kMaxChunk ? kMaxChunk : (seq + kPair - 1) / kPair * kPair;
  const size_t smem = size_t(kStages) * len * (3 * kHd + kTile) * sizeof(T) +
                      size_t(kHd) * kTile * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_scan_kernel<T, kHd>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const int vec = ((reinterpret_cast<uintptr_t>(r) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(w)) % 16) == 0;
  const dim3 grid(heads * (kHd / kTile), batch);
  rwkv6_scan_kernel<T, kHd><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_out), seq, heads, len, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0, void* y,
                     void* s_out, int batch, int seq, int heads, int hd,
                     cudaStream_t stream) {
#define WKV_LAUNCH(HD)                                                  \
  return launch<T, HD>(r, k, v, w, u, s0, y, s_out, batch, seq, heads, \
                       stream)
  if (hd == 16) WKV_LAUNCH(16);
  if (hd == 32) WKV_LAUNCH(32);
  if (hd == 64) WKV_LAUNCH(64);
  if (hd == 128) WKV_LAUNCH(128);
#undef WKV_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes shared with kernel.py: 0 float32, 1 bfloat16 (r, k, v, w, y).
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_out, int batch, int seq,
                          int heads, int hd, int dtype,
                          void* stream_handle) {
  cudaGetLastError();  // start from a clean error state
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (dtype == 0)
    return int(dispatch<float>(r, k, v, w, u, s0, y, s_out, batch, seq,
                               heads, hd, stream));
  if (dtype == 1)
    return int(dispatch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, batch,
                                       seq, heads, hd, stream));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* rwkv6_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
