// RWKV-6 WKV recurrence backward, for Hopper (sm_90a).
//
// The gradient of rwkv6_scan.cu (the port of the TPU kernel
//   src/repro/kernels/rwkv6_scan/kernel.py::rwkv6_scan).
// The TPU path has no backward kernel: JAX differentiates the lax.scan of
// src/repro/models/rwkv.py:118.  Per (batch, head), with the f32 state
// S [hd, hd] (row i key, column j value) of the forward
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
// the adjoint G_t = dL/dS_t starts at ds_final and runs
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T
// and the gradients are
//   dr_t[i] = sum_j S_{t-1}[i][j] dy_t[j] + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G_t[i][j] v_t[j] + u[i] r_t[i] (v_t . dy_t)
//   dv_t[j] = sum_i G_t[i][j] k_t[i] + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]   = sum_{b,t} r_t[i] k_t[i] (v_t . dy_t),   ds0 = G_0.
// Every input and output is f32 (the model casts r, k, v to f32 before the
// scan).
//
// What bounds it on an H100: at the RWKV-6 1.6B training shape (B 2,
// S 4096, 32 heads of 64) the nine [B,S,H,hd] tensors are 604 MB (0.18 ms
// at 3.35 TB/s) against ~12 f32 operations per state element and step over
// 1.07 G element-steps (0.19 ms at 67 TFLOP/s); the recurrence is
// sequential in t, in both directions.
//
// The hard part is that dw_t needs S_{t-1} and G_t at the same step, and S
// cannot be run backward: S_{t-1} = (S_t - k v^T) / w divides by a w that
// underflows to 0 (w = exp(-exp(w_log)) for w_log >~ 4.5).  So S is
// recomputed forward from checkpoints, in three levels:
//   * wkv_bwd_ckpt_kernel runs the forward recurrence once and writes S at
//     the start of every 32-step chunk to global memory (16 KB per chunk
//     and head at hd 64: 134 MB at the training shape, not the 4.3 GB of
//     every state);
//   * wkv_bwd_kernel walks the chunks backward.  For each it stages the
//     chunk's r, k, w (every row) and v, dy (the block's columns) in shared
//     memory (16-byte cp.async into two buffers, the next chunk landing
//     while this one computes, as in the forward), reruns the chunk
//     forward from its checkpoint and keeps S at
//     the start of every kSub-step sub-chunk in shared memory (each thread
//     its own elements, so no barrier guards them), then walks the
//     sub-chunks backward: rerun kSub steps forward into registers (the
//     history, fully unrolled), then kSub steps backward with G in
//     registers;
//   * the block and thread layout is the forward's: a block holds 16 value
//     columns of one head (128 threads), a thread hd / 16 key rows x 2
//     columns of S and of G, so both recurrences are one FMA per element
//     and step.
// The sums: dv sums over rows, across the 16 lanes that split them, in one
// reduce-scatter per sub-chunk (as the forward forms y).  dr, dk and dw sum
// over columns: two column pairs meet in a shuffle, the 4 warps in shared
// memory, and the hd / 16 column tiles (blocks) through a per-tile partial
// in global memory that wkv_bwd_finish_kernel sums in a fixed order; it
// also adds the u terms (which need v . dy over every column) and forms
// per-block shares of du, which wkv_sum_parts_kernel sums in a fixed order.
// No atomics: every run gives the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence.cuh"

namespace {

using rec::load_run;

constexpr int kRowLanes = 16;      // lanes splitting a head's key rows
constexpr int kCols = 2;           // value columns a thread holds
constexpr int kTile = 16;          // value columns a block holds
constexpr int kThreads = kRowLanes * kTile / kCols;   // 128
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;         // steps between checkpoints / staged
constexpr int kFinishThreads = 256;
constexpr int kFinishWarps = kFinishThreads / 32;
constexpr int kFinishSteps = 64;   // steps a finishing block takes

template <int kHd>
struct Geo {
  static constexpr int kRows = kHd / kRowLanes;  // key rows a thread holds
  static constexpr int kSub = kHd <= 64 ? 8 : 4; // steps of register history
  static constexpr int kSubs = kChunk / kSub;
  static constexpr int kTiles = kHd / kTile;
  // shared memory, in floats: the staged chunk, the row sums of a
  // sub-chunk [kSub][kWarps][3][hd], the sub-chunk starts
  // [kSubs][kRows * kCols][kThreads]
  static constexpr int kStage = 3 * kChunk * kHd + 2 * kChunk * kTile;
  static constexpr int kRed = kSub * kWarps * 3 * kHd;
  static constexpr int kStarts = kSubs * kRows * kCols * kThreads;
};

// One staged chunk in shared memory: r, k, w [kChunk][hd] (every row of
// the head), v and dy [kChunk][kTile] (the block's columns).
template <int kHd>
struct StageView {
  float* r;
  float* k;
  float* w;
  float* v;
  float* dy;
  __device__ __forceinline__ explicit StageView(float* base)
      : r(base), k(base + kChunk * kHd), w(base + 2 * kChunk * kHd),
        v(base + 3 * kChunk * kHd), dy(base + 3 * kChunk * kHd +
                                       kChunk * kTile) {}
};

__device__ __forceinline__ void fill4(float* p, float x) {
  *reinterpret_cast<float4*>(p) = make_float4(x, x, x, x);
}

// Starts copying steps t0 .. t0 + kChunk of one (b, h) into a stage (the
// caller commits the cp.async group): k, w (and r) every row, v (and dy)
// the block's columns.  Steps past seq become pad steps (w = 1, the rest
// 0), which leave S and G as they are.  vec: the tensors are 16-byte
// aligned, copied 16 bytes at a time with cp.async; otherwise loaded
// element by element (synchronously).
template <int kHd, bool kBack>
__device__ __forceinline__ void stage(const StageView<kHd>& sv,
                                      const float* __restrict__ r,
                                      const float* __restrict__ k,
                                      const float* __restrict__ v,
                                      const float* __restrict__ w,
                                      const float* __restrict__ dy,
                                      size_t base, size_t row, int col0,
                                      int t0, int seq, bool vec) {
  const int nt = min(kChunk, seq - t0);
  if (vec) {
    constexpr int kRowPieces = kHd / 4, kTilePieces = kTile / 4;
    for (int e = threadIdx.x; e < kChunk * kRowPieces; e += kThreads) {
      const int c = e / kRowPieces, o = c * kHd + (e - c * kRowPieces) * 4;
      const size_t off = base + size_t(t0 + c) * row + (o - c * kHd);
      if (c < nt) {
        tc::cp_async16(sv.k + o, k + off, true);
        tc::cp_async16(sv.w + o, w + off, true);
        if constexpr (kBack) tc::cp_async16(sv.r + o, r + off, true);
      } else {
        fill4(sv.k + o, 0.f);
        fill4(sv.w + o, 1.f);
        if constexpr (kBack) fill4(sv.r + o, 0.f);
      }
    }
    for (int e = threadIdx.x; e < kChunk * kTilePieces; e += kThreads) {
      const int c = e / kTilePieces, p = (e - c * kTilePieces) * 4;
      const int o = c * kTile + p;
      const size_t off = base + size_t(t0 + c) * row + col0 + p;
      if (c < nt) {
        tc::cp_async16(sv.v + o, v + off, true);
        if constexpr (kBack) tc::cp_async16(sv.dy + o, dy + off, true);
      } else {
        fill4(sv.v + o, 0.f);
        if constexpr (kBack) fill4(sv.dy + o, 0.f);
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < kChunk * kHd; e += kThreads) {
    const int c = e / kHd, i = e - c * kHd;
    const bool live = c < nt;
    const size_t off = base + size_t(t0 + c) * row + i;
    sv.k[e] = live ? k[off] : 0.f;
    sv.w[e] = live ? w[off] : 1.f;
    if constexpr (kBack) sv.r[e] = live ? r[off] : 0.f;
  }
  for (int e = threadIdx.x; e < kChunk * kTile; e += kThreads) {
    const int c = e / kTile, j = e - c * kTile;
    const bool live = c < nt;
    const size_t off = base + size_t(t0 + c) * row + col0 + j;
    sv.v[e] = live ? v[off] : 0.f;
    if constexpr (kBack) sv.dy[e] = live ? dy[off] : 0.f;
  }
}

// S <- diag(w_c) S + k_c v_c^T on a thread's rows x columns, from step c of
// a staged chunk (the forward kernel's rounding: fmaf(w, S, k * v)).
template <int kHd>
__device__ __forceinline__ void advance(const StageView<kHd>& sv, int c,
                                        int i0, int jl,
                                        float (&st)[kHd / kRowLanes][kCols]) {
  constexpr int kRows = kHd / kRowLanes;
  float kk[kRows], ww[kRows], vv[kCols];
  load_run<kRows>(sv.k + c * kHd + i0, kk);
  load_run<kRows>(sv.w + c * kHd + i0, ww);
  load_run<kCols>(sv.v + c * kTile + jl, vv);
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      st[i][cc] = fmaf(ww[i], st[i][cc], kk[i] * vv[cc]);
}

// A thread's rows x columns of a [hd, hd] state at m.
template <int kHd>
__device__ __forceinline__ void load_tile(
    const float* m, int i0, int col, float (&st)[kHd / kRowLanes][kCols]) {
#pragma unroll
  for (int i = 0; i < kHd / kRowLanes; ++i) {
    const float2 q =
        *reinterpret_cast<const float2*>(m + size_t(i0 + i) * kHd + col);
    st[i][0] = q.x;
    st[i][1] = q.y;
  }
}

template <int kHd>
__device__ __forceinline__ void store_tile(
    float* m, int i0, int col, const float (&st)[kHd / kRowLanes][kCols]) {
#pragma unroll
  for (int i = 0; i < kHd / kRowLanes; ++i)
    *reinterpret_cast<float2*>(m + size_t(i0 + i) * kHd + col) =
        make_float2(st[i][0], st[i][1]);
}

// Pass 1: the forward recurrence from s0, writing S at the start of every
// chunk to ckpt [B, H, chunks, hd, hd]; the next chunk stages while this
// one computes.
template <int kHd>
__global__ void __launch_bounds__(kThreads) wkv_bwd_ckpt_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ s0,
    float* __restrict__ ckpt, int seq, int heads, int vec) {
  using G = Geo<kHd>;
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x % G::kTiles;
  const int h = blockIdx.x / G::kTiles;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int i0 = (tid % kRowLanes) * G::kRows;
  const int jl = (tid / kRowLanes) * kCols;
  const int col = tile * kTile + jl;
  const size_t bh = size_t(b) * heads + h;
  const size_t row = size_t(heads) * kHd;
  const size_t base = size_t(b) * seq * row + size_t(h) * kHd;
  const int chunks = (seq + kChunk - 1) / kChunk;
  auto view = [&](int ci) {
    return StageView<kHd>(smem + (ci % 2) * G::kStage);
  };
  stage<kHd, false>(view(0), nullptr, k, v, w, nullptr, base, row,
                    tile * kTile, 0, seq, vec);
  tc::cp_async_commit();
  float st[G::kRows][kCols];
  load_tile<kHd>(s0 + bh * kHd * kHd, i0, col, st);
  for (int ci = 0; ci < chunks; ++ci) {
    store_tile<kHd>(ckpt + (bh * chunks + ci) * kHd * kHd, i0, col, st);
    __syncthreads();   // chunk ci - 1 is done with; its stage takes ci + 1
    if (ci + 1 < chunks)
      stage<kHd, false>(view(ci + 1), nullptr, k, v, w, nullptr, base, row,
                        tile * kTile, (ci + 1) * kChunk, seq, vec);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();   // chunk ci has landed
    const StageView<kHd> sv = view(ci);
    for (int c = 0; c < kChunk; ++c) advance<kHd>(sv, c, i0, jl, st);
  }
}

// Pass 2: the chunks backward (see the note at the top).  Writes dv without
// its u term, the per-tile partial row sums part [tiles][3][B*S*H*hd] (dr
// without its u term, dk without its u term, dw) and ds0.
template <int kHd>
__global__ void __launch_bounds__(kThreads) wkv_bwd_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ dy, const float* __restrict__ ds_final,
    const float* __restrict__ ckpt, float* __restrict__ part,
    float* __restrict__ dv, float* __restrict__ ds0, int batch, int seq,
    int heads, int vec) {
  using G = Geo<kHd>;
  constexpr int kRows = G::kRows, kSub = G::kSub;
  constexpr int kV = kSub * kCols;   // dv shares of a sub-chunk
  constexpr int kOwn = kV >= kRowLanes ? kV / kRowLanes : 1;
  extern __shared__ __align__(16) float smem[];
  float* const red = smem + 2 * G::kStage;
  float* const starts = red + G::kRed;
  auto view = [&](int ci) {
    return StageView<kHd>(smem + (ci % 2) * G::kStage);
  };

  const int tile = blockIdx.x % G::kTiles;
  const int h = blockIdx.x / G::kTiles;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int i0 = (tid % kRowLanes) * kRows;
  const int jl = (tid / kRowLanes) * kCols;
  const int col0 = tile * kTile;
  const size_t bh = size_t(b) * heads + h;
  const size_t row = size_t(heads) * kHd;
  const size_t base = size_t(b) * seq * row + size_t(h) * kHd;
  const size_t plane = size_t(batch) * seq * row;
  const int chunks = (seq + kChunk - 1) / kChunk;

  float g[kRows][kCols];
  load_tile<kHd>(ds_final + bh * kHd * kHd, i0, col0 + jl, g);
  stage<kHd, true>(view(chunks - 1), r, k, v, w, dy, base, row, col0,
                   (chunks - 1) * kChunk, seq, vec);
  tc::cp_async_commit();
  for (int ci = chunks - 1; ci >= 0; --ci) {
    const int t0 = ci * kChunk;
    __syncthreads();   // chunk ci + 1 is done with; its stage takes ci - 1
    if (ci > 0)
      stage<kHd, true>(view(ci - 1), r, k, v, w, dy, base, row, col0,
                       t0 - kChunk, seq, vec);
    tc::cp_async_commit();
    float st[kRows][kCols];
    load_tile<kHd>(ckpt + (bh * chunks + ci) * kHd * kHd, i0, col0 + jl, st);
    tc::cp_async_wait<1>();
    __syncthreads();   // chunk ci has landed
    const StageView<kHd> sv = view(ci);
    // S at the start of every sub-chunk, each thread its own elements
    for (int sc = 0; sc < G::kSubs; ++sc) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          starts[((sc * kRows + i) * kCols + cc) * kThreads + tid] =
              st[i][cc];
#pragma unroll
      for (int u = 0; u < kSub; ++u)
        advance<kHd>(sv, sc * kSub + u, i0, jl, st);
    }
    for (int sc = G::kSubs - 1; sc >= 0; --sc) {
      float hist[kSub][kRows][kCols];   // S_{t-1} of the sub-chunk's steps
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          st[i][cc] = starts[((sc * kRows + i) * kCols + cc) * kThreads + tid];
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) hist[u][i][cc] = st[i][cc];
        if (u + 1 < kSub) advance<kHd>(sv, sc * kSub + u, i0, jl, st);
      }
      float acc[kV];   // this thread's rows of dv, by step and column
#pragma unroll
      for (int u = kSub - 1; u >= 0; --u) {
        const int c = sc * kSub + u;
        float rr[kRows], kk[kRows], ww[kRows], vv[kCols], dd[kCols];
        load_run<kRows>(sv.r + c * kHd + i0, rr);
        load_run<kRows>(sv.k + c * kHd + i0, kk);
        load_run<kRows>(sv.w + c * kHd + i0, ww);
        load_run<kCols>(sv.v + c * kTile + jl, vv);
        load_run<kCols>(sv.dy + c * kTile + jl, dd);
        float sums[3][kRows];   // dr, dk, dw over this thread's columns
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            pr = fmaf(hist[u][i][cc], dd[cc], pr);
            pk = fmaf(g[i][cc], vv[cc], pk);
            pw = fmaf(g[i][cc], hist[u][i][cc], pw);
          }
          sums[0][i] = pr;
          sums[1][i] = pk;
          sums[2][i] = pw;
        }
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < kRows; ++i) a = fmaf(g[i][cc], kk[i], a);
          acc[u * kCols + cc] = a;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc)
            g[i][cc] = fmaf(ww[i], g[i][cc], rr[i] * dd[cc]);
        // the warp's two column pairs (lanes l and l + 16) meet; lanes
        // 0-15 leave the warp's sums for the block's
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            sums[q][i] += __shfl_xor_sync(0xffffffffu, sums[q][i], 16);
        if (lane < 16) {
#pragma unroll
          for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int i = 0; i < kRows; ++i)
              red[((u * kWarps + warp) * 3 + q) * kHd + i0 + i] = sums[q][i];
        }
      }
      // dv: the row shares of the sub-chunk meet across the row lanes
      int first = 0;
      rec::reduce_scatter<kRowLanes, kV>(acc, lane, first);
      if (rec::owns_sum<kRowLanes, kV>(lane)) {
#pragma unroll
        for (int q = 0; q < kOwn; ++q) {
          const int e = first + q, u = e / kCols, cc = e % kCols;
          const int t = t0 + sc * kSub + u;
          if (t < seq) dv[base + size_t(t) * row + col0 + jl + cc] = acc[q];
        }
      }
      __syncthreads();   // the sub-chunk's row sums are in red
      for (int e = tid; e < kSub * 3 * kHd; e += kThreads) {
        const int u = e / (3 * kHd), rem = e - u * 3 * kHd;
        const int q = rem / kHd, i = rem - q * kHd;
        float s = 0.f;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp)
          s += red[((u * kWarps + wp) * 3 + q) * kHd + i];
        const int t = t0 + sc * kSub + u;
        if (t < seq)
          part[(size_t(tile) * 3 + q) * plane + base + size_t(t) * row + i] =
              s;
      }
      __syncthreads();   // red is free for the next sub-chunk
    }
  }
  store_tile<kHd>(ds0 + bh * kHd * kHd, i0, col0 + jl, g);
}

// Pass 3, per (b, h, 64-step slab), a warp a step: sums the column tiles'
// partials, adds the u terms (q = v . dy and p = sum_i r u k over the
// whole head) and leaves the slab's share of du in du_part
// [B * slabs][H][hd].
template <int kHd>
__global__ void __launch_bounds__(kFinishThreads) wkv_bwd_finish_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dy,
    const float* __restrict__ u, const float* __restrict__ part,
    float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dw,
    float* __restrict__ dv, float* __restrict__ du_part, int batch, int seq,
    int heads) {
  constexpr int kPer = (kHd + 31) / 32;   // entries a lane holds
  constexpr int kTiles = kHd / kTile;
  __shared__ float red[kFinishWarps][kHd];
  const int slab = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t row = size_t(heads) * kHd;
  const size_t plane = size_t(batch) * seq * row;
  float uu[kPer], du[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int i = lane + 32 * m;
    uu[m] = i < kHd ? u[h * kHd + i] : 0.f;
    du[m] = 0.f;
  }
  const int end = min(seq, (slab + 1) * kFinishSteps);
  for (int t = slab * kFinishSteps + warp; t < end; t += kFinishWarps) {
    const size_t off = (size_t(b) * seq + t) * row + size_t(h) * kHd;
    float rr[kPer], kk[kPer], vv[kPer], dd[kPer];
    float q = 0.f, p = 0.f;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int i = lane + 32 * m;
      const bool on = i < kHd;
      rr[m] = on ? r[off + i] : 0.f;
      kk[m] = on ? k[off + i] : 0.f;
      vv[m] = on ? v[off + i] : 0.f;
      dd[m] = on ? dy[off + i] : 0.f;
      q = fmaf(vv[m], dd[m], q);
      p = fmaf(rr[m] * uu[m], kk[m], p);
    }
#pragma unroll
    for (int s = 16; s >= 1; s /= 2) {
      q += __shfl_xor_sync(0xffffffffu, q, s);
      p += __shfl_xor_sync(0xffffffffu, p, s);
    }
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int i = lane + 32 * m;
      if (i >= kHd) continue;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int tl = 0; tl < kTiles; ++tl) {
        const float* pt = part + size_t(tl) * 3 * plane + off + i;
        s0 += pt[0];
        s1 += pt[plane];
        s2 += pt[2 * plane];
      }
      dr[off + i] = fmaf(uu[m] * kk[m], q, s0);
      dk[off + i] = fmaf(uu[m] * rr[m], q, s1);
      dw[off + i] = s2;
      dv[off + i] = fmaf(p, dd[m], dv[off + i]);
      du[m] = fmaf(rr[m] * kk[m], q, du[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int i = lane + 32 * m;
    if (i < kHd) red[warp][i] = du[m];
  }
  __syncthreads();
  const int slabs = gridDim.x;
  for (int i = threadIdx.x; i < kHd; i += kFinishThreads) {
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < kFinishWarps; ++wp) s += red[wp][i];
    du_part[((size_t(b) * slabs + slab) * heads + h) * kHd + i] = s;
  }
}

// out[e] = sum over p of parts[p][e], in the order of p.
__global__ void wkv_sum_parts_kernel(const float* __restrict__ parts,
                                     float* __restrict__ out, int nparts,
                                     int count) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += parts[size_t(p) * count + e];
  out[e] = s;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <int kHd>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0,
                   const float* dy, const float* ds_final, float* ckpt,
                   float* part, float* du_part, float* dr, float* dk,
                   float* dv, float* dw, float* du, float* ds0, int batch,
                   int seq, int heads, cudaStream_t stream) {
  using G = Geo<kHd>;
  const dim3 grid(heads * G::kTiles, batch);
  const size_t smem_ckpt = 2 * G::kStage * sizeof(float);
  const size_t smem_bwd = (2 * G::kStage + G::kRed + G::kStarts) *
                          sizeof(float);
  // 16-byte copies need 16-byte aligned rows (hd and the column tiles are
  // multiples of 4 floats)
  const int vec = ((reinterpret_cast<uintptr_t>(r) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(w) |
                    reinterpret_cast<uintptr_t>(dy)) % 16) == 0;
  cudaError_t err = allow_smem(wkv_bwd_ckpt_kernel<kHd>, smem_ckpt);
  if (err == cudaSuccess) err = allow_smem(wkv_bwd_kernel<kHd>, smem_bwd);
  if (err != cudaSuccess) return err;
  wkv_bwd_ckpt_kernel<kHd><<<grid, kThreads, smem_ckpt, stream>>>(
      k, v, w, s0, ckpt, seq, heads, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wkv_bwd_kernel<kHd><<<grid, kThreads, smem_bwd, stream>>>(
      r, k, v, w, dy, ds_final, ckpt, part, dv, ds0, batch, seq, heads, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int slabs = (seq + kFinishSteps - 1) / kFinishSteps;
  wkv_bwd_finish_kernel<kHd>
      <<<dim3(slabs, heads, batch), kFinishThreads, 0, stream>>>(
          r, k, v, dy, u, part, dr, dk, dw, dv, du_part, batch, seq, heads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int count = heads * kHd;
  wkv_sum_parts_kernel<<<(count + 255) / 256, 256, 0, stream>>>(
      du_part, du, batch * slabs, count);
  return cudaGetLastError();
}

}  // namespace

// All pointers f32 and contiguous: r, k, v, w, dy, dr, dk, dv, dw
// [B,S,H,hd]; u, du [H,hd]; s0, ds_final, ds0 [B,H,hd,hd]; scratch
// ckpt [B,H,ceil(S/32),hd,hd], part [hd/16][3][B,S,H,hd],
// du_part [B * ceil(S/64)][H][hd].  seq >= 1.
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              const void* dy, const void* ds_final,
                              void* ckpt, void* part, void* du_part,
                              void* dr, void* dk, void* dv, void* dw,
                              void* du, void* ds0, int batch, int seq,
                              int heads, int hd, void* stream_handle) {
  cudaGetLastError();  // start from a clean error state
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
#define WKV_BWD(HD)                                                        \
  return int(launch<HD>(                                                   \
      static_cast<const float*>(r), static_cast<const float*>(k),          \
      static_cast<const float*>(v), static_cast<const float*>(w),          \
      static_cast<const float*>(u), static_cast<const float*>(s0),         \
      static_cast<const float*>(dy), static_cast<const float*>(ds_final),  \
      static_cast<float*>(ckpt), static_cast<float*>(part),                \
      static_cast<float*>(du_part), static_cast<float*>(dr),               \
      static_cast<float*>(dk), static_cast<float*>(dv),                    \
      static_cast<float*>(dw), static_cast<float*>(du),                    \
      static_cast<float*>(ds0), batch, seq, heads, stream))
  if (hd == 16) WKV_BWD(16);
  if (hd == 32) WKV_BWD(32);
  if (hd == 64) WKV_BWD(64);
  if (hd == 128) WKV_BWD(128);
#undef WKV_BWD
  return int(cudaErrorInvalidValue);
}

extern "C" const char* rwkv6_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
