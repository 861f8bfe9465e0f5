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
//   dr_t[i] = sum_j S_{t-1}[i][j] dy_t[j] + u[i] k_t[i] q_t
//   dk_t[i] = sum_j G_t[i][j] v_t[j] + u[i] r_t[i] q_t
//   dv_t[j] = sum_i G_t[i][j] k_t[i] + p_t dy_t[j]
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]   = sum_{b,t} r_t[i] k_t[i] q_t,   ds0 = G_0,
// with q_t = v_t . dy_t and p_t = sum_i r_t[i] u[i] k_t[i].  Every input
// and output is f32 (the model casts r, k, v to f32 before the scan).
//
// What bounds it on an H100: at the RWKV-6 1.6B training shape (B 2,
// S 4096, 32 heads of 64) the nine [B,S,H,hd] tensors are 604 MB (0.18 ms
// at 3.35 TB/s) against ~12 f32 operations per state element and step over
// 1.07 G element-steps (0.19 ms at 67 TFLOP/s).  But the recurrence is
// sequential in t, in both directions, and a step of a head is only 4096
// elements: the time goes to issuing each step's instructions (the FMAs,
// and the shuffles that sum across lanes) and to the barriers that meet
// across blocks, 4096 times over.
//
// dw_t needs S_{t-1} and G_t at the same step, and S cannot be run
// backward: S_{t-1} = (S_t - k v^T) / w divides by a w that underflows to 0
// (w = exp(-exp(w_log)) for w_log >~ 4.5).  So S is recomputed forward
// from checkpoints of S every 32 steps (16 KB per checkpoint and head at
// hd 64: 134 MB at the training shape), then per 32-step chunk from its
// checkpoint to the start of every kSub-step sub-chunk, then per sub-chunk
// into registers (the history), which the steps walk backward with G in
// registers.
//
// The design before this one (the forward's layout: a block of 16 value
// columns, hd / 16 blocks a head, each staging every key row) took 2.6027
// ms a call at the training shape on an H100 80GB HBM3 at 700 W, in four
// kernels: the checkpoint pass 0.3503 ms, the backward pass 1.7482, a
// finishing pass 0.4927 and the du sum 0.0063.  dr, dk and dw sum over
// columns, so each column tile wrote its share of them to HBM (805 MB at
// the training shape) for the finishing pass to sum and to add the u
// terms; its backward step issued ~152 instructions a thread for 8
// elements, with two block barriers every 8 steps.
//
// This design: one kernel, one thread-block cluster per (batch row,
// head), whose blocks each own kRows key rows and every value column
// (kRows = 32 at hd 64: 2 blocks of 256 threads; 16 otherwise: 1, 2 and 8
// blocks at hd 16, 32 and 128).  A thread holds 2 rows x hd / 16 columns.
//   * dr, dk, dw sum over columns, so they are complete in the block: the
//     16 lanes of a half-warp split the columns, and each sub-chunk's sums
//     meet in one reduce-scatter (rec::reduce_scatter) after which each
//     lane owns 3 of them and stores them with their u terms, which a
//     pass over the staged chunk computes beforehand (q_t, u k q, u r q).
//     No partials leave the block and there is no finishing pass;
//   * dv sums over rows, so it crosses blocks.  A warp's two row groups
//     meet in a shuffle and each warp leaves its share in shared memory,
//     with the block's share of p_t dy_t added once; after a cluster
//     barrier each block sums the shares of its kRows columns from every
//     block's warps through distributed shared memory (mapa +
//     ld.shared::cluster) and stores dv.  The shares are exchanged once a
//     32-step chunk at hd <= 64 (two chunks of shares fit beside the rest:
//     229.5 KB at hd 64), once a sub-chunk at hd 128, and summed during
//     the next exchange's sub-chunks, so the barrier's wait comes a whole
//     exchange after its arrive.  The buffer is double-buffered, so one
//     barrier an exchange suffices: a block writes buffer m % 2 only after
//     every block has arrived at barrier m - 1, which each does after
//     summing buffer (m - 2) % 2.  The barrier's release compiles to a
//     GPU-wide memory fence (MEMBAR.ALL.GPU), which is most of what a
//     barrier costs, hence one a chunk;
//   * the forward pass that writes the checkpoints runs in the same
//     kernel, each thread writing and later reading only its own elements,
//     with its k, w, v staged 3 chunks ahead in a ring of 4 and each chunk
//     unrolled whole, so its loads are hoisted;
//   * a block stages only its own rows of r, k and w (v and dy in full),
//     32 steps at a time with 16-byte cp.async into two buffers;
//   * du's share per (b, h) stays in registers over t; the B shares are
//     summed by wkv_sum_parts_kernel.
// At hd 64, fewer than 64 clusters of 4 blocks of 16 rows fit on an H100
// at once, so the training shape's 64 (b, h) ran in two waves; 2 blocks
// of 32 rows fit 66.  launch/profile_wkv_bwd.py --variants times these
// choices against the source as it stands.
// Every sum is taken in a fixed order (ranks, then warps, then lanes by
// the reduce-scatter's fixed pairing) and there are no atomics: two calls
// give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "recurrence.cuh"

namespace {

using rec::load_run;

constexpr int kR = 2;              // key rows a thread holds
constexpr int kColLanes = 16;      // lanes splitting the value columns
constexpr int kChunk = 32;         // steps between checkpoints / staged

// key rows a block owns, by head width: at hd 64 a cluster of 4 blocks of
// 16 rows fits 62 times on an H100 (237 registers: 2 blocks an SM), so the
// training shape's 64 (b, h) would run in two waves; 2 blocks of 32 rows
// (256 threads, one block an SM) fit 66 times
template <int kHd>
struct Pick {
  static constexpr int kRows = kHd == 64 ? 32 : 16;
};

template <int kHd>
struct Geo {
  static constexpr int kRows = Pick<kHd>::kRows;
  static constexpr int kThreads = 8 * kRows;     // 2 row groups a warp
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRanks = kHd / kRows;     // blocks of a cluster
  // the u-term pass: kPer threads a step, 4 rows each
  static constexpr int kPer = kThreads / kChunk;
  static constexpr int kC = kHd / kColLanes;     // value columns a thread
  static constexpr int kElts = kR * kC;
  static constexpr int kSub = kHd <= 64 ? 8 : 4; // steps of register history
  static constexpr int kSubs = kChunk / kSub;
  // dr, dk, dw sums of a sub-chunk, (step, quantity, row), padded to the
  // 16 lanes' reduce-scatter
  static constexpr int kV = kSub * 3 * kR;
  static constexpr int kVp = (kV + kColLanes - 1) / kColLanes * kColLanes;
  // steps between exchanges of dv shares: a chunk, where two chunks of
  // the warps' shares fit in shared memory beside the rest (hd <= 64);
  // else a sub-chunk
  static constexpr int kXSteps = kHd <= 64 ? kChunk : kSub;
  static constexpr int kGroup = kXSteps / kSub;   // sub-chunks an exchange
  // shared memory, in floats: two staged chunks, the dv exchange
  // [2][kWarps][kXSteps][hd], the block's share of p_t [kChunk], the u
  // terms of dr and dk [kChunk][kRows] each, the sub-chunk starts
  // [kSubs][kElts][kThreads]
  static constexpr int kStage = kChunk * (3 * kRows + 2 * kHd);
  static constexpr int kXchOff = 2 * kStage;
  static constexpr int kPtOff = kXchOff + 2 * kWarps * kXSteps * kHd;
  static constexpr int kBrOff = kPtOff + kChunk;
  static constexpr int kBkOff = kBrOff + kChunk * kRows;
  static constexpr int kStartsOff = kBkOff + kChunk * kRows;
  static constexpr int kSmem = kStartsOff + kSubs * kElts * kThreads;
  // the forward stages k, w and v only, into a ring of 4 over the same
  // memory: [kChunk][kRows] twice, [kChunk][hd]
  static constexpr int kFwd = kChunk * (2 * kRows + kHd);
  static constexpr int kFwdBufs = 4;
  static_assert(kFwdBufs * kFwd <= kSmem, "the forward's ring fits");
  static_assert(kSub * kRows <= kThreads, "one dv sum a thread at most");
  static_assert(kSmem * 4 <= 232448, "shared memory of one block");
  static_assert(kSub * kC % 2 == 0, "dv shares halve across row groups");
  static_assert(kPer * 4 == kRows, "the u-term pass: 4 rows a thread");
};

// One staged chunk in shared memory: r, k, w [kChunk][kRows] (the block's
// rows), v and dy [kChunk][hd] (every column).
template <int kHd>
struct StageView {
  static constexpr int kRows = Geo<kHd>::kRows;
  float* r;
  float* k;
  float* w;
  float* v;
  float* dy;
  __device__ __forceinline__ explicit StageView(float* base)
      : r(base), k(base + kChunk * kRows), w(base + 2 * kChunk * kRows),
        v(base + 3 * kChunk * kRows),
        dy(base + 3 * kChunk * kRows + kChunk * kHd) {}
  // the forward's stage: k, w and v only
  __device__ __forceinline__ static StageView forward(float* base) {
    StageView sv(base);
    sv.r = sv.dy = nullptr;
    sv.k = base;
    sv.w = base + kChunk * kRows;
    sv.v = base + 2 * kChunk * kRows;
    return sv;
  }
};

__device__ __forceinline__ void fill4(float* p, float x) {
  *reinterpret_cast<float4*>(p) = make_float4(x, x, x, x);
}

// Starts copying steps t0 .. t0 + kChunk of one (b, h) into a stage (the
// caller commits the cp.async group): k, w (and r) the block's rows
// row0 .. row0 + kRows, v (and dy) every column.  Steps past seq become pad
// steps (w = 1, the rest 0), which leave S and G as they are.  vec: the
// tensors are 16-byte aligned, copied 16 bytes at a time with cp.async;
// otherwise loaded element by element (synchronously).
template <int kHd, bool kBack>
__device__ __forceinline__ void stage(const StageView<kHd>& sv,
                                      const float* __restrict__ r,
                                      const float* __restrict__ k,
                                      const float* __restrict__ v,
                                      const float* __restrict__ w,
                                      const float* __restrict__ dy,
                                      size_t base, size_t row, int row0,
                                      int t0, int seq, bool vec) {
  constexpr int kRows = Geo<kHd>::kRows, kThreads = Geo<kHd>::kThreads;
  const int nt = min(kChunk, seq - t0);
  if (vec) {
    constexpr int kRowPieces = kRows / 4, kColPieces = kHd / 4;
    for (int e = threadIdx.x; e < kChunk * kRowPieces; e += kThreads) {
      const int c = e / kRowPieces, p = (e - c * kRowPieces) * 4;
      const int o = c * kRows + p;
      const size_t off = base + size_t(t0 + c) * row + row0 + p;
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
    for (int e = threadIdx.x; e < kChunk * kColPieces; e += kThreads) {
      const int c = e / kColPieces, p = (e - c * kColPieces) * 4;
      const int o = c * kHd + p;
      const size_t off = base + size_t(t0 + c) * row + p;
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
  for (int e = threadIdx.x; e < kChunk * kRows; e += kThreads) {
    const int c = e / kRows, i = e - c * kRows;
    const bool live = c < nt;
    const size_t off = base + size_t(t0 + c) * row + row0 + i;
    sv.k[e] = live ? k[off] : 0.f;
    sv.w[e] = live ? w[off] : 1.f;
    if constexpr (kBack) sv.r[e] = live ? r[off] : 0.f;
  }
  for (int e = threadIdx.x; e < kChunk * kHd; e += kThreads) {
    const int c = e / kHd, j = e - c * kHd;
    const bool live = c < nt;
    const size_t off = base + size_t(t0 + c) * row + j;
    sv.v[e] = live ? v[off] : 0.f;
    if constexpr (kBack) sv.dy[e] = live ? dy[off] : 0.f;
  }
}

template <int kN>
__device__ __forceinline__ void store_run(float* p, const float* x) {
  if constexpr (kN % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kN; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  } else if constexpr (kN == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) p[i] = x[i];
  }
}

// A thread's kR rows x kC columns of a [hd, hd] state; m points at its
// first element.
template <int kHd>
__device__ __forceinline__ void load_tile(const float* m,
                                          float (&st)[kR][kHd / kColLanes]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) load_run<kHd / kColLanes>(m + i * kHd, st[i]);
}

template <int kHd>
__device__ __forceinline__ void store_tile(
    float* m, const float (&st)[kR][kHd / kColLanes]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) store_run<kHd / kColLanes>(m + i * kHd, st[i]);
}

// S <- diag(w_c) S + k_c v_c^T on a thread's rows x columns, from step c of
// a staged chunk (the forward kernel's rounding: fmaf(w, S, k * v)); il is
// the thread's first row within the block's, j0 its first column.
template <int kHd>
__device__ __forceinline__ void advance(const StageView<kHd>& sv, int c,
                                        int il, int j0,
                                        float (&st)[kR][kHd / kColLanes]) {
  constexpr int kC = kHd / kColLanes, kRows = Geo<kHd>::kRows;
  float kk[kR], ww[kR], vv[kC];
  load_run<kR>(sv.k + c * kRows + il, kk);
  load_run<kR>(sv.w + c * kRows + il, ww);
  load_run<kC>(sv.v + c * kHd + j0, vv);
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int cc = 0; cc < kC; ++cc)
      st[i][cc] = fmaf(ww[i], st[i][cc], kk[i] * vv[cc]);
}

// The shares of one dv total of an exchange: every block's warps' at
// offset off of exchange buffer buf, rank by rank, warp by warp.
template <int kHd>
__device__ __forceinline__ void fetch_shares(
    const uint32_t (&xch_at)[Geo<kHd>::kRanks], int buf, int off,
    float (&got)[Geo<kHd>::kRanks * Geo<kHd>::kWarps]) {
  using G = Geo<kHd>;
#pragma unroll
  for (int q = 0; q < G::kRanks; ++q)
#pragma unroll
    for (int wp = 0; wp < G::kWarps; ++wp)
      got[q * G::kWarps + wp] = clu::load(
          xch_at[q] +
          4u * uint32_t((buf * G::kWarps + wp) * G::kXSteps * kHd + off));
}

// The whole backward of one (b, h), a cluster of hd / kRows blocks; see the
// note at the top.  Grid (heads * ranks, batch), cluster (ranks, 1, 1).
// Writes dr, dk, dv, dw, ds0 and this (b, h)'s share of du, du_part
// [B, H, hd].  ckpt [B, H, chunks, hd, hd] is scratch.
template <int kHd>
__global__ void __launch_bounds__(Geo<kHd>::kThreads) wkv_bwd_cluster_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    const float* __restrict__ dy, const float* __restrict__ ds_final,
    float* __restrict__ ckpt, float* __restrict__ du_part,
    float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dw, float* __restrict__ ds0, int seq, int heads,
    int vec) {
  using G = Geo<kHd>;
  constexpr int kC = G::kC, kSub = G::kSub, kRanks = G::kRanks;
  constexpr int kRows = G::kRows, kThreads = G::kThreads;
  constexpr int kWarps = G::kWarps, kPer = G::kPer, kXSteps = G::kXSteps;
  extern __shared__ __align__(16) float smem[];
  float* const xch = smem + G::kXchOff;
  float* const pt = smem + G::kPtOff;
  float* const br = smem + G::kBrOff;
  float* const bk = smem + G::kBkOff;
  float* const starts = smem + G::kStartsOff;
  auto view = [&](int ci) {
    return StageView<kHd>(smem + (ci % 2) * G::kStage);
  };

  const int rank = int(clu::rank());
  const int h = blockIdx.x / kRanks;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int il = (warp * 2 + lane / kColLanes) * kR;  // rows il, il + 1
  const int row0 = rank * kRows;
  const int j0 = (lane % kColLanes) * kC;
  const size_t bh = size_t(b) * heads + h;
  const size_t row = size_t(heads) * kHd;
  const size_t base = size_t(b) * seq * row + size_t(h) * kHd;
  const size_t mat = size_t(kHd) * kHd;
  const int chunks = (seq + kChunk - 1) / kChunk;
  const size_t tile = size_t(row0 + il) * kHd + j0;  // in a [hd, hd] state
  float* const my_ckpt = ckpt + bh * chunks * mat + tile;

  // the u-term pass: thread tid takes step tid / kPer of a chunk and rows
  // 4 (tid % kPer) .. + 4 of the block's
  const int uc = tid / kPer, uq = tid % kPer;
  float uu[4], du[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    uu[m] = u[h * kHd + row0 + uq * 4 + m];
    du[m] = 0.f;
  }

  // every block of the cluster runs before any reads another's memory
  clu::sync();
  uint32_t xch_at[kRanks];   // every block's exchange, rank by rank
#pragma unroll
  for (int q = 0; q < kRanks; ++q) xch_at[q] = clu::map(xch, q);

  // ---- the forward, writing S at the start of every chunk; chunks
  // 0 .. chunks - 2 are staged (the last chunk's S is never needed), each
  // kFwdBufs - 1 chunks ahead of its use
  constexpr int kAhead = G::kFwdBufs - 1;
  auto fwd_view = [&](int ci) {
    return StageView<kHd>::forward(smem + (ci % G::kFwdBufs) * G::kFwd);
  };
  float st[kR][kC];
  load_tile<kHd>(s0 + bh * mat + tile, st);
#pragma unroll
  for (int ci = 0; ci < kAhead; ++ci) {
    if (ci + 1 < chunks)
      stage<kHd, false>(fwd_view(ci), nullptr, k, v, w, nullptr, base, row,
                        row0, ci * kChunk, seq, vec);
    tc::cp_async_commit();
  }
  for (int ci = 0; ci < chunks; ++ci) {
    store_tile<kHd>(my_ckpt + ci * mat, st);
    if (ci + 1 == chunks) break;
    __syncthreads();   // chunk ci - 1 is done with; its stage takes ci + 3
    if (ci + kAhead + 1 < chunks)
      stage<kHd, false>(fwd_view(ci + kAhead), nullptr, k, v, w, nullptr,
                        base, row, row0, (ci + kAhead) * kChunk, seq, vec);
    tc::cp_async_commit();
    tc::cp_async_wait<kAhead>();
    __syncthreads();   // chunk ci has landed
    const StageView<kHd> sv = fwd_view(ci);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) advance<kHd>(sv, c, il, j0, st);
  }

  // ---- the chunks backward
  float g[kR][kC];
  load_tile<kHd>(ds_final + bh * mat + tile, g);
  __syncthreads();   // the forward's stages are done with
  stage<kHd, true>(view(chunks - 1), r, k, v, w, dy, base, row, row0,
                   (chunks - 1) * kChunk, seq, vec);
  tc::cp_async_commit();
  // Sub-chunks done; exchange m = n / kGroup uses buffer m % 2.  The dv
  // totals of an exchange are summed during the next one, a sub-chunk's
  // worth (at most one a thread) in each of its sub-chunks: thread tid
  // takes total slot * kSub * kRows + tid in sub-chunk slot (step
  // total / kRows of the exchange, column row0 + total % kRows).  pend_buf
  // and pend_t: the buffer and the first step of the exchange pending.
  int n = 0;
  const bool owner = tid < kSub * kRows;
  int pend_buf = 0, pend_t = 0;
  float got[kRanks * kWarps];
  auto fetch = [&](int slot) {
    const int e = slot * kSub * kRows + tid;
    fetch_shares<kHd>(xch_at, pend_buf, (e / kRows) * kHd + row0 + e % kRows,
                      got);
  };
  auto store_dv = [&](int slot) {   // the fetched shares' sum, in order
    const int e = slot * kSub * kRows + tid;
    const int t = pend_t + e / kRows;
    float x = 0.f;
#pragma unroll
    for (int q = 0; q < kRanks * kWarps; ++q) x += got[q];
    if (t < seq) dv[base + size_t(t) * row + row0 + e % kRows] = x;
  };
  for (int ci = chunks - 1; ci >= 0; --ci) {
    const int t0 = ci * kChunk;
    __syncthreads();   // chunk ci + 1 is done with; its stage takes ci - 1
    if (ci > 0)
      stage<kHd, true>(view(ci - 1), r, k, v, w, dy, base, row, row0,
                       t0 - kChunk, seq, vec);
    tc::cp_async_commit();
    load_tile<kHd>(my_ckpt + ci * mat, st);
    tc::cp_async_wait<1>();
    __syncthreads();   // chunk ci has landed
    const StageView<kHd> sv = view(ci);
    {
      // the u terms of step uc: q = v . dy over every column, u k q and
      // u r q for dr and dk, this block's share of p, du's share
      constexpr int kQ = kHd / kPer;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < kQ; j += 4) {
        float vv[4], dd[4];
        load_run<4>(sv.v + uc * kHd + uq * kQ + j, vv);
        load_run<4>(sv.dy + uc * kHd + uq * kQ + j, dd);
#pragma unroll
        for (int e = 0; e < 4; ++e) q = fmaf(vv[e], dd[e], q);
      }
#pragma unroll
      for (int m = 1; m < kPer; m *= 2)
        q += __shfl_xor_sync(0xffffffffu, q, m);
      float rr[4], kk[4];
      load_run<4>(sv.r + uc * kRows + uq * 4, rr);
      load_run<4>(sv.k + uc * kRows + uq * 4, kk);
      float p = 0.f, bkr[4], brr[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float ru = rr[m] * uu[m];
        brr[m] = uu[m] * kk[m] * q;
        bkr[m] = ru * q;
        p = fmaf(ru, kk[m], p);
        du[m] = fmaf(rr[m] * kk[m], q, du[m]);
      }
      store_run<4>(br + uc * kRows + uq * 4, brr);
      store_run<4>(bk + uc * kRows + uq * 4, bkr);
#pragma unroll
      for (int m = 1; m < kPer; m *= 2)
        p += __shfl_xor_sync(0xffffffffu, p, m);
      if (uq == 0) pt[uc] = p;
    }
    __syncthreads();   // the u terms are in shared memory
    // S at the start of every sub-chunk, each thread its own elements
    for (int sc = 0; sc < G::kSubs; ++sc) {
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int cc = 0; cc < kC; ++cc)
          starts[((sc * kR + i) * kC + cc) * kThreads + tid] = st[i][cc];
      if (sc + 1 < G::kSubs) {
#pragma unroll
        for (int s = 0; s < kSub; ++s)
          advance<kHd>(sv, sc * kSub + s, il, j0, st);
      }
    }
    for (int sc = G::kSubs - 1; sc >= 0; --sc, ++n) {
      float hist[kSub][kR][kC];   // S_{t-1} of the sub-chunk's steps
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int cc = 0; cc < kC; ++cc)
          st[i][cc] = starts[((sc * kR + i) * kC + cc) * kThreads + tid];
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int cc = 0; cc < kC; ++cc) hist[s][i][cc] = st[i][cc];
        if (s + 1 < kSub) advance<kHd>(sv, sc * kSub + s, il, j0, st);
      }
      float sums[G::kVp];     // dr, dk, dw over this thread's columns
      float acc[kSub * kC];   // dv over this thread's rows
#pragma unroll
      for (int s = kSub - 1; s >= 0; --s) {
        const int c = sc * kSub + s;
        float rr[kR], kk[kR], ww[kR], vv[kC], dd[kC];
        load_run<kR>(sv.r + c * kRows + il, rr);
        load_run<kR>(sv.k + c * kRows + il, kk);
        load_run<kR>(sv.w + c * kRows + il, ww);
        load_run<kC>(sv.v + c * kHd + j0, vv);
        load_run<kC>(sv.dy + c * kHd + j0, dd);
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
          for (int cc = 0; cc < kC; ++cc) {
            pr = fmaf(hist[s][i][cc], dd[cc], pr);
            pk = fmaf(g[i][cc], vv[cc], pk);
            pw = fmaf(g[i][cc], hist[s][i][cc], pw);
          }
          sums[(s * 3 + 0) * kR + i] = pr;
          sums[(s * 3 + 1) * kR + i] = pk;
          sums[(s * 3 + 2) * kR + i] = pw;
        }
#pragma unroll
        for (int cc = 0; cc < kC; ++cc) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < kR; ++i) a = fmaf(g[i][cc], kk[i], a);
          acc[s * kC + cc] = a;
        }
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int cc = 0; cc < kC; ++cc)
            g[i][cc] = fmaf(ww[i], g[i][cc], rr[i] * dd[cc]);
      }
#pragma unroll
      for (int e = G::kV; e < G::kVp; ++e) sums[e] = 0.f;
      const int slot = n % G::kGroup;   // its place in its exchange
      // the exchange before this one: every block arrived at its barrier
      // a whole exchange's work ago
      if (slot == 0 && n > 0) clu::wait();
      // dv: the warp's two row groups meet (lanes 0-15 keep the first half
      // of the steps); each block adds its share of p_t dy_t once, warp
      // s % kWarps for step s; every block has summed the totals of the
      // exchange two back (it arrived at the last barrier after), so each
      // warp leaves its share in buffer (n / kGroup) % 2
      int first = 0;
      rec::reduce_scatter<32, kSub * kC, kColLanes>(acc, lane, first);
      float* const xb = xch + ((n / G::kGroup % 2) * kWarps + warp) *
                                  kXSteps * kHd + j0;
#pragma unroll
      for (int s = 0; s < kSub / 2; ++s) {
        const int c = sc * kSub + first / kC + s;
        if ((first / kC + s) % kWarps == warp) {
          float dd[kC];
          load_run<kC>(sv.dy + c * kHd + j0, dd);
#pragma unroll
          for (int cc = 0; cc < kC; ++cc)
            acc[s * kC + cc] = fmaf(pt[c], dd[cc], acc[s * kC + cc]);
        }
        store_run<kC>(xb + (c % kXSteps) * kHd, acc + s * kC);
      }
      // a dv total of the exchange before: its loads land while the sums
      // of dr, dk and dw meet
      const bool dv_now = n >= G::kGroup && owner;
      if (dv_now) fetch(slot);
      // dr, dk, dw: the 16 column lanes meet; each lane stores its 3 sums
      // (kVp / 16) with their u terms
      int firsts = 0;
      rec::reduce_scatter<kColLanes, G::kVp>(sums, lane, firsts);
#pragma unroll
      for (int e = 0; e < G::kVp / kColLanes; ++e) {
        const int id = firsts + e;
        const int s = id / (3 * kR), what = id / kR % 3;
        const int i = il + id % kR, c = sc * kSub + s;
        if (id < G::kV && t0 + c < seq) {
          float x = sums[e];
          if (what == 0) x += br[c * kRows + i];
          if (what == 1) x += bk[c * kRows + i];
          float* const out = what == 0 ? dr : (what == 1 ? dk : dw);
          out[base + size_t(t0 + c) * row + row0 + i] = x;
        }
      }
      if (dv_now) store_dv(slot);
      if (slot == G::kGroup - 1) {
        clu::arrive();
        pend_buf = n / G::kGroup % 2;
        pend_t = t0 + (sc * kSub) / kXSteps * kXSteps;
      }
    }
  }
  // the last exchange's totals
  clu::wait();
  if (owner) {
#pragma unroll
    for (int slot = 0; slot < G::kGroup; ++slot) {
      fetch(slot);
      store_dv(slot);
    }
  }
  store_tile<kHd>(ds0 + bh * mat + tile, g);
  // du: the 32 threads that share rows meet in step order
  __syncthreads();   // the stages are done with
  float* const red = smem;
  store_run<4>(red + uc * kRows + uq * 4, du);
  __syncthreads();
  if (tid < kRows) {
    float x = 0.f;
    for (int c = 0; c < kChunk; ++c) x += red[c * kRows + tid];
    du_part[bh * kHd + row0 + tid] = x;
  }
  // no block leaves while another may still read its shared memory
  clu::sync();
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

template <int kHd>
cudaLaunchConfig_t cluster_config(int batch, int heads, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  using G = Geo<kHd>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(heads * G::kRanks, batch, 1);
  cfg.blockDim = dim3(G::kThreads, 1, 1);
  cfg.dynamicSmemBytes = G::kSmem * sizeof(float);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = G::kRanks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int kHd>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(wkv_bwd_cluster_kernel<kHd>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(Geo<kHd>::kSmem * sizeof(float)));
}

template <int kHd>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0,
                   const float* dy, const float* ds_final, float* ckpt,
                   float* du_part, float* dr, float* dk, float* dv,
                   float* dw, float* du, float* ds0, int batch, int seq,
                   int heads, cudaStream_t stream) {
  // 16-byte copies need 16-byte aligned rows (hd and the block's rows are
  // multiples of 4 floats)
  const int vec = ((reinterpret_cast<uintptr_t>(r) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(w) |
                    reinterpret_cast<uintptr_t>(dy)) % 16) == 0;
  cudaError_t err = allow_smem<kHd>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config<kHd>(batch, heads, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, wkv_bwd_cluster_kernel<kHd>, r, k, v, w, u,
                           s0, dy, ds_final, ckpt, du_part, dr, dk, dv, dw,
                           ds0, seq, heads, vec);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int count = heads * kHd;
  wkv_sum_parts_kernel<<<(count + 255) / 256, 256, 0, stream>>>(
      du_part, du, batch, count);
  return cudaGetLastError();
}

template <int kHd>
cudaError_t max_clusters(int* out) {
  cudaError_t err = allow_smem<kHd>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<kHd>(1, 1, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(wkv_bwd_cluster_kernel<kHd>), &cfg);
}

}  // namespace

// All pointers f32 and contiguous: r, k, v, w, dy, dr, dk, dv, dw
// [B,S,H,hd]; u, du [H,hd]; s0, ds_final, ds0 [B,H,hd,hd] (16-byte
// aligned); scratch ckpt [B,H,ceil(S/32),hd,hd], du_part [B][H][hd].
// seq >= 1.
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              const void* dy, const void* ds_final,
                              void* ckpt, void* du_part, void* dr, void* dk,
                              void* dv, void* dw, void* du, void* ds0,
                              int batch, int seq, int heads, int hd,
                              void* stream_handle) {
  cudaGetLastError();  // start from a clean error state
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
#define WKV_BWD(HD)                                                        \
  return int(launch<HD>(                                                   \
      static_cast<const float*>(r), static_cast<const float*>(k),          \
      static_cast<const float*>(v), static_cast<const float*>(w),          \
      static_cast<const float*>(u), static_cast<const float*>(s0),         \
      static_cast<const float*>(dy), static_cast<const float*>(ds_final),  \
      static_cast<float*>(ckpt), static_cast<float*>(du_part),             \
      static_cast<float*>(dr), static_cast<float*>(dk),                    \
      static_cast<float*>(dv), static_cast<float*>(dw),                    \
      static_cast<float*>(du), static_cast<float*>(ds0), batch, seq, heads, \
      stream))
  if (hd == 16) WKV_BWD(16);
  if (hd == 32) WKV_BWD(32);
  if (hd == 64) WKV_BWD(64);
  if (hd == 128) WKV_BWD(128);
#undef WKV_BWD
  return int(cudaErrorInvalidValue);
}

// How many clusters of the head width's kernel the card can hold at once
// (cudaOccupancyMaxActiveClusters), into *out; 0 means none fits.
extern "C" int rwkv6_scan_bwd_max_clusters(int hd, int* out) {
  cudaGetLastError();
  *out = 0;
  if (hd == 16) return int(max_clusters<16>(out));
  if (hd == 32) return int(max_clusters<32>(out));
  if (hd == 64) return int(max_clusters<64>(out));
  if (hd == 128) return int(max_clusters<128>(out));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* rwkv6_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
