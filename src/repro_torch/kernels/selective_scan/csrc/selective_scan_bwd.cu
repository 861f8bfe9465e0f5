// Mamba selective scan backward, for Hopper (sm_90a).
//
// The gradient of selective_scan.cu (the port of the TPU kernel
//   src/repro/kernels/selective_scan/kernel.py::selective_scan).
// The TPU path has no backward kernel: JAX differentiates the
// associative scan of src/repro/models/ssm.py:104.  Per (batch, channel d),
// with the f32 state h [N] of the forward
//   h_t = e^{delta_t A} h_{t-1} + delta_t B_t x_t,   y_t = C_t . h_t + D x_t
// the adjoint g_t = dL/dh_t starts at dh_final and, walking t backward,
// takes C_t dy_t before step t's gradients and e^{delta_t A} after them:
//   dx_t     = D dy_t + delta_t sum_n g_t[n] B_t[n]
//   ddelta_t = sum_n g_t[n] (A[n] e^{delta_t A[n]} h_{t-1}[n] + B_t[n] x_t)
//   dA[n]    = sum_{b,t} g_t[n] delta_t e^{delta_t A[n]} h_{t-1}[n]
//   dB_t[n]  = sum_d g_t[n] delta_t x_t,   dC_t[n] = sum_d dy_t h_t[n]
//   dD       = sum_{b,t} dy_t x_t,         dh0 = e^{delta_1 A} g_1.
// x, dy and dx are bf16 or f32; every other tensor is f32.
//
// What bounds it on an H100: at Jamba's training shape (B 2, S 4096,
// D 8192, N 16, x bf16) the [B,S,D] tensors (x, delta, dy in, dx, ddelta
// out) are ~1 GB (0.30 ms at 3.35 TB/s), and the 1.07 G exponentials on
// the special-function units, 16 a clock per SM, take 0.26 ms once
// (0.77 ms for the three times this design evaluates them: in the
// checkpoint pass, in the rerun to the sub-chunk starts and in the rerun
// into the register history).
//
// The hard part, as for the WKV backward: h_{t-1} and g_t are needed at
// the same step, and h cannot be run backward by dividing by e^{delta A},
// which flushes to 0.  So h is recomputed forward from checkpoints:
//   * ss_bwd_ckpt_kernel runs the forward recurrence once and writes h at
//     the start of every 32-step chunk (67 MB at the training shape);
//   * ss_bwd_kernel walks the chunks backward, with the forward's block
//     (64 channels x 4 lanes for N <= 16; 16 x 16 for N <= 64; each
//     thread 4 states).  It stages the chunk's x, delta, dy (the block's
//     channels) and B, C rows in shared memory (cp.async into two buffers,
//     the next chunk landing while this one computes, as in the forward),
//     reruns the chunk forward
//     from its checkpoint keeping h at the start of every 8-step
//     sub-chunk (each thread its own states, in shared memory), then walks
//     the sub-chunks backward: rerun 8 steps forward into registers
//     (h_{t-1} and e^{delta A}, fully unrolled), then 8 steps backward
//     with g in registers.  Staging 64 channels x 16 states x 32 steps of
//     history instead would take 128 KB a block.
// The sums: dx and ddelta sum over the states, across a channel's lanes,
// in one reduce-scatter per sub-chunk (as the forward forms y).  dA and dD
// sum over time in registers and over the batch in a second pass.  dB and
// dC sum over every channel (8192, in 128 blocks): a warp's channels meet
// in a reduce-scatter, the block's warps in shared memory, the blocks
// through per-block partials that a second pass sums in a fixed order.
// No atomics: every run gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence.cuh"

namespace {

using rec::from_f32;
using rec::load_run;
using rec::to_f32;

constexpr int kPer = 4;          // states a thread holds
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;       // steps between checkpoints / staged
constexpr int kSub = 8;          // steps of register history
constexpr int kSubs = kChunk / kSub;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a build holding up to kMaxN states, in floats past two
// stages: the warps' dB / dC sums of a sub-chunk [kSub][kWarps][2][kMaxN]
// and the sub-chunk starts [kSubs][kPer][kThreads].
template <int kMaxN>
struct Geo {
  static constexpr int kLanes = kMaxN / kPer;
  static constexpr int kCh = kThreads / kLanes;
  static constexpr int kRed = kSub * kWarps * 2 * kMaxN;
  static constexpr int kStarts = kSubs * kPer * kThreads;
};

// One staged chunk: delta, x and dy [kChunk][kCh] (the block's channels; x
// and dy in their own type), B and C [kChunk][kMaxN] (zeros past n).
template <typename T, int kMaxN>
struct Stage {
  static constexpr int kCh = Geo<kMaxN>::kCh;
  float dt[kChunk][kCh];
  float b[kChunk][kMaxN];
  float c[kChunk][kMaxN];
  T x[kChunk][kCh];
  T dy[kChunk][kCh];
};

// Starts copying steps t0 .. t0 + kChunk of the block's channels into a
// stage (the caller commits the cp.async group); steps past seq, channels
// past dim and states past n become zeros (delta 0: the state stays).
// vec: x, delta and dy 16-byte aligned with dim % 8 == 0, copied 16 bytes
// at a time; otherwise loaded element by element (synchronously).  B and
// C rows go 4 bytes at a time.
template <typename T, int kMaxN, bool kBack>
__device__ __forceinline__ void stage(
    Stage<T, kMaxN>& sg, const T* __restrict__ x,
    const float* __restrict__ delta, const float* __restrict__ bm,
    const float* __restrict__ cm, const T* __restrict__ dy, size_t xbase,
    size_t nbase, int dim, int d0, int n, int t0, int seq, bool vec) {
  constexpr int kCh = Geo<kMaxN>::kCh;
  const int nt = min(kChunk, seq - t0);
  for (int e = threadIdx.x; e < kChunk * kMaxN; e += kThreads) {
    const int c = e / kMaxN, s = e - c * kMaxN;
    const bool live = c < nt && s < n;
    const size_t off = nbase + size_t(t0 + c) * n + s;
    tc::cp_async4(&sg.b[c][s], live ? bm + off : bm, live);
    if constexpr (kBack) tc::cp_async4(&sg.c[c][s], live ? cm + off : cm,
                                       live);
  }
  if (vec) {
    constexpr int kXPer = 16 / int(sizeof(T)), kXPieces = kCh / kXPer;
    for (int e = threadIdx.x; e < kChunk * kXPieces; e += kThreads) {
      const int c = e / kXPieces, p = (e - c * kXPieces) * kXPer;
      const bool live = c < nt && d0 + p < dim;
      const size_t off = xbase + size_t(t0 + c) * dim + p;
      tc::cp_async16(&sg.x[c][p], live ? x + off : x, live);
      if constexpr (kBack) tc::cp_async16(&sg.dy[c][p], live ? dy + off : dy,
                                          live);
    }
    for (int e = threadIdx.x; e < kChunk * kCh / 4; e += kThreads) {
      const int c = e / (kCh / 4), p = (e - c * (kCh / 4)) * 4;
      const bool live = c < nt && d0 + p < dim;
      const size_t off = xbase + size_t(t0 + c) * dim + p;
      tc::cp_async16(&sg.dt[c][p], live ? delta + off : delta, live);
    }
    return;
  }
  for (int e = threadIdx.x; e < kChunk * kCh; e += kThreads) {
    const int c = e / kCh, j = e - c * kCh;
    const bool live = c < nt && d0 + j < dim;
    const size_t off = xbase + size_t(t0 + c) * dim + j;
    sg.x[c][j] = live ? x[off] : from_f32<T>(0.f);
    sg.dt[c][j] = live ? delta[off] : 0.f;
    if constexpr (kBack) sg.dy[c][j] = live ? dy[off] : from_f32<T>(0.f);
  }
}

// h <- e^{delta A} h + delta x B at step c of a staged chunk (the forward
// kernel's rounding); ea receives e^{delta A}.
template <typename T, int kMaxN>
__device__ __forceinline__ void advance(const Stage<T, kMaxN>& sg, int c,
                                        int ch, int s0,
                                        const float (&a2)[kPer],
                                        float (&h)[kPer], float (&ea)[kPer]) {
  const float dt = sg.dt[c][ch];
  const float dx = dt * to_f32(sg.x[c][ch]);
  float bv[kPer];
  load_run<kPer>(&sg.b[c][s0], bv);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    ea[i] = rec::exp2_sfu(dt * a2[i]);
    h[i] = fmaf(ea[i], h[i], dx * bv[i]);
  }
}

// Pass 1: the forward recurrence from h0, writing h at the start of every
// chunk to ckpt [B, chunks, D, N]; the next chunk stages while this one
// computes.
template <typename T, int kMaxN>
__global__ void __launch_bounds__(kThreads) ss_bwd_ckpt_kernel(
    const T* __restrict__ x, const float* __restrict__ delta,
    const float* __restrict__ a, const float* __restrict__ bm,
    const float* __restrict__ h0, float* __restrict__ ckpt, int seq, int dim,
    int n, int vec) {
  using G = Geo<kMaxN>;
  using StageT = Stage<T, kMaxN>;
  extern __shared__ __align__(16) unsigned char smem[];
  StageT* const stages = reinterpret_cast<StageT*>(smem);
  const int tid = threadIdx.x;
  const int ch = tid / G::kLanes;
  const int s0 = (tid % G::kLanes) * kPer;
  const int d0 = blockIdx.x * G::kCh;
  const int bi = blockIdx.y;
  const int dch = d0 + ch;
  const bool live = dch < dim;
  float h[kPer], a2[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const bool on = live && s0 + i < n;
    h[i] = on ? h0[(size_t(bi) * dim + dch) * n + s0 + i] : 0.f;
    a2[i] = on ? a[size_t(dch) * n + s0 + i] * kLog2e : 0.f;
  }
  const size_t xbase = size_t(bi) * seq * dim + d0;
  const size_t nbase = size_t(bi) * seq * n;
  const int chunks = (seq + kChunk - 1) / kChunk;
  stage<T, kMaxN, false>(stages[0], x, delta, bm, nullptr, nullptr, xbase,
                         nbase, dim, d0, n, 0, seq, vec);
  tc::cp_async_commit();
  for (int ci = 0; ci < chunks; ++ci) {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (live && s0 + i < n)
        ckpt[((size_t(bi) * chunks + ci) * dim + dch) * n + s0 + i] = h[i];
    __syncthreads();   // chunk ci - 1 is done with; its stage takes ci + 1
    if (ci + 1 < chunks)
      stage<T, kMaxN, false>(stages[(ci + 1) % 2], x, delta, bm, nullptr,
                             nullptr, xbase, nbase, dim, d0, n,
                             (ci + 1) * kChunk, seq, vec);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();   // chunk ci has landed
    const StageT& sg = stages[ci % 2];
    float ea[kPer];
    for (int c = 0; c < kChunk; ++c)
      advance<T, kMaxN>(sg, c, ch, s0, a2, h, ea);
  }
}

// Pass 2: the chunks backward (see the note at the top).  Writes dx,
// ddelta and dh0, and the partials: dB / dC by channel block
// bc_part [blocks][2][B,S,N], dA and dD by batch row a_part [B][D][N],
// d_part [B][D].
template <typename T, int kMaxN>
__global__ void __launch_bounds__(kThreads) ss_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ delta,
    const float* __restrict__ a, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ dskip,
    const T* __restrict__ dy, const float* __restrict__ dh_final,
    const float* __restrict__ ckpt, T* __restrict__ dx,
    float* __restrict__ ddelta, float* __restrict__ dh0,
    float* __restrict__ bc_part, float* __restrict__ a_part,
    float* __restrict__ d_part, int batch, int seq, int dim, int n,
    int vec) {
  using G = Geo<kMaxN>;
  using StageT = Stage<T, kMaxN>;
  constexpr int kLanes = G::kLanes, kCh = G::kCh;
  constexpr int kV = 2 * kSub;     // dx and ddelta shares of a sub-chunk
  constexpr int kOwn = kV >= kLanes ? kV / kLanes : 1;
  constexpr int kOwnBC = 2 * kPer / (32 / kLanes);   // dB / dC sums a lane
  extern __shared__ __align__(16) unsigned char smem[];
  StageT* const stages = reinterpret_cast<StageT*>(smem);
  float* const red = reinterpret_cast<float*>(smem + 2 * sizeof(StageT));
  float* const starts = red + G::kRed;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int ch = tid / kLanes;
  const int s0 = (tid % kLanes) * kPer;
  const int d0 = blockIdx.x * kCh;
  const int bi = blockIdx.y;
  const int dch = d0 + ch;
  const bool live = dch < dim;
  float g[kPer], a2[kPer], an[kPer], da[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const bool on = live && s0 + i < n;
    g[i] = on ? dh_final[(size_t(bi) * dim + dch) * n + s0 + i] : 0.f;
    an[i] = on ? a[size_t(dch) * n + s0 + i] : 0.f;
    a2[i] = an[i] * kLog2e;
    da[i] = 0.f;
  }
  const float skip = live && s0 == 0 ? dskip[dch] : 0.f;
  float dd = 0.f;   // this channel's share of dD
  const size_t xbase = size_t(bi) * seq * dim + d0;
  const size_t nbase = size_t(bi) * seq * n;
  const size_t bc_plane = size_t(batch) * seq * n;
  const int chunks = (seq + kChunk - 1) / kChunk;
  stage<T, kMaxN, true>(stages[(chunks - 1) % 2], x, delta, bm, cm, dy,
                        xbase, nbase, dim, d0, n, (chunks - 1) * kChunk, seq,
                        vec);
  tc::cp_async_commit();
  for (int ci = chunks - 1; ci >= 0; --ci) {
    const int t0 = ci * kChunk;
    __syncthreads();   // chunk ci + 1 is done with; its stage takes ci - 1
    if (ci > 0)
      stage<T, kMaxN, true>(stages[(ci - 1) % 2], x, delta, bm, cm, dy,
                            xbase, nbase, dim, d0, n, t0 - kChunk, seq, vec);
    tc::cp_async_commit();
    float h[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      h[i] = live && s0 + i < n
                 ? ckpt[((size_t(bi) * chunks + ci) * dim + dch) * n + s0 + i]
                 : 0.f;
    tc::cp_async_wait<1>();
    __syncthreads();   // chunk ci has landed
    const StageT& sg = stages[ci % 2];
    // h at the start of every sub-chunk, each thread its own states
    for (int sc = 0; sc < kSubs; ++sc) {
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        starts[(sc * kPer + i) * kThreads + tid] = h[i];
      float ea[kPer];
#pragma unroll
      for (int u = 0; u < kSub; ++u)
        advance<T, kMaxN>(sg, sc * kSub + u, ch, s0, a2, h, ea);
    }
    for (int sc = kSubs - 1; sc >= 0; --sc) {
      float hp[kSub][kPer], ea[kSub][kPer];   // h_{t-1}, e^{delta_t A}
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        h[i] = starts[(sc * kPer + i) * kThreads + tid];
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) hp[u][i] = h[i];
        advance<T, kMaxN>(sg, sc * kSub + u, ch, s0, a2, h, ea[u]);
      }
      float acc[kV];   // [u]: dx shares, [kSub + u]: ddelta shares
#pragma unroll
      for (int u = kSub - 1; u >= 0; --u) {
        const int c = sc * kSub + u;
        const float xv = to_f32(sg.x[c][ch]);
        const float dt = sg.dt[c][ch];
        const float dyv = to_f32(sg.dy[c][ch]);
        float bv[kPer], cv[kPer], pb[kPer], pc[kPer];
        load_run<kPer>(&sg.b[c][s0], bv);
        load_run<kPer>(&sg.c[c][s0], cv);
        const float dtx = dt * xv;
        float gb = 0.f, gd = 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          g[i] = fmaf(cv[i], dyv, g[i]);
          pc[i] = dyv * fmaf(ea[u][i], hp[u][i], dtx * bv[i]);   // dy h_t
          pb[i] = g[i] * dtx;
          gb = fmaf(g[i], bv[i], gb);
          const float geh = g[i] * ea[u][i] * hp[u][i];
          gd = fmaf(geh, an[i], gd);
          da[i] = fmaf(geh, dt, da[i]);
          g[i] *= ea[u][i];
        }
        acc[u] = fmaf(dt, gb, skip * dyv);
        acc[kSub + u] = fmaf(gb, xv, gd);
        dd = fmaf(dyv, xv, dd);
        // dB_t and dC_t: the warp's channels meet in a reduce-scatter over
        // the lanes above the channel's lanes, and each lane leaves the
        // sums it owns for the block's sum over its warps
        float pbc[2 * kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          pbc[i] = pb[i];
          pbc[kPer + i] = pc[i];
        }
        int own = 0;
        rec::reduce_scatter<32, 2 * kPer, kLanes>(pbc, lane, own);
#pragma unroll
        for (int q = 0; q < kOwnBC; ++q) {
          const int e = own + q;
          red[((u * kWarps + warp) * 2 + e / kPer) * kMaxN + s0 + e % kPer] =
              pbc[q];
        }
      }
      // dx and ddelta: the states' shares meet across the channel's lanes
      int first = 0;
      rec::reduce_scatter<kLanes, kV>(acc, lane, first);
      if (live && rec::owns_sum<kLanes, kV>(lane)) {
#pragma unroll
        for (int q = 0; q < kOwn; ++q) {
          const int e = first + q;
          const int u = e < kSub ? e : e - kSub;
          const int t = t0 + sc * kSub + u;
          if (t >= seq) continue;
          const size_t off = xbase + size_t(t) * dim + ch;
          if (e < kSub)
            dx[off] = from_f32<T>(acc[q]);
          else
            ddelta[off] = acc[q];
        }
      }
      __syncthreads();   // the sub-chunk's dB / dC shares are in red
      for (int e = tid; e < kSub * 2 * kMaxN; e += kThreads) {
        const int uq = e / kMaxN, s = e - uq * kMaxN;
        const int u = uq / 2, q = uq % 2;
        const int t = t0 + sc * kSub + u;
        if (s >= n || t >= seq) continue;
        float sum = 0.f;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp)
          sum += red[((u * kWarps + wp) * 2 + q) * kMaxN + s];
        bc_part[(size_t(blockIdx.x) * 2 + q) * bc_plane + nbase +
                size_t(t) * n + s] = sum;
      }
      __syncthreads();   // red is free for the next sub-chunk
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (live && s0 + i < n) {
      const size_t off = (size_t(bi) * dim + dch) * n + s0 + i;
      dh0[off] = g[i];
      a_part[off] = da[i];
    }
  }
  if (live && s0 == 0) d_part[size_t(bi) * dim + dch] = dd;
}

// out[e] = sum over p of parts[p][e], in the order of p.
__global__ void ss_sum_parts_kernel(const float* __restrict__ parts,
                                    float* __restrict__ out, int nparts,
                                    size_t count) {
  const size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += parts[size_t(p) * count + e];
  out[e] = s;
}

cudaError_t sum_parts(const float* parts, float* out, int nparts,
                      size_t count, cudaStream_t stream) {
  if (count == 0) return cudaSuccess;
  ss_sum_parts_kernel<<<unsigned((count + 255) / 256), 256, 0, stream>>>(
      parts, out, nparts, count);
  return cudaGetLastError();
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <typename T, int kMaxN>
cudaError_t launch(const void* x, const void* delta, const void* a,
                   const void* b, const void* c, const void* d,
                   const void* h0, const void* dy, const void* dh_final,
                   void* ckpt, void* bc_part, void* a_part, void* d_part,
                   void* dx, void* ddelta, void* da, void* dbc, void* dd,
                   void* dh0, int batch, int seq, int dim, int n,
                   cudaStream_t stream) {
  using G = Geo<kMaxN>;
  const dim3 grid((dim + G::kCh - 1) / G::kCh, batch);
  const size_t smem_ckpt = 2 * sizeof(Stage<T, kMaxN>);
  const size_t smem_bwd = smem_ckpt + size_t(G::kRed + G::kStarts) *
                                          sizeof(float);
  const int vec = dim % 8 == 0 &&
                  ((reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(delta) |
                    reinterpret_cast<uintptr_t>(dy)) % 16) == 0;
  cudaError_t err = allow_smem(ss_bwd_ckpt_kernel<T, kMaxN>, smem_ckpt);
  if (err == cudaSuccess) err = allow_smem(ss_bwd_kernel<T, kMaxN>, smem_bwd);
  if (err != cudaSuccess) return err;
  ss_bwd_ckpt_kernel<T, kMaxN><<<grid, kThreads, smem_ckpt, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(delta),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(ckpt), seq, dim, n,
      vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ss_bwd_kernel<T, kMaxN><<<grid, kThreads, smem_bwd, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(delta),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(d),
      static_cast<const T*>(dy), static_cast<const float*>(dh_final),
      static_cast<const float*>(ckpt), static_cast<T*>(dx),
      static_cast<float*>(ddelta), static_cast<float*>(dh0),
      static_cast<float*>(bc_part), static_cast<float*>(a_part),
      static_cast<float*>(d_part), batch, seq, dim, n, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = sum_parts(static_cast<const float*>(bc_part),
                  static_cast<float*>(dbc), int(grid.x),
                  2 * size_t(batch) * seq * n, stream);
  if (err == cudaSuccess)
    err = sum_parts(static_cast<const float*>(a_part),
                    static_cast<float*>(da), batch, size_t(dim) * n, stream);
  if (err == cudaSuccess)
    err = sum_parts(static_cast<const float*>(d_part),
                    static_cast<float*>(dd), batch, size_t(dim), stream);
  return err;
}

template <typename T>
cudaError_t dispatch(const void* x, const void* delta, const void* a,
                     const void* b, const void* c, const void* d,
                     const void* h0, const void* dy, const void* dh_final,
                     void* ckpt, void* bc_part, void* a_part, void* d_part,
                     void* dx, void* ddelta, void* da, void* dbc, void* dd,
                     void* dh0, int batch, int seq, int dim, int n,
                     cudaStream_t stream) {
#define SS_BWD(MAXN)                                                       \
  return launch<T, MAXN>(x, delta, a, b, c, d, h0, dy, dh_final, ckpt,     \
                         bc_part, a_part, d_part, dx, ddelta, da, dbc, dd, \
                         dh0, batch, seq, dim, n, stream)
  if (n >= 1 && n <= 16) SS_BWD(16);
  if (n > 16 && n <= 64) SS_BWD(64);
#undef SS_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes shared with kernel.py: 0 float32, 1 bfloat16 (x, dy and dx;
// every other tensor is float32).  Shapes: x, delta, dy, dx, ddelta
// [B,S,D]; a, da [D,N]; b, c [B,S,N]; d, dd [D]; h0, dh_final, dh0
// [B,D,N]; dbc [2][B,S,N] (dB then dC); scratch ckpt [B,ceil(S/32),D,N],
// bc_part [blocks][2][B,S,N] (blocks = ceil(D / channels a block): 64
// channels for N <= 16, 16 for N <= 64), a_part [B][D][N], d_part [B][D].
// seq >= 1.
extern "C" int selective_scan_bwd(
    const void* x, const void* delta, const void* a, const void* b,
    const void* c, const void* d, const void* h0, const void* dy,
    const void* dh_final, void* ckpt, void* bc_part, void* a_part,
    void* d_part, void* dx, void* ddelta, void* da, void* dbc, void* dd,
    void* dh0, int batch, int seq, int dim, int n, int dtype,
    void* stream_handle) {
  cudaGetLastError();  // start from a clean error state
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (dtype == 0)
    return int(dispatch<float>(x, delta, a, b, c, d, h0, dy, dh_final, ckpt,
                               bc_part, a_part, d_part, dx, ddelta, da, dbc,
                               dd, dh0, batch, seq, dim, n, stream));
  if (dtype == 1)
    return int(dispatch<__nv_bfloat16>(
        x, delta, a, b, c, d, h0, dy, dh_final, ckpt, bc_part, a_part,
        d_part, dx, ddelta, da, dbc, dd, dh0, batch, seq, dim, n, stream));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
