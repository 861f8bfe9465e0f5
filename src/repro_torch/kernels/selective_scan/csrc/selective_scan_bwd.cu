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
// out) are ~0.94 GB (0.28 ms at 3.35 TB/s), and the 1.07 G exponentials on
// the special-function units, 16 a clock per SM, take 0.26 ms a pass.  In
// practice the walk's issue sets the pace: per (step, channel, state)
// ~9 f32 instructions for the adjoint and the gradients and ~4 for each
// rerun of h, plus the sums across lanes and loads, at 4 warp-instructions
// a clock per SM with 16 warps an SM (ptxas holds a thread to 128
// registers, so two blocks of 256 fit).
//
// The hard part, as for the WKV backward: h_{t-1} and g_t are needed at
// the same step, and h cannot be run backward by dividing by e^{delta A},
// which flushes to 0.  So h is rerun forward from checkpoints.
//
// The first design, at the training shape (profile_scan_bwd, NVIDIA
// H100 80GB HBM3, 700 W): 2.55 ms a call in five kernels.  A checkpoint
// pass reran the whole forward (0.41 ms, writing h every 32 steps); the walk
// (2.07 ms, ~154 instructions a thread a step for 4 elements) reran each
// chunk twice (to the 8-step sub-chunk starts, then into registers), met
// dB / dC across a warp's 8 channels in a 7-shuffle reduce-scatter every
// step and across the block's warps behind two barriers every 8 steps;
// three passes summed 128 planes of partials (0.06).  Three exponential
// passes in all.
//
// This design:
//   * the forward writes the checkpoints: selective_scan.cu's checkpoint
//     mode stores h before every 32nd step while it scans (134 MB at the
//     training shape, ~0.025 ms there), SelectiveScanFn saves them, and the
//     backward has no checkpoint pass; a direct call makes them with that
//     mode first.  Two exponential passes remain here: the rerun of a
//     chunk from its checkpoint to the starts of its sub-chunks (24 steps:
//     the last start is where it ends), and each sub-chunk's rerun into
//     registers (h_{t-1}, h_t and e^{delta A} of 8 steps, fully unrolled).
//     Checkpoints every 8 steps (no starts rerun) measured slower in all:
//     the forward's 537 MB of stores cost more than the rerun they save;
//   * a thread holds 2 channels x 2 states (kTileCh): its dB_t, dC_t
//     shares add over its two channels in registers and go to shared
//     memory as one 16-byte store a step; the block sums them over its 32
//     channel groups every two sub-chunks (kSumSubs; every one for x f32,
//     where two buffers do not fit beside two blocks an SM) in four fixed
//     interleaved partial sums, one plane of partials a block, which a last
//     pass sums in plane order;
//   * gb = sum_n g B and gd = sum_n g A e^{delta A} h_{t-1} (not dx and
//     ddelta) meet across a channel's 8 lanes every 4 steps in one
//     reduce-scatter; the lane left owning a (step, channel) finishes dx
//     and ddelta from the staged delta, x and dy and sums dy x for dD;
//   * barriers: one when a chunk lands, one before and one after each sum
//     of the block's shares but the chunk's last (4 a chunk for x bf16, 8
//     for f32; 10 before);
//   * no thread-block cluster: clusters of 2 or 8 channel blocks summing
//     dB / dC in distributed shared memory once a chunk measured slower in
//     every design tried (their barrier's release is a MEMBAR.ALL.GPU, the
//     chunk's sums take the room of the second shares buffer, and 30
//     clusters of 8 fit at once against the training shape's 32), for a
//     last pass over 16 planes in place of 128 (~0.05 ms).
// No atomics: every sum has a fixed order (in-thread, fixed shuffle
// rounds, channel groups in a fixed interleave, planes in order), so every
// run gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence.cuh"

namespace {

using rec::from_f32;
using rec::load_run;
using rec::to_f32;

constexpr int kPer = 4;          // (channel, state) elements a thread holds
constexpr int kTileCh = 2;       // channels a thread holds
constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;    // blocks an SM holds (registers <= 128)
constexpr int kChunk = 32;       // steps between checkpoints / staged
constexpr int kSub = 8;          // steps of register history
constexpr int kSubs = kChunk / kSub;
constexpr int kXSteps = 4;       // steps whose dx / ddelta shares meet at once
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The geometry of a build holding up to kMaxN states with x of type T:
// kLanes threads share a group of kP channels (kQ states each), kGroups
// groups (kCh channels) a block.  Shared memory, in floats past two
// stages: red [kSumSubs kSub][kThreads][2 kQ] (each thread's dB, dC shares
// of kSumSubs sub-chunks' steps, its channels summed: two where they fit
// beside two blocks an SM), the starts of sub-chunks 1 .. kSubs - 2
// [kSubs - 2][kPer][kThreads] (sub-chunk 0 starts at the checkpoint, the
// last at the end of the starts rerun).
template <typename T, int kMaxN>
struct Geo {
  static constexpr int kP = kTileCh;
  static constexpr int kQ = kPer / kTileCh;
  static constexpr int kLanes = kMaxN / kQ;
  static constexpr int kGroups = kThreads / kLanes;
  static constexpr int kCh = kGroups * kP;
  static constexpr int kSumSubs = sizeof(T) == 2 ? 2 : 1;
  static constexpr int kRed = kSumSubs * kSub * kThreads * 2 * kQ;
  static constexpr int kStarts = (kSubs - 2) * kPer * kThreads;
  static_assert(kLanes <= 32 && 2 * kQ % 4 == 0, "float4 rows of red");
};

// The first entry of the sums that rec::reduce_scatter<kLanes, kV> leaves
// a lane (its `first`, known before the shuffles).
template <int kLanes, int kV>
__device__ __forceinline__ int scatter_first(int lane) {
  int first = 0;
#pragma unroll
  for (int m = 1, v = kV; m < kLanes && v > 1; m *= 2) {
    v /= 2;
    if (lane & m) first += v;
  }
  return first;
}

// One staged chunk: delta, x and dy [kChunk][kCh] (the block's channels; x
// and dy in their own type), B and C [kChunk][kMaxN] (zeros past n).
template <typename T, int kMaxN>
struct Stage {
  static constexpr int kCh = Geo<T, kMaxN>::kCh;
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
template <typename T, int kMaxN>
__device__ __forceinline__ void stage(
    Stage<T, kMaxN>& sg, const T* __restrict__ x,
    const float* __restrict__ delta, const float* __restrict__ bm,
    const float* __restrict__ cm, const T* __restrict__ dy, size_t xbase,
    size_t nbase, int dim, int d0, int n, int t0, int seq, bool vec) {
  constexpr int kCh = Geo<T, kMaxN>::kCh;
  const int nt = min(kChunk, seq - t0);
  for (int e = threadIdx.x; e < kChunk * kMaxN; e += kThreads) {
    const int c = e / kMaxN, s = e - c * kMaxN;
    const bool live = c < nt && s < n;
    const size_t off = nbase + size_t(t0 + c) * n + s;
    tc::cp_async4(&sg.b[c][s], live ? bm + off : bm, live);
    tc::cp_async4(&sg.c[c][s], live ? cm + off : cm, live);
  }
  if (vec) {
    constexpr int kXPer = 16 / int(sizeof(T)), kXPieces = kCh / kXPer;
    for (int e = threadIdx.x; e < kChunk * kXPieces; e += kThreads) {
      const int c = e / kXPieces, p = (e - c * kXPieces) * kXPer;
      const bool live = c < nt && d0 + p < dim;
      const size_t off = xbase + size_t(t0 + c) * dim + p;
      tc::cp_async16(&sg.x[c][p], live ? x + off : x, live);
      tc::cp_async16(&sg.dy[c][p], live ? dy + off : dy, live);
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
    sg.dy[c][j] = live ? dy[off] : from_f32<T>(0.f);
  }
}

// h <- e^{delta A} h + delta x B at step c of a staged chunk for the
// thread's kP channels from ch and kQ states from s0 (the forward kernel's
// rounding); ea receives e^{delta A}.
template <typename T, int kMaxN>
__device__ __forceinline__ void advance(
    const Stage<T, kMaxN>& sg, int c, int ch, int s0,
    const float (&a2)[Geo<T, kMaxN>::kP][Geo<T, kMaxN>::kQ],
    float (&h)[Geo<T, kMaxN>::kP][Geo<T, kMaxN>::kQ],
    float (&ea)[Geo<T, kMaxN>::kP][Geo<T, kMaxN>::kQ]) {
  constexpr int kP = Geo<T, kMaxN>::kP, kQ = Geo<T, kMaxN>::kQ;
  float dt[kP], xv[kP], bv[kQ];
  load_run<kP>(&sg.dt[c][ch], dt);
  load_run<kP>(&sg.x[c][ch], xv);
  load_run<kQ>(&sg.b[c][s0], bv);
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const float dx = dt[j] * xv[j];
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      ea[j][i] = rec::exp2_sfu(dt[j] * a2[j][i]);
      h[j][i] = fmaf(ea[j][i], h[j][i], dx * bv[i]);
    }
  }
}

// The chunks backward (see the note at the top), a block of kCh channels
// of one batch row.  Writes dx, ddelta and dh0, and the partials: dB / dC
// by block bc_part [blocks][2][B,S,N], dA by batch row a_part [B][D][N],
// dD by batch row and step offset d_part [B][kXSteps][D].  ckpt
// [B, ceil(S/32), D, N] holds h before every chunk (the forward's).
template <typename T, int kMaxN>
__global__ void __launch_bounds__(kThreads, kMinBlocks) ss_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ delta,
    const float* __restrict__ a, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ dskip,
    const T* __restrict__ dy, const float* __restrict__ dh_final,
    const float* __restrict__ ckpt, T* __restrict__ dx,
    float* __restrict__ ddelta, float* __restrict__ dh0,
    float* __restrict__ bc_part, float* __restrict__ a_part,
    float* __restrict__ d_part, int batch, int seq, int dim, int n,
    int vec) {
  using G = Geo<T, kMaxN>;
  using StageT = Stage<T, kMaxN>;
  constexpr int kP = G::kP, kQ = G::kQ, kLanes = G::kLanes, kCh = G::kCh;
  // gb = sum_n g B and gd = sum_n g A e^{delta A} h_{t-1} of kXSteps steps,
  // the states' shares of which meet across a group's lanes
  constexpr int kV = 2 * kP * kXSteps;
  constexpr int kOwn = kV >= kLanes ? kV / kLanes : 1;
  constexpr int kPairs = kOwn >= 2 ? kOwn / 2 : 1;   // (gb, gd) a lane owns
  constexpr int kRow = 2 * kQ;           // a thread's dB, dC shares a step
  extern __shared__ __align__(16) unsigned char smem[];
  StageT* const stages = reinterpret_cast<StageT*>(smem);
  float* const red = reinterpret_cast<float*>(smem + 2 * sizeof(StageT));
  float* const starts = red + G::kRed;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int ch = tid / kLanes * kP;   // the block's channel of the first
  const int s0 = tid % kLanes * kQ;   // the first state
  const int d0 = blockIdx.x * kCh;
  const int bi = blockIdx.y;
  const size_t xbase = size_t(bi) * seq * dim + d0;
  // The (step, channel) pairs whose gb and gd this lane owns once they
  // meet (entry (u kP + j) 2 + k of acc; with one entry a lane, the other
  // of the pair comes from lane ^ kV / 2): it finishes dx and ddelta there
  // and sums dy x into dD's share of step offset u.
  const int first = scatter_first<kLanes, kV>(lane);
  const bool owner = rec::owns_sum<kLanes, kV>(lane) &&
                     (kOwn >= 2 || first % 2 == 0);
  int own_u[kPairs], own_ch[kPairs];
  bool own_live[kPairs];
  float own_skip[kPairs], own_dd[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const int pair = first / 2 + p;
    own_u[p] = pair / kP;
    own_ch[p] = ch + pair % kP;
    own_live[p] = owner && d0 + own_ch[p] < dim;
    own_skip[p] = own_live[p] ? dskip[d0 + own_ch[p]] : 0.f;
    own_dd[p] = 0.f;
  }
  bool live[kP];
  float g[kP][kQ], a2[kP][kQ], da[kP][kQ];
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const int dch = d0 + ch + j;
    live[j] = dch < dim;
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const bool on = live[j] && s0 + i < n;
      g[j][i] = on ? dh_final[(size_t(bi) * dim + dch) * n + s0 + i] : 0.f;
      a2[j][i] = on ? a[size_t(dch) * n + s0 + i] * kLog2e : 0.f;
      da[j][i] = 0.f;
    }
  }
  const size_t nbase = size_t(bi) * seq * n;
  const size_t plane = size_t(batch) * seq * n;
  float* const bc_mine = bc_part + size_t(blockIdx.x) * 2 * plane + nbase;
  const int chunks = (seq + kChunk - 1) / kChunk;
  // h before chunk ci of channel ch + j, state s0 + i (the forward's):
  // my_ckpt[ci * dim * n + j * n + i]
  const float* const my_ckpt =
      ckpt + (size_t(bi) * chunks * dim + d0 + ch) * n + s0;

  stage<T, kMaxN>(stages[(chunks - 1) % 2], x, delta, bm, cm, dy, xbase,
                  nbase, dim, d0, n, (chunks - 1) * kChunk, seq, vec);
  tc::cp_async_commit();
  for (int ci = chunks - 1; ci >= 0; --ci) {
    const int t0 = ci * kChunk;
    // stage ci - 1 takes the buffer of ci + 1, which every thread left
    // before the last barrier of chunk ci + 1
    if (ci > 0)
      stage<T, kMaxN>(stages[(ci - 1) % 2], x, delta, bm, cm, dy, xbase,
                      nbase, dim, d0, n, t0 - kChunk, seq, vec);
    tc::cp_async_commit();
    float h[kP][kQ];
#pragma unroll
    for (int j = 0; j < kP; ++j)
#pragma unroll
      for (int i = 0; i < kQ; ++i)
        h[j][i] = live[j] && s0 + i < n
                      ? my_ckpt[size_t(ci) * dim * n + j * n + i]
                      : 0.f;
    tc::cp_async_wait<1>();
    __syncthreads();   // chunk ci has landed; red is free
    const StageT& sg = stages[ci % 2];
    // h at the start of every sub-chunk, each thread its own states: the
    // checkpoint starts sub-chunk 0, h after the loop the last one
    for (int sc = 0; sc + 1 < kSubs; ++sc) {
      if (sc > 0) {
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          starts[((sc - 1) * kPer + e) * kThreads + tid] = h[e / kQ][e % kQ];
      }
      float ea[kP][kQ];
#pragma unroll
      for (int u = 0; u < kSub; ++u)
        advance<T, kMaxN>(sg, sc * kSub + u, ch, s0, a2, h, ea);
    }
    for (int sc = kSubs - 1; sc >= 0; --sc) {
      // hp[u]: h_{t-1} of step u of the sub-chunk, hp[u + 1]: h_t
      float hp[kSub + 1][kP][kQ], ea[kSub][kP][kQ];
      // this sub-chunk's rows of red
      float* const my_red = red + sc % G::kSumSubs * kSub * kThreads * kRow;
#pragma unroll
      for (int j = 0; j < kP; ++j)
#pragma unroll
        for (int i = 0; i < kQ; ++i)
          hp[0][j][i] =
              sc == kSubs - 1 ? h[j][i]
              : sc > 0 ? starts[((sc - 1) * kPer + j * kQ + i) * kThreads + tid]
              : live[j] && s0 + i < n
                  ? my_ckpt[size_t(ci) * dim * n + j * n + i]
                  : 0.f;
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
#pragma unroll
        for (int j = 0; j < kP; ++j)
#pragma unroll
          for (int i = 0; i < kQ; ++i) hp[u + 1][j][i] = hp[u][j][i];
        advance<T, kMaxN>(sg, sc * kSub + u, ch, s0, a2, hp[u + 1], ea[u]);
      }
      float acc[kV];   // [(u * kP + j) * 2 + k]: k 0 gb, 1 gd
#pragma unroll
      for (int u = kSub - 1; u >= 0; --u) {
        const int c = sc * kSub + u;
        const int ux = u % kXSteps;
        float dt[kP], xv[kP], dyv[kP], bv[kQ], cv[kQ];
        load_run<kP>(&sg.dt[c][ch], dt);
        load_run<kP>(&sg.x[c][ch], xv);
        load_run<kP>(&sg.dy[c][ch], dyv);
        load_run<kQ>(&sg.b[c][s0], bv);
        load_run<kQ>(&sg.c[c][s0], cv);
        float pbc[2 * kQ];   // [i]: dB_t shares, [kQ + i]: dC_t shares
#pragma unroll
        for (int i = 0; i < 2 * kQ; ++i) pbc[i] = 0.f;
#pragma unroll
        for (int j = 0; j < kP; ++j) {
          const float dtx = dt[j] * xv[j];
          float gb = 0.f, gd = 0.f;
#pragma unroll
          for (int i = 0; i < kQ; ++i) {
            g[j][i] = fmaf(cv[i], dyv[j], g[j][i]);
            const float geh = g[j][i] * ea[u][j][i] * hp[u][j][i];
            gb = fmaf(g[j][i], bv[i], gb);
            gd = fmaf(geh, a2[j][i], gd);
            da[j][i] = fmaf(geh, dt[j], da[j][i]);
            pbc[i] = fmaf(g[j][i], dtx, pbc[i]);
            pbc[kQ + i] = fmaf(dyv[j], hp[u + 1][j][i], pbc[kQ + i]);
            g[j][i] *= ea[u][j][i];
          }
          acc[(ux * kP + j) * 2] = gb;
          acc[(ux * kP + j) * 2 + 1] = gd;
        }
        // dB_t and dC_t of the thread's states, its channels summed, for
        // the block's sum over its channel groups
#pragma unroll
        for (int i = 0; i < 2 * kQ; i += 4)
          *reinterpret_cast<float4*>(my_red + (u * kThreads + tid) * kRow +
                                     i) =
              make_float4(pbc[i], pbc[i + 1], pbc[i + 2], pbc[i + 3]);
        if (ux == 0) {
          // steps c .. c + kXSteps: gb and gd meet across the group's
          // lanes, and their owners finish dx = delta gb + D dy and
          // ddelta = gb x + gd (gd summed in log2 units)
          int unused = 0;
          rec::reduce_scatter<kLanes, kV>(acc, lane, unused);
          float other = 0.f;
          if constexpr (kOwn == 1)
            other = __shfl_xor_sync(0xffffffffu, acc[0], kV / 2);
#pragma unroll
          for (int p = 0; p < kPairs; ++p) {
            const int cc = c + own_u[p], t = t0 + cc;
            if (!own_live[p] || t >= seq) continue;
            const float gbo = kOwn >= 2 ? acc[2 * p] : acc[0];
            const float gdo = kOwn >= 2 ? acc[2 * p + 1] : other;
            const float dto = sg.dt[cc][own_ch[p]];
            const float xo = to_f32(sg.x[cc][own_ch[p]]);
            const float dyo = to_f32(sg.dy[cc][own_ch[p]]);
            const size_t off = xbase + size_t(t) * dim + own_ch[p];
            dx[off] = from_f32<T>(fmaf(dto, gbo, own_skip[p] * dyo));
            ddelta[off] = fmaf(gbo, xo, gdo * kLn2);
            own_dd[p] = fmaf(dyo, xo, own_dd[p]);
          }
        }
      }
      if (sc % G::kSumSubs != 0) continue;
      // The dB / dC of sub-chunks sc .. sc + kSumSubs (at sc 0 every thread
      // is also done with the stage): each (step, state, dB or dC) sums
      // its rows over the block's channel groups in four fixed interleaved
      // partial sums.
      __syncthreads();
      for (unsigned e = tid; e < G::kSumSubs * kSub * kLanes * kRow;
           e += kThreads) {
        const unsigned u = e / (kLanes * kRow), r = e % kRow;
        const unsigned li = e / kRow % kLanes;
        const float* const from = red + u * kThreads * kRow + e % (
            kLanes * kRow);
        float part[4];
#pragma unroll
        for (int gr = 0; gr < G::kGroups; ++gr)
          part[gr % 4] = gr < 4 ? from[gr * kLanes * kRow]
                                : part[gr % 4] + from[gr * kLanes * kRow];
        const float sum = (part[0] + part[1]) + (part[2] + part[3]);
        const unsigned q = r / kQ, s = li * kQ + r % kQ;
        const int t = t0 + sc * kSub + u;
        if (t < seq && s < unsigned(n))
          bc_mine[q * plane + size_t(t) * n + s] = sum;
      }
      if (sc > 0) __syncthreads();   // red is free for the next steps
    }
  }
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    if (!live[j]) continue;
    const int dch = d0 + ch + j;
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      if (s0 + i < n) {
        const size_t off = (size_t(bi) * dim + dch) * n + s0 + i;
        dh0[off] = g[j][i];
        a_part[off] = da[j][i];
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kPairs; ++p)
    if (own_live[p])
      d_part[(size_t(bi) * kXSteps + own_u[p]) * dim + d0 + own_ch[p]] =
          own_dd[p];
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

template <typename T, int kMaxN>
constexpr size_t smem_bytes() {
  using G = Geo<T, kMaxN>;
  return 2 * sizeof(Stage<T, kMaxN>) +
         size_t(G::kRed + G::kStarts) * sizeof(float);
}

template <typename T, int kMaxN>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(ss_bwd_kernel<T, kMaxN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(smem_bytes<T, kMaxN>()));
}

template <typename T, int kMaxN>
cudaError_t launch(const void* x, const void* delta, const void* a,
                   const void* b, const void* c, const void* d,
                   const void* dy, const void* dh_final, const void* ckpt,
                   void* bc_part, void* a_part, void* d_part, void* dx,
                   void* ddelta, void* da, void* dbc, void* dd, void* dh0,
                   int batch, int seq, int dim, int n, cudaStream_t stream) {
  const int vec = dim % 8 == 0 &&
                  ((reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(delta) |
                    reinterpret_cast<uintptr_t>(dy)) % 16) == 0;
  cudaError_t err = allow_smem<T, kMaxN>();
  if (err != cudaSuccess) return err;
  const dim3 grid((dim + Geo<T, kMaxN>::kCh - 1) / Geo<T, kMaxN>::kCh, batch);
  ss_bwd_kernel<T, kMaxN><<<grid, kThreads, smem_bytes<T, kMaxN>(), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(delta),
      static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(d), static_cast<const T*>(dy),
      static_cast<const float*>(dh_final), static_cast<const float*>(ckpt),
      static_cast<T*>(dx), static_cast<float*>(ddelta),
      static_cast<float*>(dh0), static_cast<float*>(bc_part),
      static_cast<float*>(a_part), static_cast<float*>(d_part), batch, seq,
      dim, n, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = sum_parts(static_cast<const float*>(bc_part),
                  static_cast<float*>(dbc), int(grid.x),
                  2 * size_t(batch) * seq * n, stream);
  if (err == cudaSuccess)
    err = sum_parts(static_cast<const float*>(a_part),
                    static_cast<float*>(da), batch, size_t(dim) * n, stream);
  if (err == cudaSuccess)
    err = sum_parts(static_cast<const float*>(d_part),
                    static_cast<float*>(dd), batch * kXSteps, size_t(dim),
                    stream);
  return err;
}

// How many of the walk's blocks an SM holds.
template <typename T, int kMaxN>
cudaError_t occupancy(int* blocks_per_sm) {
  const cudaError_t err = allow_smem<T, kMaxN>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ss_bwd_kernel<T, kMaxN>, kThreads,
      smem_bytes<T, kMaxN>());
}

}  // namespace

// dtype codes shared with kernel.py: 0 float32, 1 bfloat16 (x, dy and dx;
// every other tensor is float32).  Shapes: x, delta, dy, dx, ddelta
// [B,S,D]; a, da [D,N]; b, c [B,S,N]; d, dd [D]; dh_final, dh0 [B,D,N];
// dbc [2][B,S,N] (dB then dC); ckpt [B,ceil(S/32),D,N] (h before every
// 32nd step, from the forward's checkpoint mode); scratch bc_part
// [blocks][2][B,S,N] (blocks = ceil(D / channels a block): 64 channels for
// N <= 16, 16 for N <= 64), a_part [B][D][N], d_part [B][kXSteps][D].
// seq >= 1.
extern "C" int selective_scan_bwd(
    const void* x, const void* delta, const void* a, const void* b,
    const void* c, const void* d, const void* dy, const void* dh_final,
    const void* ckpt, void* bc_part, void* a_part, void* d_part, void* dx,
    void* ddelta, void* da, void* dbc, void* dd, void* dh0, int batch,
    int seq, int dim, int n, int dtype, void* stream_handle) {
  cudaGetLastError();  // start from a clean error state
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
#define SS_BWD(T, MAXN)                                                   \
  return int(launch<T, MAXN>(x, delta, a, b, c, d, dy, dh_final, ckpt,    \
                             bc_part, a_part, d_part, dx, ddelta, da, dbc, \
                             dd, dh0, batch, seq, dim, n, stream))
  if (dtype == 0 && n >= 1 && n <= 16) SS_BWD(float, 16);
  if (dtype == 0 && n > 16 && n <= 64) SS_BWD(float, 64);
  if (dtype == 1 && n >= 1 && n <= 16) SS_BWD(__nv_bfloat16, 16);
  if (dtype == 1 && n > 16 && n <= 64) SS_BWD(__nv_bfloat16, 64);
#undef SS_BWD
  return int(cudaErrorInvalidValue);
}

// How many of the walk's blocks an SM holds for d_state n and the dtype
// code, into *blocks_per_sm; 0 means none fits.
extern "C" int selective_scan_bwd_occupancy(int n, int dtype,
                                            int* blocks_per_sm) {
  cudaGetLastError();
  if (dtype == 0 && n >= 1 && n <= 16)
    return int(occupancy<float, 16>(blocks_per_sm));
  if (dtype == 0 && n > 16 && n <= 64)
    return int(occupancy<float, 64>(blocks_per_sm));
  if (dtype == 1 && n >= 1 && n <= 16)
    return int(occupancy<__nv_bfloat16, 16>(blocks_per_sm));
  if (dtype == 1 && n > 16 && n <= 64)
    return int(occupancy<__nv_bfloat16, 64>(blocks_per_sm));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
