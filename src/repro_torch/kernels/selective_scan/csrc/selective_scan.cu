// Mamba selective scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/selective_scan/kernel.py::selective_scan
//   (body _scan_kernel, pallas_call at kernel.py:79).
// It computes the same function, per (batch, channel d), with an f32
// state h [N]:
//   h[n] <- exp(delta_t[d] * A[d][n]) * h[n] + delta_t[d] * x_t[d] * B_t[n]
//   y_t[d] = sum_n C_t[n] * h[n] + D[d] * x_t[d]
// from h0 (the caller passes zeros for none), returning y in x's dtype
// (formed in f32, rounded once) and the final state in f32.  Any sequence
// length and any channel count: the Pallas kernel's S % chunk and
// D % block_d rules come from its BlockSpec, not from the function.
//
// What bounds it on an H100: at Jamba's prefill shape (B = 1, S = 1024,
// D = 8192, N = 16, x bf16, delta / B / C f32) the inputs, y and the
// states are ~69 MB (~21 us at 3.35 TB/s) against ~0.96 Gop of f32 work
// (~14 us at 67 TFLOP/s), so bytes bind by the data sheet's rates.  But
// the S * D * N = 134 M exponentials on the special-function units, 16
// results a clock per SM, take ~32 us at 1.98 GHz, and the ~5 issued
// instructions per state and step (~20 us at 4 a clock per SM) come close
// behind.  The recurrence is sequential in t; the parallelism is B * D * N.
//
// The first design (64 channels x 4 lanes = 256 threads a block; 32-step
// chunks with two barriers each, the next chunk's loads held in
// registers; per-step guards on the state count; an all-reduce of every
// y sum) ran at 7.3x the bound and 4.7x the exponential floor.  This
// design:
//   * keeps the first design's block, 64 channels x 4 lanes = 256 threads
//     (128 blocks at B = 1): smaller blocks, two or four an SM, measured
//     no faster once a chunk costs one barrier.  Each thread keeps N / 4
//     states of one channel (and A, pre-scaled by log2 e) in registers
//     for the whole sequence;
//   * stages x, delta (16-byte cp.async) and the B_t / C_t rows (4-byte
//     cp.async, at a stride of the build's state count, so a thread's run
//     is one vector load) 64 steps at a time into two buffers: the next
//     chunk loads while this one computes, one barrier a chunk (32-step
//     chunks, twice the barriers, measured slower); each thread copies
//     fixed pieces, so a copy costs a few instructions.  Steps past the
//     sequence and states past N are staged as zeros, which leave the
//     state as it is, so no step or state is checked;
//   * takes 8 steps at a time (1 for a call of fewer than 8 steps): their
//     partial y sums meet in one reduce-scatter across the channel's 4
//     lanes (6 shuffles a lane, not 16), after which each lane stores 2 of
//     the 8 y values; D x joins the sum on the channel's first lane;
//     groups run in pairs, so one group's sums meet while the next group
//     computes;
//   * computes every exponential on the special-function units
//     (ex2.approx.ftz): moving a share of them onto the FMA pipes (a
//     degree-6 polynomial) made the kernel slower at every share tried, a
//     sign that issue and latency, not the SFUs, set its pace;
//   * leaves a chunked two-pass form across the sequence for later: it
//     recomputes or stores the exponentials and does not pay at Jamba's
//     shape.
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
constexpr int kLongChunk = 64;   // steps staged per round (1-step groups: 8)
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// One stage in shared memory for a build holding up to kMaxN states and
// meeting its y sums every kGroup steps: kLanes threads share a channel,
// kChannels channels a block, kChunk steps a stage.
template <typename T, int kMaxN, int kGroup>
struct Stage {
  static constexpr int kLanes = kMaxN / kPer;
  static constexpr int kChannels = kThreads / kLanes;
  static constexpr int kChunk = kGroup == 1 ? 8 : kLongChunk;
  float dt[kChunk][kChannels];
  float b[kChunk][kMaxN];
  float c[kChunk][kMaxN];
  T x[kChunk][kChannels];
};

// Copies steps t0 .. of the block's channels into a stage, up to the end
// of the pair of groups (2 kGroup steps) that holds the last live step;
// steps past seq and channels past dim become zeros, and so do states past
// n (set once by the kernel, never copied over).  vec: x and delta
// 16-byte aligned with dim % 8 == 0, copied 16 bytes at a time; otherwise
// element by element.  B and C rows go 4 bytes at a time.
template <typename T, int kMaxN, int kGroup>
__device__ __forceinline__ void stage_chunk(
    Stage<T, kMaxN, kGroup>& sg, const T* __restrict__ x,
    const float* __restrict__ delta, const float* __restrict__ bm,
    const float* __restrict__ cm, size_t xbase, size_t nbase, int dim,
    int d0, int n, int t0, int seq, bool vec) {
  constexpr int kCh = Stage<T, kMaxN, kGroup>::kChannels;
  constexpr int kChunk = Stage<T, kMaxN, kGroup>::kChunk;
  constexpr int kPair = 2 * kGroup;
  const int tid = threadIdx.x;
  const int nt = min(kChunk, seq - t0);
  const int len = min(kChunk, (nt + kPair - 1) / kPair * kPair);
  // B and C: each thread copies one state of every kBPass-th step
  constexpr int kBPass = kThreads / kMaxN;
  const int s = tid % kMaxN;
  if (s < n) {
    const int c_b = tid / kMaxN;
    size_t off = nbase + size_t(t0 + c_b) * n + s;
    for (int c = c_b; c < len; c += kBPass, off += size_t(kBPass) * n) {
      const bool live = c < nt;
      tc::cp_async4(&sg.b[c][s], live ? bm + off : bm, live);
      tc::cp_async4(&sg.c[c][s], live ? cm + off : cm, live);
    }
  }
  if (vec) {
    // x and delta: each thread copies one 16-byte piece of every kPass-th
    // step
    constexpr int kXPer = 16 / int(sizeof(T));
    constexpr int kXCopies = kCh / kXPer, kXPass = kThreads / kXCopies;
    constexpr int kDCopies = kCh / 4, kDPass = kThreads / kDCopies;
    const int c_x = tid / kXCopies, p_x = tid % kXCopies * kXPer;
    const bool x_live = d0 + p_x < dim;
    const T* from_x = x + xbase + size_t(t0 + c_x) * dim + p_x;
    for (int c = c_x; c < len; c += kXPass, from_x += size_t(kXPass) * dim) {
      const bool live = c < nt && x_live;
      tc::cp_async16(&sg.x[c][p_x], live ? from_x : x, live);
    }
    const int c_d = tid / kDCopies, p_d = tid % kDCopies * 4;
    const bool d_live = d0 + p_d < dim;
    const float* from_d = delta + xbase + size_t(t0 + c_d) * dim + p_d;
    for (int c = c_d; c < len; c += kDPass, from_d += size_t(kDPass) * dim) {
      const bool live = c < nt && d_live;
      tc::cp_async16(&sg.dt[c][p_d], live ? from_d : delta, live);
    }
  } else {
    for (int e = tid; e < len * kCh; e += kThreads) {
      const int c = e / kCh, j = e - c * kCh;
      const bool live = c < nt && d0 + j < dim;
      const size_t off = xbase + size_t(t0 + c) * dim + j;
      sg.x[c][j] = live ? x[off] : from_f32<T>(0.f);
      sg.dt[c][j] = live ? delta[off] : 0.f;
    }
  }
}

// kGroup steps from step c0 of a staged chunk: each thread advances its
// states and leaves its share of y for every step in acc.  Steps past the
// sequence are zeros (delta 0: the state stays), so no step is checked.
template <typename T, int kMaxN, int kGroup>
__device__ __forceinline__ void scan_group(
    const Stage<T, kMaxN, kGroup>& sg, int c0, int ch, int s0, float skip,
    const float (&a2)[kPer], float (&h)[kPer], float (&acc)[kGroup]) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int c = c0 + u;
    const float xv = to_f32(sg.x[c][ch]);
    const float dt = sg.dt[c][ch];
    float bv[kPer], cv[kPer];
    load_run<kPer>(&sg.b[c][s0], bv);
    load_run<kPer>(&sg.c[c][s0], cv);
    const float dx = dt * xv;
    float sum = skip * xv;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      h[i] = fmaf(rec::exp2_sfu(dt * a2[i]), h[i], dx * bv[i]);
      sum = fmaf(h[i], cv[i], sum);
    }
    acc[u] = sum;
  }
}

// The shares of y of one group (steps t .. t + kGroup) meet across the
// channel's lanes; the lane that ends up owning a value stores it, for
// steps before `end`.
template <typename T, int kMaxN, int kGroup>
__device__ __forceinline__ void scan_store(float (&acc)[kGroup], int lane,
                                           int t, int end,
                                           T* __restrict__ y, size_t yoff,
                                           int dim) {
  constexpr int kLanes = Stage<T, kMaxN, kGroup>::kLanes;
  constexpr int kOwn = kGroup >= kLanes ? kGroup / kLanes : 1;
  int first = 0;
  rec::reduce_scatter<kLanes, kGroup>(acc, lane, first);
  if (rec::owns_sum<kLanes, kGroup>(lane)) {
#pragma unroll
    for (int q = 0; q < kOwn; ++q)
      if (t + first + q < end)
        y[yoff + size_t(t + first + q) * dim] = from_f32<T>(acc[q]);
  }
}

template <typename T, int kMaxN, int kGroup>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ delta,
    const float* __restrict__ a, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ dskip,
    const float* __restrict__ h0, T* __restrict__ y,
    float* __restrict__ h_out, int seq, int dim, int n, int vec) {
  using StageT = Stage<T, kMaxN, kGroup>;
  constexpr int kLanes = StageT::kLanes;
  constexpr int kCh = StageT::kChannels;
  constexpr int kChunk = StageT::kChunk;
  extern __shared__ __align__(16) unsigned char smem[];
  StageT* const stages = reinterpret_cast<StageT*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int ch = tid / kLanes;            // the channel this thread computes
  const int s0 = (tid % kLanes) * kPer;   // its first state
  const int d0 = blockIdx.x * kCh;
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
  // D x joins the y sums on the channel's first lane
  const float skip = live && s0 == 0 ? dskip[dch] : 0.f;
  // states past n: B and C stay 0 in both stages
  for (int e = tid; e < kStages * kChunk * kMaxN; e += kThreads) {
    const int st = e / (kChunk * kMaxN), rem = e - st * kChunk * kMaxN;
    const int c = rem / kMaxN, s = rem - c * kMaxN;
    if (s >= n) {
      stages[st].b[c][s] = 0.f;
      stages[st].c[c][s] = 0.f;
    }
  }

  const size_t xbase = size_t(bi) * seq * dim + d0;
  const size_t nbase = size_t(bi) * seq * n;
  const int chunks = (seq + kChunk - 1) / kChunk;
  // groups run in pairs (a and b), and the y sums of one group meet while
  // the next group computes; b first holds the pair before's second group
  // (steps b_t .., stored up to b_end; a channel past dim stores nothing)
  float acc_a[kGroup], acc_b[kGroup] = {};
  int b_t = 0, b_end = 0;
  const int end = live ? seq : 0;
  const size_t yoff = xbase + ch;
  // kStages - 1 chunks in flight ahead of the one computed
  for (int ci = 0; ci < kStages - 1; ++ci) {
    if (ci < chunks)
      stage_chunk<T, kMaxN, kGroup>(stages[ci], x, delta, bm, cm, xbase,
                                    nbase, dim, d0, n, ci * kChunk, seq, vec);
    tc::cp_async_commit();
  }
  for (int ci = 0; ci < chunks; ++ci) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk ci has landed; every thread is past ci - 1
    const int t0 = ci * kChunk;
    const int next = ci + kStages - 1;
    if (next < chunks)
      stage_chunk<T, kMaxN, kGroup>(stages[next % kStages], x, delta, bm, cm,
                                    xbase, nbase, dim, d0, n, next * kChunk,
                                    seq, vec);
    tc::cp_async_commit();
    const StageT& sg = stages[ci % kStages];
    const int nt = min(kChunk, seq - t0);
    for (int c0 = 0; c0 < nt; c0 += 2 * kGroup) {
      scan_group<T, kMaxN, kGroup>(sg, c0, ch, s0, skip, a2, h, acc_a);
      scan_store<T, kMaxN, kGroup>(acc_b, lane, b_t, b_end, y, yoff, dim);
      scan_group<T, kMaxN, kGroup>(sg, c0 + kGroup, ch, s0, skip, a2, h,
                                   acc_b);
      scan_store<T, kMaxN, kGroup>(acc_a, lane, t0 + c0, end, y, yoff, dim);
      b_t = t0 + c0 + kGroup;
      b_end = end;
    }
  }
  scan_store<T, kMaxN, kGroup>(acc_b, lane, b_t, b_end, y, yoff, dim);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (live && s0 + i < n)
      h_out[(size_t(bi) * dim + dch) * n + s0 + i] = h[i];
  }
}

template <typename T, int kMaxN, int kGroup>
cudaError_t launch(const void* x, const void* delta, const void* a,
                   const void* b, const void* c, const void* d,
                   const void* h0, void* y, void* h_out, int batch, int seq,
                   int dim, int n, cudaStream_t stream) {
  constexpr int kCh = Stage<T, kMaxN, kGroup>::kChannels;
  const int vec = dim % 8 == 0 &&
                  ((reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(delta)) % 16) == 0;
  const size_t smem = kStages * sizeof(Stage<T, kMaxN, kGroup>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        selective_scan_kernel<T, kMaxN, kGroup>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((dim + kCh - 1) / kCh, batch);
  selective_scan_kernel<T, kMaxN, kGroup><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(delta),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(d),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_out), seq, dim, n, vec);
  return cudaGetLastError();
}

// A call of a few steps (a decode step) meets its y sums every step; a
// longer one every 8 steps.
template <typename T, int kMaxN>
cudaError_t launch_for(const void* x, const void* delta, const void* a,
                       const void* b, const void* c, const void* d,
                       const void* h0, void* y, void* h_out, int batch,
                       int seq, int dim, int n, cudaStream_t stream) {
  if (seq < 8)
    return launch<T, kMaxN, 1>(x, delta, a, b, c, d, h0, y, h_out, batch,
                               seq, dim, n, stream);
  return launch<T, kMaxN, 8>(x, delta, a, b, c, d, h0, y, h_out, batch, seq,
                             dim, n, stream);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* delta, const void* a,
                     const void* b, const void* c, const void* d,
                     const void* h0, void* y, void* h_out, int batch,
                     int seq, int dim, int n, cudaStream_t stream) {
  if (n >= 1 && n <= 16)
    return launch_for<T, 16>(x, delta, a, b, c, d, h0, y, h_out, batch, seq,
                             dim, n, stream);
  if (n > 16 && n <= 64)
    return launch_for<T, 64>(x, delta, a, b, c, d, h0, y, h_out, batch, seq,
                             dim, n, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes shared with kernel.py: 0 float32, 1 bfloat16 (x and y; every
// other tensor is float32).
extern "C" int selective_scan(const void* x, const void* delta,
                              const void* a, const void* b, const void* c,
                              const void* d, const void* h0, void* y,
                              void* h_out, int batch, int seq, int dim,
                              int n, int dtype, void* stream_handle) {
  cudaGetLastError();  // start from a clean error state
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (dtype == 0)
    return int(dispatch<float>(x, delta, a, b, c, d, h0, y, h_out, batch,
                               seq, dim, n, stream));
  if (dtype == 1)
    return int(dispatch<__nv_bfloat16>(x, delta, a, b, c, d, h0, y, h_out,
                                       batch, seq, dim, n, stream));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
