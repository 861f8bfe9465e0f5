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
// the S * D * N = 134 M exponentials run on the special-function units,
// 16 results per clock per SM: ~32 us at 1.98 GHz, so the exponentials,
// not the bytes, are the likely floor of a design that computes each one.
// The recurrence is sequential in t; the parallelism is B * D * N.
//
// What this design does about it, and what it leaves for later:
//   * one block of 256 threads serves 64 channels of one batch row; four
//     threads share a channel and each keeps a run of N / 4 of its states
//     (and A, pre-scaled by log2(e) for ex2) in registers for the whole
//     sequence, so the state is read and written once and B = 1 at
//     D = 8192 still runs 128 blocks of 8 warps;
//   * x with delta (as one float2, coalesced across channels) and the
//     B_t / C_t rows (shared by every channel of the block, laid out so a
//     thread's states are one 16-byte load) are staged in shared memory
//     32 steps at a time; the next chunk's loads are issued into
//     registers, x in its own type, before the current chunk is computed,
//     so nothing waits on them; y is gathered in shared memory and stored
//     coalesced;
//   * the recurrence advances 8 steps at a time: the exponentials and
//     products of the group wait on nothing but their inputs, and the
//     group's partial y sums meet in one pipelined round of shuffles;
//     the exponential is ex2.approx.ftz, one special-function-unit op;
//   * what is left is per-step instruction issue and shared-memory
//     traffic in a sequential loop; at B = 1 one block per SM runs, so
//     more states or channels per warp (fewer shuffles and loads per
//     state) and a chunked two-pass form across the sequence are the
//     next steps;
//   * the TPU kernel's VMEM-resident [block_d, N] state tile and its
//     sequential chunk grid have no counterpart: a block walks the
//     whole sequence itself; a decode step (S = 1) is one partial chunk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 64;                  // channels per block
constexpr int kLanes = 4;                      // threads per channel
constexpr int kThreads = kChannels * kLanes;   // 256
constexpr int kChunk = 32;                     // steps staged per round
constexpr int kGroup = 8;                      // steps whose y sums meet
constexpr float kLog2e = 1.4426950408889634f;

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

// 2^x on the special-function unit, denormals flushed to zero (a state
// decays through them to nothing either way)
__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// kPer consecutive floats from 16-byte-aligned shared memory, in as few
// loads as their count allows
template <int kPer>
__device__ __forceinline__ void load_run(const float* p, float (&v)[kPer]) {
  if constexpr (kPer % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kPer; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else if constexpr (kPer == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = p[i];
  }
}

// Loads of one chunk: this thread's share of x / delta (channel
// tid % kChannels, steps tid / kChannels + k * kThreads / kChannels) and
// of the chunk's contiguous B / C rows.  Out-of-range entries keep 0.  x
// stays in its own type until it is staged, so no instruction waits on a
// load here: the loads are in flight while the previous chunk computes.
template <typename T, int kXLoads, int kBLoads>
__device__ __forceinline__ void fetch_chunk(
    const T* __restrict__ x, const float* __restrict__ delta,
    const float* __restrict__ bm, const float* __restrict__ cm,
    size_t xbase, size_t nbase, size_t row, bool col_live, int first_step,
    int tid, int t0, int seq, int n, T (&xr)[kXLoads],
    float (&dr)[kXLoads], float (&br)[kBLoads], float (&cr)[kBLoads]) {
  constexpr int kStepStride = kThreads / kChannels;
  const int nt = min(kChunk, seq - t0);
#pragma unroll
  for (int k = 0; k < kXLoads; ++k) {
    const int c = first_step + k * kStepStride;
    const size_t off = xbase + size_t(t0 + c) * row;
    xr[k] = from_f32<T>(0.f);
    dr[k] = 0.f;
    if (col_live && c < nt) {
      xr[k] = x[off];
      dr[k] = delta[off];
    }
  }
  const size_t boff = nbase + size_t(t0) * n;
#pragma unroll
  for (int k = 0; k < kBLoads; ++k) {
    const int e = tid + k * kThreads;
    br[k] = 0.f;
    cr[k] = 0.f;
    if (e < nt * n) {
      br[k] = bm[boff + e];
      cr[k] = cm[boff + e];
    }
  }
}

template <typename T, int kMaxN>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ delta,
    const float* __restrict__ a, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ dskip,
    const float* __restrict__ h0, T* __restrict__ y,
    float* __restrict__ h_out, int seq, int dim, int n) {
  constexpr int kPer = kMaxN / kLanes;                    // states a thread
  constexpr int kXLoads = kChunk * kChannels / kThreads;
  constexpr int kBLoads = (kChunk * kMaxN + kThreads - 1) / kThreads;
  constexpr int kStepStride = kThreads / kChannels;

  __shared__ float2 xd_s[kChunk][kChannels];               // (x, delta)
  __shared__ float y_s[kChunk][kChannels];
  __shared__ __align__(16) float b_s[kChunk][kMaxN];
  __shared__ __align__(16) float c_s[kChunk][kMaxN];

  const int tid = threadIdx.x;
  const int ch = tid / kLanes;          // the channel this thread computes
  const int lane = tid % kLanes;
  const int s0 = lane * kPer;           // its first state
  const int d0 = blockIdx.x * kChannels;
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
  const float skip = live ? dskip[dch] : 0.f;

  // the channel and first step this thread stages
  const int lj = tid % kChannels;
  const int lc = tid / kChannels;
  const size_t row = size_t(dim);
  const size_t xbase = size_t(bi) * seq * row + d0 + lj;
  const size_t nbase = size_t(bi) * seq * n;
  const bool lj_live = d0 + lj < dim;

  T xr[kXLoads];
  float dr[kXLoads], br[kBLoads], cr[kBLoads];
  if (seq > 0)
    fetch_chunk<T, kXLoads, kBLoads>(x, delta, bm, cm, xbase, nbase, row,
                                     lj_live, lc, tid, 0, seq, n, xr, dr,
                                     br, cr);
  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int nt = min(kChunk, seq - t0);
#pragma unroll
    for (int k = 0; k < kXLoads; ++k)
      xd_s[lc + k * kStepStride][lj] = make_float2(to_f32(xr[k]), dr[k]);
    // B / C rows at a stride of kMaxN, so a thread's states are one run
#pragma unroll
    for (int k = 0; k < kBLoads; ++k) {
      const int e = tid + k * kThreads;
      if (e < nt * n) {
        const int c = e / n;
        b_s[c][e - c * n] = br[k];
        c_s[c][e - c * n] = cr[k];
      }
    }
    __syncthreads();
    // the next chunk's loads are in flight while this one is computed
    if (t0 + kChunk < seq)
      fetch_chunk<T, kXLoads, kBLoads>(x, delta, bm, cm, xbase, nbase, row,
                                       lj_live, lc, tid, t0 + kChunk, seq,
                                       n, xr, dr, br, cr);
    // kGroup steps at a time: the state updates run in order, but the
    // exponentials and B/C products of the group do not wait on the
    // state, and the group's y sums meet in one pipelined round of
    // shuffles instead of a shuffle chain per step
    for (int c0 = 0; c0 < nt; c0 += kGroup) {
      float acc[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int c = c0 + u;
        acc[u] = 0.f;
        if (c < nt) {
          const float2 xd = xd_s[c][ch];
          const float dx = xd.y * xd.x;
          float bv[kPer], cv[kPer];
          load_run<kPer>(&b_s[c][s0], bv);
          load_run<kPer>(&c_s[c][s0], cv);
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            if (s0 + i < n) {
              const float da = exp2_ftz(xd.y * a2[i]);
              h[i] = fmaf(da, h[i], dx * bv[i]);
              acc[u] = fmaf(h[i], cv[i], acc[u]);
            }
          }
        }
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          if (c0 + u < nt)
            y_s[c0 + u][ch] = fmaf(skip, xd_s[c0 + u][ch].x, acc[u]);
      }
    }
    __syncthreads();
    for (int e = tid; e < nt * kChannels; e += kThreads) {
      const int c = e / kChannels;
      const int j = e % kChannels;
      if (d0 + j < dim)
        y[size_t(bi) * seq * row + size_t(t0 + c) * row + d0 + j] =
            from_f32<T>(y_s[c][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (live && s0 + i < n)
      h_out[(size_t(bi) * dim + dch) * n + s0 + i] = h[i];
  }
}

template <typename T, int kMaxN>
cudaError_t launch(const void* x, const void* delta, const void* a,
                   const void* b, const void* c, const void* d,
                   const void* h0, void* y, void* h_out, int batch, int seq,
                   int dim, int n, cudaStream_t stream) {
  const dim3 grid((dim + kChannels - 1) / kChannels, batch);
  selective_scan_kernel<T, kMaxN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(delta),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(d),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_out), seq, dim, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* delta, const void* a,
                     const void* b, const void* c, const void* d,
                     const void* h0, void* y, void* h_out, int batch,
                     int seq, int dim, int n, cudaStream_t stream) {
  if (n >= 1 && n <= 16)
    return launch<T, 16>(x, delta, a, b, c, d, h0, y, h_out, batch, seq,
                         dim, n, stream);
  if (n > 16 && n <= 64)
    return launch<T, 64>(x, delta, a, b, c, d, h0, y, h_out, batch, seq,
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
