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
// 67 TFLOP/s: the function needs 5 operations per state element and
// step, since the u term factors as v_t[j] * sum_i r_t[i] u[i] k_t[i]),
// so bytes bind, but not by much; and the recurrence is sequential in t,
// and one (b, h) has only hd-wide parallelism.  A decode step (S = 1) is all
// state traffic: 2 x 16 KB of f32 state per (b, h).
//
// What this first design does about it, and what it leaves for later:
//   * one block of hd threads per (b, h), the layout of the CUDA original
//     the Pallas notes name (kernel.py:4-6): thread j keeps column j of S
//     in registers for the whole sequence, so the state is read and
//     written once;
//   * r, k, v and w are staged in shared memory 2048 / hd steps at a time,
//     so one round of global-load latency is paid per chunk, not per
//     step, and a step needs no barrier: every thread reads the staged
//     r_t, k_t, w_t (broadcasts) and its own v_t[j];
//   * only B x H blocks run (32 of 132 SMs at B = 1); packing several
//     (b, h) per SM and splitting the sequence (chunked form) are later
//     work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, int kHd>
__global__ void __launch_bounds__(kHd) rwkv6_scan_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ s0, T* __restrict__ y,
    float* __restrict__ s_out, int seq, int heads) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;
  // time steps staged per round: 32 KB of static shared memory at any hd
  constexpr int kChunk = 2048 / kHd;

  __shared__ float r_s[kChunk][kHd];
  __shared__ float k_s[kChunk][kHd];
  __shared__ float w_s[kChunk][kHd];
  __shared__ float v_s[kChunk][kHd];
  __shared__ float u_s[kHd];

  u_s[j] = u[h * kHd + j];
  const size_t state = (size_t(b) * heads + h) * kHd * kHd;
  float st[kHd];
#pragma unroll
  for (int i = 0; i < kHd; ++i) st[i] = s0[state + size_t(i) * kHd + j];

  const size_t row = size_t(heads) * kHd;      // stride of one time step
  const size_t base = size_t(b) * seq * row + size_t(h) * kHd;
  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int nt = min(kChunk, seq - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int c = 0; c < nt; ++c) {
      const size_t off = base + size_t(t0 + c) * row + j;
      r_s[c][j] = to_f32(r[off]);
      k_s[c][j] = to_f32(k[off]);
      w_s[c][j] = to_f32(w[off]);
      v_s[c][j] = to_f32(v[off]);
    }
    __syncthreads();
    for (int c = 0; c < nt; ++c) {
      const float vj = v_s[c][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kHd; ++i) {
        const float kv = k_s[c][i] * vj;
        acc = fmaf(r_s[c][i], st[i] + u_s[i] * kv, acc);
        st[i] = fmaf(w_s[c][i], st[i], kv);
      }
      y[base + size_t(t0 + c) * row + j] = from_f32<T>(acc);
    }
  }
#pragma unroll
  for (int i = 0; i < kHd; ++i) s_out[state + size_t(i) * kHd + j] = st[i];
}

template <typename T, int kHd>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* s_out, int batch, int seq, int heads,
                   cudaStream_t stream) {
  const dim3 grid(heads, batch);
  rwkv6_scan_kernel<T, kHd><<<grid, kHd, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_out), seq, heads);
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
