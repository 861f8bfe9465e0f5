// Device code shared by the two recurrence kernels (rwkv6_scan.cu and
// selective_scan.cu), for Hopper (sm_90a): conversions, vector loads of a
// thread's run of staged values, the reduce-scatter in which the lanes
// that split a sum meet, and 2^x on the special-function unit.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace rec {

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

// kN consecutive values from shared memory as f32, in as few loads as
// their count allows; p is aligned to the run's size in bytes (a run
// starts at a multiple of kN elements of a 16-byte-aligned array).
template <int kN>
__device__ __forceinline__ void load_run(const float* p, float (&v)[kN]) {
  if constexpr (kN % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kN; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else if constexpr (kN == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = p[i];
  }
}

// a bf16 pair packed in 32 bits, widened exactly to two floats
__device__ __forceinline__ void widen_pair(uint32_t w, float& lo,
                                           float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

template <int kN>
__device__ __forceinline__ void load_run(const __nv_bfloat16* p,
                                         float (&v)[kN]) {
  if constexpr (kN % 8 == 0) {
#pragma unroll
    for (int i = 0; i < kN; i += 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + i);
      widen_pair(q.x, v[i], v[i + 1]);
      widen_pair(q.y, v[i + 2], v[i + 3]);
      widen_pair(q.z, v[i + 4], v[i + 5]);
      widen_pair(q.w, v[i + 6], v[i + 7]);
    }
  } else if constexpr (kN == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    widen_pair(q.x, v[0], v[1]);
    widen_pair(q.y, v[2], v[3]);
  } else if constexpr (kN == 2) {
    widen_pair(*reinterpret_cast<const uint32_t*>(p), v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = __bfloat162float(p[i]);
  }
}

// Sums a[] over the kLanes lanes of a warp that differ only in their low
// log2(kLanes) bits (kLanes a power of 2, at most 32).  Each round halves
// what a lane holds: it keeps one half of its sums, sends the other half
// to its partner and adds the half that comes back, so kV sums meet in
// about kV shuffles a lane in all, not kV * log2(kLanes).  On return
// a[0 .. kV / kLanes) hold the totals of entries first, first + 1, ... of
// the a[] every lane started with (a[0] alone once kV <= kLanes; then the
// lanes that differ in the bits above log2(kV) hold the same total, and
// owns_sum() names one of them).
template <int kLanes, int kV, int kM = 1, int kN = kV>
__device__ __forceinline__ void reduce_scatter(float (&a)[kV], int lane,
                                               int& first) {
  if constexpr (kM < kLanes) {
    if constexpr (kN > 1) {
      constexpr int kH = kN / 2;
      const bool up = lane & kM;
#pragma unroll
      for (int i = 0; i < kH; ++i) {
        const float send = up ? a[i] : a[i + kH];
        const float keep = up ? a[i + kH] : a[i];
        a[i] = keep + __shfl_xor_sync(0xffffffffu, send, kM);
      }
      if (up) first += kH;
      reduce_scatter<kLanes, kV, kM * 2, kH>(a, lane, first);
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], kM);
      reduce_scatter<kLanes, kV, kM * 2, 1>(a, lane, first);
    }
  }
}

template <int kLanes, int kV>
__device__ __forceinline__ bool owns_sum(int lane) {
  if constexpr (kV >= kLanes) {
    return true;
  } else {
    return (lane & (kLanes - 1) & ~(kV - 1)) == 0;
  }
}

// 2^x on the special-function unit (MUFU.EX2, 16 a clock per SM),
// denormal results flushed to zero
__device__ __forceinline__ float exp2_sfu(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

}  // namespace rec
