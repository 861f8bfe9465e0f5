// cp.async copies from global to shared memory, for Hopper (sm_90a),
// shared by the port's kernels: the attention kernels' Q/K/V tiles
// (tc_attention.cuh) and the two recurrence kernels' staged inputs
// (recurrence.cuh).  In namespace tc, where the attention kernels first
// used them.
#pragma once

#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses L1; with fill false the 16
// bytes are written as zeros and src is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(fill ? 16 : 0));
}
// 4-byte global -> shared copy; with fill false 4 zero bytes, src unread.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(fill ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tc
