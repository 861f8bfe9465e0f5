// Thread-block clusters for Hopper (sm_90a): a block's rank in its
// cluster, the split cluster barrier, and loads from another block's
// shared memory (distributed shared memory).  Used by the WKV backward
// (rwkv6_scan/csrc/rwkv6_scan_bwd.cu), whose blocks of one head meet
// through their shared memory.
#pragma once

#include <stdint.h>

#include "cp_async.cuh"

namespace clu {

// this block's rank in its cluster (blockIdx.x % cluster size for a
// cluster that spans x only)
__device__ __forceinline__ uint32_t rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier in two halves.  Every thread of every block of the
// cluster arrives once, then waits once, before it arrives again.  What a
// thread wrote before its arrive (shared memory included) is visible to
// every thread of the cluster after its wait; between the two halves a
// thread may do work that needs no one else's.
__device__ __forceinline__ void arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void sync() {
  arrive();
  wait();
}

// The shared::cluster address of ``p`` (a variable of this block's shared
// memory) in the block of rank ``r`` of the cluster.
__device__ __forceinline__ uint32_t map(const void* p, uint32_t r) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(tc::smem_u32(p)), "r"(r));
  return a;
}

// a float at a shared::cluster address (from map)
__device__ __forceinline__ float load(uint32_t addr) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(x)
               : "r"(addr)
               : "memory");
  return x;
}

}  // namespace clu
