// Tensor-core building blocks shared by the bf16 attention kernels
// (flash_attention.cu, paged_attention.cu), for Hopper (sm_90a).
//
// A block of 4 warps owns a tile of 64 query rows; each warp owns 16 of
// them.  Q, K and V tiles sit in shared memory as bf16, row-major with a
// row stride of kD + 8 elements (kD, the head_dim padded to a multiple of
// 16): a stride that is an odd multiple of 16 bytes puts the 8 rows an
// ldmatrix reads on 8 different 16-byte bank groups.  QK^T and PV run on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) with operands loaded by
// ldmatrix; the online softmax works on the f32 accumulator fragments, and
// P goes from the score fragments straight into the A operand of PV in
// registers, so no probability tile passes through shared memory.
//
// Fragment layouts (PTX ISA, mma.m16n8k16), for lane = 4 * g + t:
//   A (16 x 16):  a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..),
//                 a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..)
//   B (16 x 8):   b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g)
//   C (16 x 8):   c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same)
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileQ = 16 * kWarps;     // query rows per block
constexpr int kTileK = 64;              // keys per staged tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a * b on the tensor cores: one 16 x 8 x 16 product
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit; 2^-inf = 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Eight values converted to bf16 and stored as one 16-byte word.
__device__ __forceinline__ void store_bf16x8(__nv_bfloat16* dst,
                                             const float (&x)[8]) {
  uint4 w;
  w.x = pack_bf16(x[0], x[1]);
  w.y = pack_bf16(x[2], x[3]);
  w.z = pack_bf16(x[4], x[5]);
  w.w = pack_bf16(x[6], x[7]);
  *reinterpret_cast<uint4*>(dst) = w;
}

// One warp's state over the key walk: its 16 rows' accumulators (O, as
// kD / 8 C fragments), and per row half (rows g and g + 8) the running max
// (log2 units) and this thread's share of the running sum.
template <int kD>
struct WarpState {
  float o[kD / 8][4];
  float m[2];
  float l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }
};

// The warp's Q rows as A fragments, one per 16 columns of depth.
template <int kD>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[kD / 16][4],
                                             const __nv_bfloat16* q_w,
                                             int ld) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks)
    ldmatrix_x4(qf[ks], q_w + (lane & 15) * ld + ks * 16 + (lane >> 4) * 8);
}

// The mask of a tile whose every key counts for every row of the warp:
// passed as ``keep`` below, it costs nothing inside the causal limit.
struct AllKeys {
  __device__ __forceinline__ bool operator()(int, int) const { return true; }
};

// One key tile for one warp: S = Q K^T on the tensor cores, then the
// online softmax and O += P V.  ``q_w`` is the warp's 16 rows in shared
// memory (read only when kQRegs is false, else ``qf`` holds them);
// ``k_s``/``v_s`` hold kTileK keys.  ``score(x)`` maps a scaled score to
// its final value (softcap or identity); ``keep(half, j)`` says whether
// key j of the tile counts for row g + 8 * half.
template <int kD, bool kQRegs, typename Score, typename Keep>
__device__ __forceinline__ void attend_tile(
    WarpState<kD>& st, const uint32_t (&qf)[kQRegs ? kD / 16 : 1][4],
    const __nv_bfloat16* q_w, const __nv_bfloat16* k_s,
    const __nv_bfloat16* v_s, int ld, float scale, Score score, Keep keep) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  float s[kTileK / 8][4];
#pragma unroll
  for (int n = 0; n < kTileK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;

#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    uint32_t a[4];
    if constexpr (kQRegs) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qf[ks][i];
    } else {
      ldmatrix_x4(a, q_w + (lane & 15) * ld + ks * 16 + (lane >> 4) * 8);
    }
#pragma unroll
    for (int n2 = 0; n2 < kTileK / 16; ++n2) {
      uint32_t b[4];
      ldmatrix_x4(b, k_s + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                         ks * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * n2], a, b[0], b[1]);
      mma_bf16(s[2 * n2 + 1], a, b[2], b[3]);
    }
  }

  // mask and scale (log2 units), the rows' maxima over the quad
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kTileK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = n * 8 + 2 * t + (e & 1);
      const float x = keep(e >> 1, j) ? score(s[n][e] * scale) * kLog2e
                                      : -INFINITY;
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2], m_use[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(st.m[h], mx[h]);
    // a row no key has reached yet keeps m = -inf; exp2(-inf - 0) = 0
    m_use[h] = m_new == -INFINITY ? 0.f : m_new;
    alpha[h] = exp2_approx(st.m[h] - m_use[h]);
    st.m[h] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kTileK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(s[n][e] - m_use[e >> 1]);
      s[n][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * alpha[h] + sum[h];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    st.o[n][0] *= alpha[0];
    st.o[n][1] *= alpha[0];
    st.o[n][2] *= alpha[1];
    st.o[n][3] *= alpha[1];
  }

  // O += P V: the score fragments of keys 16j..16j+15 are the A fragment
#pragma unroll
  for (int j = 0; j < kTileK / 16; ++j) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
    a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
    a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
    a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
    const __nv_bfloat16* v_j =
        v_s + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
        (lane >> 4) * 8;
#pragma unroll
    for (int n2 = 0; n2 < kD / 16; ++n2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, v_j + n2 * 16);
      mma_bf16(st.o[2 * n2], a, b[0], b[1]);
      mma_bf16(st.o[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// The warp's normalized output: calls put(half, column, value) for the
// thread's entries (rows g and g + 8, columns < hd).  A row no key
// reached has l = 0 and o = 0, and gives 0.
template <int kD, typename Put>
__device__ __forceinline__ void finish(WarpState<kD>& st, int hd, Put put) {
  const int t = threadIdx.x & 3;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = st.l[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[h] = 1.f / (l + 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = n * 8 + 2 * t + (e & 1);
      if (d < hd) put(e >> 1, d, st.o[n][e] * inv[e >> 1]);
    }
}

}  // namespace tc
