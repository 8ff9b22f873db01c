// Tensor-core building blocks shared by the kernels that run on Hopper's
// tensor cores with warp-level mma.sync (conv3d_mma.cuh, the K2 bodies of
// conv3d_mma.cu and conv3d_mma_f32.cu; upsample3d_2x_mma.cu, K3 in
// bfloat16): ldmatrix fragment loads, the m16n8k16 bfloat16 MMA with
// float32 accumulators, and the shared-memory row pitch that keeps
// ldmatrix free of bank conflicts.  The cp.async copies and the dynamic
// shared-memory helpers are common.cuh's (ltk_async).
#pragma once

#include "common.cuh"

namespace ltk_mma {

using namespace ltk_async;

// Row pitch in bytes of `elems` bfloat16 values padded to an odd number of
// 16-byte units (conflict-free ldmatrix over 8 consecutive rows).
__host__ __device__ constexpr int odd_pitch(int elems) {
  return ((elems / 8 + 1) % 2 ? elems / 8 + 1 : elems / 8 + 2) * 16;
}

// An m16k16 A fragment: lanes 0-15 give rows 0-15 at k 0-7, lanes 16-31
// the same rows at k 8-15.
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two k16n8 B fragments from a K x N row-major tile.
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned& r0,
                                          unsigned& r1, unsigned& r2,
                                          unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned addr, unsigned& r0,
                                          unsigned& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// d += a (m16 x k16, bfloat16) * b (k16 x n8, bfloat16), float32 d.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace ltk_mma
