// Warp-level bf16 tensor-core product shared by the port's kernels.
//
// mma.sync.m16n8k16 with bf16 inputs and f32 accumulation. Fragment layout
// (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with g = lane / 4 and
// t = lane % 4; each 32-bit register holds two bf16, the lower column in
// the low half:
//   A (16x16, row-major): a0 = (g,   2t..2t+1)   a1 = (g+8, 2t..2t+1)
//                         a2 = (g,   2t+8..+9)   a3 = (g+8, 2t+8..+9)
//   B (16x8, "col"):      b0 = (k = 2t..2t+1, n = g)
//                         b1 = (k = 2t+8..+9, n = g)
//   C/D (16x8, f32):      c0,c1 = (g, 2t..2t+1)  c2,c3 = (g+8, 2t..2t+1)
// So B is read from a matrix stored with n as the row and k contiguous.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 at p (4-byte aligned) as one 32-bit fragment register.
__device__ __forceinline__ uint32_t ld_bf16x2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Round two f32 to bf16 (nearest-even) and pack, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
