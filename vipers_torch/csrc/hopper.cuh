// Hopper (sm_90a) building blocks of the port's kernels, shared by
// attention_tile.cuh (the flash, packed and splash bf16 tile),
// attention_train.cu (the training forward and backward) and fused_mlp.cu
// (LN -> fc1 -> GELU), and of the f32 flash backward (flash_attention_bwd.cu),
// which multiplies f32 on TF32 tensor cores in three products. Device side:
// shared-memory addresses, mbarriers, TMA loads (tensor maps and plain bulk
// copies), the async-proxy fence, named barriers, stmatrix, bf16 packing,
// ex2, the 128- and 32-byte-swizzle wgmma descriptors and the wgmma shapes
// the kernels use; for f32 operands the TF32 rounding and big/small split, the
// index and descriptor of an f32 tile in 128-byte-swizzled halves, and the
// TF32 wgmma shapes.
// Host side: cuTensorMapEncodeTiled through the runtime's driver entry
// point, 3-D bf16 (64-column and 16-column tail boxes) and f32 maps, and the
// once-a-device launch set-up.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace hopper {

constexpr int BOX_COLS = 64;      // bf16 columns of a map's box: one 128-byte swizzle row
constexpr int TAIL_BOX_COLS = 16; // bf16 columns of a tail map's box: one 32-byte swizzle row
constexpr int F32_BOX_COLS = 32;  // f32 columns of a map's box: one 128-byte swizzle row
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// One box of `map` at (c0, c1, c2) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` into shared memory, completing
// on `bar`; both addresses 16-byte aligned.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma operands, TMA): after the writes, before the barrier
// that hands them to the reader.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads, a
// multiple of 32.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Four 8x8 bf16 matrices from the mma fragment layout (register i: row
// lane / 4, columns 2 (lane % 4) and + 1 of matrix i) to shared memory;
// lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// Round two f32 to bf16 (nearest-even) and pack, lo in the low half (the
// order of an mma fragment register).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at `addr`
// (1024-byte aligned, the swizzle atom, plus any offset within a row):
// start address, leading and stride byte offsets (16-byte units), layout 1
// (SWIZZLE_128B); 8-row groups lie 1024 bytes apart (the stride offset).
// K-major operands ([row][k], 64 k a row) leave the leading offset unused
// (16) and step 16 k as 32 bytes along the row. MN-major operands ([k][row],
// 64 of M or N a row, read through the transpose bit) step 16 k as 2048
// bytes; the leading offset is the distance to the tile of the next 64 of M
// or N, unused where there is one (given 1024 there).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lead) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma shared-memory descriptor of a 32-byte-swizzled tile at `addr`
// (256-byte aligned, the swizzle atom): rows of 32 bytes (16 bf16), layout 3
// (SWIZZLE_32B), 8-row groups 256 bytes apart (the stride offset); one atom
// across, so the leading offset is unused. K-major ([row][16 k]) it is one
// k16 step; MN-major ([k][16 of N], through the transpose bit) a k16 step
// is 512 bytes.
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(256 >> 4) << 32) |
         (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N of this thread's wgmma groups are pending (groups
// complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
}

// The same for register-A fragments, which the product reads after it is
// started: they stay as they are until the wait that follows.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// D (64 x 32, f32) {=, +=} A (64 x 16) . B (16 x 32), both bf16 K-major in
// shared memory (descriptors); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16, f32) {=, +=} A (64 x 16) . B (16 x 16), both bf16 MN-major in
// shared memory: the transpose bits on A and B; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n16_tt(float (&d)[2][4], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) {=, +=} A (64 x 16) . B (16 x 64), both bf16 MN-major in
// shared memory: the transpose bits on A and B; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64_tt(float (&d)[8][4], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) {=, +=} A (64 x 16) . B (16 x 64), A bf16 K-major in
// shared memory, B K-major (TB = 0) or MN-major through the transpose bit
// (TB = 1); scale_d = 0 overwrites D.
template <int TB = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D (64 x 128, f32) {=, +=} A (64 x 16) . B (16 x 128), A bf16 K-major in
// shared memory, B K-major (TB = 0) or MN-major through the transpose bit
// (TB = 1); scale_d = 0 overwrites D.
template <int TB = 0>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers, the mma.sync A layout
// per warp) . B (16 x 64, bf16 MN-major in shared memory: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[8][4], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 16, f32) += A (64 x 16, bf16 in registers, the mma.sync A layout
// per warp) . B (16 x 16, bf16 MN-major in shared memory: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n16_tb(float (&d)[2][4], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------- f32 on TF32 tensor cores
//
// wgmma multiplies TF32 (an f32 with 10 mantissa bits) into f32 sums and
// reads TF32 operands from shared memory K-major only (the transpose bits
// exist for 16-bit types alone). An f32 product a.b keeps f32 accuracy as
// three TF32 products (CUTLASS's OpMultiplyAddFastF32, "3xTF32"): each
// operand x splits into big = tf32(x) and small = tf32(x - big), and a.b =
// small_a.big_b + big_a.small_b + big_a.big_b into one f32 sum (small.small
// is below f32's rounding). One TF32 product alone keeps about 1e-3.

// x rounded to TF32, nearest with ties away from zero (low 13 bits zero).
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x as big + small, both TF32.
__device__ __forceinline__ void tf32_split(float x, float& big, float& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - big);
}

// An f32 tile of ROWS rows x 64 columns in shared memory, as TMA writes it
// with the 128-byte swizzle in boxes of 32 columns: two halves of ROWS x 32
// floats (128 bytes a row), columns 0-31 then 32-63, each 1024-byte aligned
// (a wider tile: one such part each 32 columns). The float index of element
// (r, c):
template <int ROWS>
__device__ __forceinline__ int f32_at(int r, int c) {
  return (c >> 5) * ROWS * 32 + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) + (c & 3);
}

// The K-major wgmma descriptor of k step kk (8 columns = 32 bytes) of such a
// tile whose rows start at `rows` (shared address, 1024-byte aligned): half
// kk / 4, 32 bytes a step within the swizzled row, 8-row groups 1024 bytes
// apart. A tile of 32 columns is one half.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_f32(uint32_t rows, int kk) {
  return desc_sw128(rows + (kk >> 2) * ROWS * 128 + (kk & 3) * 32, 16);
}

// D (64 x 32, f32) {=, +=} A (64 x 8) . B (8 x 32), both TF32 K-major in
// shared memory; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[4][4], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, f32) {=, +=} A (64 x 8, TF32 in registers, wgmma_tf32_rs_n64's
// layout) . B (8 x 32, TF32 K-major in shared memory); scale_d = 0
// overwrites D.
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[4][4], const float (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) {=, +=} A (64 x 8, TF32 in registers) . B (8 x 64, TF32
// K-major in shared memory). A per warp is the mma.sync tf32 layout: a[0]
// row g, column tg; a[1] row g + 8, column tg; a[2], a[3] the same rows at
// column tg + 4 (g = lane / 4, tg = lane % 4).
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[8][4], const float (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "l"(db), "r"(scale_d));
}

// D (64 x 16, f32) {=, +=} A (64 x 8, TF32 in registers, wgmma_tf32_rs_n64's
// layout) . B (8 x 16, TF32 K-major in shared memory); scale_d = 0
// overwrites D.
__device__ __forceinline__ void wgmma_tf32_rs_n16(float (&d)[2][4], const float (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "l"(db), "r"(scale_d));
}

// This thread's TF32 A fragments (wgmma_tf32_rs_n64's layout) of rows r
// and r + 8 (r = 16 warp + g of a warpgroup's 64) of a ROWS-row f32 tile
// (f32_at), for the COLS / 8 k steps over its first COLS columns (8kk + tg
// and + 4), split into big and small.
template <int ROWS, int COLS = 64>
__device__ __forceinline__ void load_a_f32(const float* tile, int r, int tg,
                                           float (&big)[COLS / 8][4],
                                           float (&small)[COLS / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < COLS / 8; ++kk) {
    const int c = 8 * kk + tg;
    tf32_split(tile[f32_at<ROWS>(r, c)], big[kk][0], small[kk][0]);
    tf32_split(tile[f32_at<ROWS>(r + 8, c)], big[kk][1], small[kk][1]);
    tf32_split(tile[f32_at<ROWS>(r, c + 4)], big[kk][2], small[kk][2]);
    tf32_split(tile[f32_at<ROWS>(r + 8, c + 4)], big[kk][3], small[kk][3]);
  }
}

// An f32 accumulator's 8-column group j (C layout: row g columns 2tg and 2tg
// + 1 in c[j][0], c[j][1], row g + 8 in c[j][2], c[j][3]) as the A fragment
// of an 8-deep k step, its columns permuted within the group: a[0..3] =
// c[j][0], c[j][2], c[j][1], c[j][3], so the fragment's column h < 4 is
// column 2h and column h >= 4 is column 2(h - 4) + 1. The B operand of
// that product stores its k rows in the same order (tf32_perm); only the
// order of the sum changes. Split into big and small parts.
__device__ __forceinline__ void tf32_a_frag(const float (&c)[4], float (&big)[4],
                                            float (&small)[4]) {
  tf32_split(c[0], big[0], small[0]);
  tf32_split(c[2], big[1], small[1]);
  tf32_split(c[1], big[2], small[2]);
  tf32_split(c[3], big[3], small[3]);
}

// Where k index i of an 8-group goes in a B operand read with tf32_a_frag's
// order: even i at i / 2, odd i at 4 + i / 2.
__device__ __forceinline__ int tf32_perm(int i) {
  return (i & ~7) | ((i & 1) << 2) | ((i & 7) >> 1);
}

// ------------------------------------------------------------------ host

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that the libraries link nothing beyond the CUDA runtime (by version
// from CUDA 12.5 on, where the unversioned query is deprecated).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D map over (outer, rows, cols) elements of `type` (`elem` bytes):
// row stride ld and outer stride outer_ld elements, boxes of box_rows x
// box_cols (one swizzle row) with the 128-byte swizzle, or `swizzle`; rows
// and columns beyond `rows` and `cols` read as zeros. Returns a cudaError_t.
inline int encode_map_of(CUtensorMapDataType type, int elem, int box_cols, CUtensorMap* map,
                         const void* base, long long cols, long long rows, long long outer,
                         long long ld, long long outer_ld, int box_rows,
                         CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * elem, (cuuint64_t)outer_ld * elem};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides, box, elem_strides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// bf16: boxes of box_rows x BOX_COLS (64) columns.
inline int encode_map(CUtensorMap* map, const void* base, long long cols, long long rows,
                      long long outer, long long ld, long long outer_ld, int box_rows) {
  return encode_map_of(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, BOX_COLS, map, base, cols, rows, outer,
                       ld, outer_ld, box_rows);
}

// bf16 tails: boxes of box_rows x TAIL_BOX_COLS (16) columns with the 32-byte
// swizzle (the last 16 columns of an 80-column row, read at column 64).
inline int encode_map_tail(CUtensorMap* map, const void* base, long long cols, long long rows,
                           long long outer, long long ld, long long outer_ld, int box_rows) {
  return encode_map_of(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, TAIL_BOX_COLS, map, base, cols, rows,
                       outer, ld, outer_ld, box_rows, CU_TENSOR_MAP_SWIZZLE_32B);
}

// f32: boxes of box_rows x F32_BOX_COLS (32) columns, so a 64-column tile is
// two loads, at columns 0 and 32, into its two halves (f32_at).
inline int encode_map_f32(CUtensorMap* map, const void* base, long long cols, long long rows,
                          long long outer, long long ld, long long outer_ld, int box_rows) {
  return encode_map_of(CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, F32_BOX_COLS, map, base, cols, rows,
                       outer, ld, outer_ld, box_rows);
}

// The once-a-device launch set-up of one kernel: on a device's first launch
// it raises the kernel's dynamic shared-memory limit and reads the SM count;
// later launches only read the count back. One instance a kernel, a static
// of its launcher.
struct LaunchSetup {
  std::atomic<int> sm_count[MAX_DEVICES];  // 0: not yet set up on that device

  // The current device's SM count into *out; returns a cudaError_t.
  template <class Kernel>
  int sms(Kernel kernel, int smem_bytes, int* out) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    int n = sm_count[dev].load(std::memory_order_relaxed);
    if (n == 0) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return (int)e;
      sm_count[dev].store(n, std::memory_order_relaxed);
    }
    *out = n;
    return 0;
  }
};

}  // namespace hopper
