// Token-major packed attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel vipers/ops/flash_attention.py::_packed_fwd_kernel
// (driven by _packed_fwd): exact-softmax attention read straight from the
// (B, T, 3D) output of one qkv projection whose columns are permuted into
// per-head-pair stripes [q h0 h1 | k h0 h1 | v h0 h1] (128 columns each,
// packed_qkv_permutation), written token-major as (B, T, D) with the heads
// h-major, so neither projection needs a head transpose.
//
// The stripe is a TPU lane tile; the contract (permuted columns in, (B, T,
// D) h-major out) is kept because that is what the model feeds, and the
// layout is only a matter of coordinates here: head h of pair h / 2, slot
// h % 2 reads q at column (h / 2) * 384 + (h % 2) * 64 of each token row, k
// at +128 and v at +256, and writes column h * 64 of (B, T, D), row stride
// D. The online softmax is the TPU's exact softmax up to rounding (p
// rounded to bf16 against the running max, the output divided by l =
// max(sum p, 1e-20) at the end). Invalid keys get -1e9 on the f32 scores.
//
// Bound on the card: at the ViT-S/16 LOST shape (B = 128, T = 896, 6 heads
// of 64) the work is 157.8 GFLOP on 352 MB of I/O in bf16, so operations
// bound it (0.160 ms at 989 TFLOP/s); the f32 instance (FMA only, no TF32)
// by the 67 TFLOP/s of the f32 pipes (2.356 ms).
//
// bf16: the Hopper tile of attention_tile.cuh on one 3-D tensor map over
// (B, T, 3D), row stride 3D, the head's column a coordinate: each head's row
// is 128 contiguous, 128-byte aligned bytes, exactly one swizzled TMA row,
// so the strided layout costs the producer nothing. TMA, a K/V ring, a
// producer thread and wgmma feed the tensor cores as in
// flash_attention_fwd.cu, with the same tile shape. f32: the FMA
// tile, one block per (b, head, 64-query tile).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using attn_tile::bf16;
using attn_tile::HD;
constexpr int F32_BQ = attn_tile::F32_BQ;
constexpr int PACK = 128 / HD;  // heads per 128-column stripe

// Column of head h's q in a token row (k at +128, v at +256).
__host__ __device__ inline int q_column(int h) { return (h / PACK) * 3 * 128 + (h % PACK) * HD; }

__global__ void __launch_bounds__(attn_tile::F32_THREADS)
flash_attention_packed_f32(const float* __restrict__ qkv, const uint8_t* __restrict__ valid,
                           float* __restrict__ o, int heads, int t, float scale) {
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int d = heads * HD;
  const int ld = 3 * d;
  const float* qh = qkv + (size_t)b * t * ld + q_column(h);
  attn_tile::fwd_f32(qh, qh + 128, qh + 256, ld, valid ? valid + (size_t)b * t : nullptr,
                     o + (size_t)b * t * d + h * HD, d, nullptr, t, scale, blockIdx.y * F32_BQ,
                     smem);
}

// Head bh = b * heads + h: z = b, the head's stripe columns, column h * 64 of
// its image's output rows, no lse.
struct PackedLayout {
  bf16* o;
  const uint8_t* valid;
  int heads, t;
  __device__ attn_tile::hopper::HeadView head(int bh) const {
    const int b = bh / heads, h = bh % heads, d = heads * HD, qc = q_column(h);
    return {b, qc, qc + 128, qc + 256, o + (size_t)b * t * d + h * HD, d, nullptr,
            valid ? valid + (size_t)b * t : nullptr};
  }
};

}  // namespace

// qkv: (batch, t, 3 * heads * 64) contiguous and 16-byte aligned, columns
// permuted into head-pair stripes; o: (batch, t, heads * 64); dtype 0 =
// float32, 1 = bfloat16. valid: (batch, t) bytes, nonzero = attend; may be
// null (all valid). Returns a cudaError_t (0 = launched).
extern "C" int vipers_flash_attention_packed(const void* qkv, const uint8_t* valid, void* o,
                                             int batch, int heads, int t, int head_dim,
                                             float scale, int dtype, void* stream) {
  if (head_dim != HD || batch <= 0 || heads <= 0 || heads % PACK || t <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if ((t + F32_BQ - 1) / F32_BQ > 65535) return (int)cudaErrorInvalidValue;
    const int smem = (int)sizeof(attn_tile::F32Smem);
    cudaError_t err = cudaFuncSetAttribute(flash_attention_packed_f32,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    flash_attention_packed_f32<<<dim3(batch * heads, (t + F32_BQ - 1) / F32_BQ),
                                 attn_tile::F32_THREADS, smem, st>>>(
        static_cast<const float*>(qkv), valid, static_cast<float*>(o), heads, t, scale);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const long long ld = 3LL * heads * HD;
  auto maps = [=](CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv) {
    using namespace attn_tile::hopper;
    int err = encode_map(mq, qkv, ld, t, batch, ld, ld * t, BQ);
    if (err == 0) err = encode_map(mk, qkv, ld, t, batch, ld, ld * t, BK);
    *mv = *mk;
    return err;
  };
  const PackedLayout lay{static_cast<bf16*>(o), valid, heads, t};
  return attn_tile::hopper::launch_bf16(maps, lay, batch * heads, t, scale, st);
}
