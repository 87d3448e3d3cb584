// Masked blockwise (flash) attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels vipers/ops/flash_attention.py::_fwd_kernel
// (driven by _flash_fwd) and the library Pallas kernel behind
// flash_attention_official: O = softmax(scale * Q K^T, keys masked) V over
// (B*H, T, 64), plus the f32 logsumexp that a backward pass needs. Pad keys
// (valid == 0) get -1e9 on the f32 scores, exactly the JAX kernel's mask;
// query rows beyond T are not written.
//
// Bound on the card: at the ViT-S/16 LOST shape (B*H = 768, T = 896) the
// bf16 instance does 157.8 GFLOP on 352 MB of I/O, so operations bound it
// (0.160 ms at 989 TFLOP/s against 0.105 ms of bytes); the f32 instance
// runs on plain FMA (no TF32, it is the bit-parity anchor), bound by the
// 67 TFLOP/s of the f32 pipes (2.356 ms).
//
// bf16: the Hopper tile of attention_tile.cuh. Three 3-D tensor maps over
// (B*H, T, 64) with the 128-byte swizzle (Q boxes of the query tile, K and
// V of the key tile; rows beyond T read as zeros); a persistent grid of one
// CTA per SM walks the (head, query tile) pairs; a producer thread keeps Q
// and a ring of K/V tiles in flight by TMA while the consumer warpgroups
// run S = Q K^T and O += P V on wgmma, V read through the descriptor's
// transpose bit, each tile's softmax beside the last tile's P V. So the
// tensor cores are fed without the synchronous loads, shared-memory
// transpose and block-wide syncs that held the mma.sync tile at 10% of the
// bound. 192 query rows (three warpgroups), 128-key tiles, three stages: the
// fastest shape timed on an H100. f32: the FMA tile, one block per (b*h,
// 64-query tile), 256 threads, K/V through shared memory in 64-key tiles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using attn_tile::bf16;
using attn_tile::HD;
constexpr int F32_BQ = attn_tile::F32_BQ;

__global__ void __launch_bounds__(attn_tile::F32_THREADS)
flash_attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const uint8_t* __restrict__ valid,
                        float* __restrict__ o, float* __restrict__ lse, int heads, int t,
                        float scale) {
  extern __shared__ __align__(16) char smem[];
  const int bh = blockIdx.x;
  const size_t base = (size_t)bh * t * HD;
  const uint8_t* vrow = valid ? valid + (size_t)(bh / heads) * t : nullptr;
  attn_tile::fwd_f32(q + base, k + base, v + base, HD, vrow, o + base, HD,
                     lse + (size_t)bh * t, t, scale, blockIdx.y * F32_BQ, smem);
}

// Head bh: z = bh in all three maps, its own rows of o, lse and its image's
// key bytes.
struct FlashLayout {
  bf16* o;
  float* lse;
  const uint8_t* valid;
  int heads, t;
  __device__ attn_tile::hopper::HeadView head(int bh) const {
    return {bh, 0, 0, 0, o + (size_t)bh * t * HD, HD, lse + (size_t)bh * t,
            valid ? valid + (size_t)(bh / heads) * t : nullptr};
  }
};

}  // namespace

// q, k, v, o: (bh, t, 64) contiguous, 16-byte aligned; dtype 0 = float32,
// 1 = bfloat16. valid: (bh / heads, t) bytes, nonzero = attend; may be null
// (all valid). lse: (bh, t) float32. Returns a cudaError_t (0 = launched).
extern "C" int vipers_flash_attention_fwd(const void* q, const void* k, const void* v,
                                          const uint8_t* valid, void* o, float* lse, int bh,
                                          int heads, int t, int head_dim, float scale, int dtype,
                                          void* stream) {
  if (head_dim != HD || bh <= 0 || heads <= 0 || bh % heads || t <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if ((t + F32_BQ - 1) / F32_BQ > 65535) return (int)cudaErrorInvalidValue;
    const int smem = (int)sizeof(attn_tile::F32Smem);
    cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd_f32,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    flash_attention_fwd_f32<<<dim3(bh, (t + F32_BQ - 1) / F32_BQ), attn_tile::F32_THREADS, smem,
                              st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                    static_cast<const float*>(v), valid,
                                    static_cast<float*>(o), lse, heads, t, scale);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  auto maps = [=](CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv) {
    using namespace attn_tile::hopper;
    int err = encode_map(mq, q, HD, t, bh, HD, (long long)t * HD, BQ);
    if (err == 0) err = encode_map(mk, k, HD, t, bh, HD, (long long)t * HD, BK);
    if (err == 0) err = encode_map(mv, v, HD, t, bh, HD, (long long)t * HD, BK);
    return err;
  };
  const FlashLayout lay{static_cast<bf16*>(o), lse, valid, heads, t};
  return attn_tile::hopper::launch_bf16(maps, lay, bh, t, scale, st);
}

// The bf16 tile's query rows, key-tile width and ring stages.
extern "C" void vipers_flash_attention_tile(int* block_q, int* block_k, int* stages) {
  *block_q = attn_tile::hopper::BQ;
  *block_k = attn_tile::hopper::BK;
  *stages = attn_tile::hopper::STAGES;
}
