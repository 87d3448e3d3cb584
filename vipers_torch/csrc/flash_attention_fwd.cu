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
// (0.160 ms at 989 TFLOP/s against 0.105 ms of bytes). The f32 instance (the
// parity anchor, within 1e-5 / 1e-4 of the exact plain version) runs every
// product as three TF32 products, so 3 x 157.8 GFLOP over the TF32 tensor
// cores' 494.7 TFLOP/s bound it (0.957 ms; on the 67 TFLOP/s FMA pipes the
// same work would take 2.356 ms).
//
// Both instances: the Hopper tiles of attention_tile.cuh. Three 3-D tensor
// maps over (B*H, T, 64) with the 128-byte swizzle (Q boxes of the query
// tile, K and V of the key tile; rows beyond T read as zeros); a persistent
// grid of one CTA per SM walks the (head, query tile) pairs; a producer
// thread keeps Q and a ring of K/V tiles in flight by TMA while the
// consumer warpgroups run S = Q K^T and O += P V on wgmma, each tile's
// softmax beside the last tile's P V.
// bf16: V read through the descriptor's transpose bit. So the tensor cores
// are fed without the synchronous loads, shared-memory transpose and
// block-wide syncs that held the mma.sync tile at 10% of the bound. 192
// query rows (three warpgroups), 128-key tiles, three stages: the fastest
// shape timed on an H100.
// f32: TF32 wgmma, 3xTF32; 128 query rows (two warpgroups) held as split
// register A, raw K/V in 32-key stages of a 3-stage ring, each split into
// TF32 big and small (V transposed: TF32 has no transpose bit) by the
// producer warpgroup's warps beside the consumers' products and softmax.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using attn_tile::bf16;
using attn_tile::HD;

// Head bh: z = bh in all three maps, its own rows of o (T: the output's
// element type), lse and its image's key bytes.
template <class T>
struct FlashLayout {
  T* o;
  float* lse;
  const uint8_t* valid;
  int heads, t;
  __device__ attn_tile::hopper::HeadViewOf<T> head(int bh) const {
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
  const long long head = (long long)t * HD;
  if (dtype == 0) {
    auto maps = [=](CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv) {
      using namespace attn_tile::hopper;
      int err = encode_map_f32(mq, q, HD, t, bh, HD, head, F32_BQ);
      if (err == 0) err = encode_map_f32(mk, k, HD, t, bh, HD, head, F32_BK);
      if (err == 0) err = encode_map_f32(mv, v, HD, t, bh, HD, head, F32_BK);
      return err;
    };
    const FlashLayout<float> lay{static_cast<float*>(o), lse, valid, heads, t};
    return attn_tile::hopper::launch_f32(maps, lay, bh, t, scale, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  auto maps = [=](CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv) {
    using namespace attn_tile::hopper;
    int err = encode_map(mq, q, HD, t, bh, HD, head, BQ);
    if (err == 0) err = encode_map(mk, k, HD, t, bh, HD, head, BK);
    if (err == 0) err = encode_map(mv, v, HD, t, bh, HD, head, BK);
    return err;
  };
  const FlashLayout<bf16> lay{static_cast<bf16*>(o), lse, valid, heads, t};
  return attn_tile::hopper::launch_bf16(maps, lay, bh, t, scale, st);
}

// The tile of one instance (dtype 0 f32, 1 bf16) as compiled, into out[5]:
// query rows, keys a K/V tile or stage, ring stages, split stages and TF32
// products an f32 product (both 0 for bf16, which splits nothing).
extern "C" void vipers_flash_attention_tile(int dtype, int* out) {
  using namespace attn_tile::hopper;
  const int f32[5] = {F32_BQ, F32_BK, F32_STAGES, F32_SPLITS, TF32_TERMS};
  const int b16[5] = {BQ, BK, STAGES, 0, 0};
  for (int i = 0; i < 5; ++i) out[i] = dtype == 0 ? f32[i] : b16[i];
}
