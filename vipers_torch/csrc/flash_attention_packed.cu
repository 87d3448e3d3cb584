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
// D. The online softmax is the TPU's exact softmax up to rounding (bf16: p
// rounded to bf16 against the running max; the output divided by l =
// max(sum p, 1e-20) at the end). Invalid keys get -1e9 on the f32 scores.
//
// Bound on the card: at the ViT-S/16 LOST shape (B = 128, T = 896, 6 heads
// of 64) the work is 157.8 GFLOP on 352 MB of I/O in bf16, so operations
// bound it (0.160 ms at 989 TFLOP/s); the f32 instance runs every product
// as three TF32 products, bound at 3 x 157.8 GFLOP over 494.7 TFLOP/s
// (0.957 ms; 2.356 ms on the FMA pipes).
//
// Both instances: the Hopper tiles of attention_tile.cuh, with the shapes
// of flash_attention_fwd.cu, on one 3-D tensor map over (B, T, 3D), row
// stride 3D, the head's column a coordinate: each head's row is 64
// contiguous elements (bf16: one 128-byte swizzled TMA row; f32: two), so
// the strided layout costs the producer nothing. TMA, a K/V ring, a
// producer thread and wgmma feed the tensor cores as in
// flash_attention_fwd.cu.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using attn_tile::bf16;
using attn_tile::HD;
constexpr int PACK = 128 / HD;  // heads per 128-column stripe

// Column of head h's q in a token row (k at +128, v at +256).
__host__ __device__ inline int q_column(int h) { return (h / PACK) * 3 * 128 + (h % PACK) * HD; }

// Head bh = b * heads + h: z = b, the head's stripe columns, column h * 64 of
// its image's output rows (T: their element type), no lse.
template <class T>
struct PackedLayout {
  T* o;
  const uint8_t* valid;
  int heads, t;
  __device__ attn_tile::hopper::HeadViewOf<T> head(int bh) const {
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
  const long long ld = 3LL * heads * HD;
  if (dtype == 0) {
    auto maps = [=](CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv) {
      using namespace attn_tile::hopper;
      int err = encode_map_f32(mq, qkv, ld, t, batch, ld, ld * t, F32_BQ);
      if (err == 0) err = encode_map_f32(mk, qkv, ld, t, batch, ld, ld * t, F32_BK);
      *mv = *mk;
      return err;
    };
    const PackedLayout<float> lay{static_cast<float*>(o), valid, heads, t};
    return attn_tile::hopper::launch_f32(maps, lay, batch * heads, t, scale, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  auto maps = [=](CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv) {
    using namespace attn_tile::hopper;
    int err = encode_map(mq, qkv, ld, t, batch, ld, ld * t, BQ);
    if (err == 0) err = encode_map(mk, qkv, ld, t, batch, ld, ld * t, BK);
    *mv = *mk;
    return err;
  };
  const PackedLayout<bf16> lay{static_cast<bf16*>(o), valid, heads, t};
  return attn_tile::hopper::launch_bf16(maps, lay, batch * heads, t, scale, st);
}
