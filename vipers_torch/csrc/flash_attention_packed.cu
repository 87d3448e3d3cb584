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
// layout is only a matter of base pointers and row strides here: head h of
// pair h / 2, slot h % 2 reads q at column (h / 2) * 384 + (h % 2) * 64 of
// each token row, k at +128 and v at +256, with a row stride of 3D; it
// writes column h * 64 of (B, T, D), row stride D. Each head's row is 128
// contiguous, 128-byte aligned bytes in bf16, so the shared tile's 16-byte
// vector loads apply. One block per (b, head, 64-query tile) runs the tile
// of attention_tile.cuh: an online softmax over 64-key tiles, which is the
// TPU's exact softmax up to rounding (p rounded to bf16 against the running
// max for mma.sync, the output divided by l = max(sum p, 1e-20) at the
// end). Invalid keys get -1e9 on the f32 scores. The f32 instance is FMA
// only, no TF32.
//
// Bound on the card: at the ViT-S/16 LOST shape (B = 128, T = 896, 6 heads
// of 64) the work is 157.8 GFLOP on 352 MB of I/O in bf16, so operations
// bound it (0.160 ms at 989 TFLOP/s); the f32 instance by the 67 TFLOP/s
// of the f32 pipes (2.356 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"

namespace {

using attn_tile::bf16;
using attn_tile::HD;
constexpr int BQ = 64;
constexpr int PACK = 128 / HD;  // heads per 128-column stripe
constexpr int BF16_THREADS = attn_tile::bf16_threads<BQ>();
typedef attn_tile::Bf16Smem<BQ, 64> Bf16Smem;

template <typename T>
__global__ void __launch_bounds__(std::is_same<T, float>::value ? attn_tile::F32_THREADS
                                                                 : BF16_THREADS)
flash_attention_packed_kernel(const T* __restrict__ qkv,
                              const uint8_t* __restrict__ valid,
                              T* __restrict__ o, int heads, int t, float scale) {
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int q0 = blockIdx.y * BQ;
  const int d = heads * HD;
  const int ld = 3 * d;
  const T* qh = qkv + (size_t)b * t * ld + (h / PACK) * 3 * 128 + (h % PACK) * HD;
  const T* kh = qh + 128;
  const T* vh = qh + 256;
  T* oh = o + (size_t)b * t * d + h * HD;
  const uint8_t* vrow = valid ? valid + (size_t)b * t : nullptr;
  if constexpr (std::is_same<T, float>::value)
    attn_tile::fwd_f32(qh, kh, vh, ld, vrow, oh, d, nullptr, t, scale, q0, smem);
  else
    attn_tile::fwd_bf16<BQ, 64, false>(qh, ld, kh, ld, vh, ld, vrow, oh, d,
                                       nullptr, t, scale, q0, smem);
}

template <typename T>
int launch(const void* qkv, const uint8_t* valid, void* o, int batch, int heads,
           int t, float scale, cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  const int threads = f32 ? attn_tile::F32_THREADS : BF16_THREADS;
  const int smem = f32 ? (int)sizeof(attn_tile::F32Smem) : (int)sizeof(Bf16Smem);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_packed_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * heads, (t + BQ - 1) / BQ);
  flash_attention_packed_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(qkv), valid, static_cast<T*>(o), heads, t, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv: (batch, t, 3 * heads * 64) contiguous, columns permuted into head-pair
// stripes; o: (batch, t, heads * 64); dtype 0 = float32, 1 = bfloat16.
// valid: (batch, t) bytes, nonzero = attend; may be null (all valid).
// Returns a cudaError_t (0 = launched).
extern "C" int vipers_flash_attention_packed(const void* qkv, const uint8_t* valid,
                                             void* o, int batch, int heads, int t,
                                             int head_dim, float scale, int dtype,
                                             void* stream) {
  if (head_dim != HD || batch <= 0 || heads <= 0 || heads % PACK || t <= 0 ||
      (t + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(qkv, valid, o, batch, heads, t, scale, st);
  if (dtype == 1) return launch<bf16>(qkv, valid, o, batch, heads, t, scale, st);
  return (int)cudaErrorInvalidValue;
}
