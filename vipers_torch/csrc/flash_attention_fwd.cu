// Masked blockwise (flash) attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels vipers/ops/flash_attention.py::_fwd_kernel
// (driven by _flash_fwd) and the library Pallas kernel behind
// flash_attention_official: O = softmax(scale * Q K^T, keys masked) V over
// (B*H, T, 64), plus the f32 logsumexp that a backward pass needs.
//
// Work layout: one block per (b*h, 64-query tile), running the shared tile
// of attention_tile.cuh on this head's rows (row stride 64): K/V stream
// through shared memory in 64-key tiles with an f32 online softmax. Pad
// keys (valid == 0) get -1e9 on the f32 scores, exactly the JAX kernel's
// mask. Keys beyond T read as zero rows and are masked the same way, which
// is the JAX wrapper's internal padding. Query rows beyond T are not written.
//
// Bound on the card: at the ViT-S/16 LOST shape (B*H = 768, T = 896) the
// bf16 instance does 158 GFLOP on 352 MB of I/O, so operations bound it
// (0.16 ms at 989 TFLOP/s against 0.11 ms of bytes). The f32 instance runs
// on plain FMA (no TF32, it is the bit-parity anchor), bound by the
// 67 TFLOP/s of the f32 pipes.
//
// Instances (template on the element type): float on the f32 FMA tile
// (256 threads), bf16 on the mma.sync tile with 64 queries and 64-key
// tiles (128 threads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"

namespace {

using attn_tile::bf16;
using attn_tile::HD;
constexpr int BQ = 64;
constexpr int BF16_THREADS = attn_tile::bf16_threads<BQ>();
typedef attn_tile::Bf16Smem<BQ, 64> Bf16Smem;

template <typename T>
__global__ void __launch_bounds__(std::is_same<T, float>::value ? attn_tile::F32_THREADS
                                                                 : BF16_THREADS)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const uint8_t* __restrict__ valid, T* __restrict__ o,
                           float* __restrict__ lse, int heads, int t,
                           float scale) {
  extern __shared__ __align__(16) char smem[];
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const size_t base = (size_t)bh * t * HD;
  const uint8_t* vrow = valid ? valid + (size_t)(bh / heads) * t : nullptr;
  float* lrow = lse + (size_t)bh * t;
  if constexpr (std::is_same<T, float>::value)
    attn_tile::fwd_f32(q + base, k + base, v + base, HD, vrow, o + base, HD, lrow,
                       t, scale, q0, smem);
  else
    attn_tile::fwd_bf16<BQ, 64, false>(q + base, HD, k + base, HD, v + base, HD,
                                       vrow, o + base, HD, lrow, t, scale, q0,
                                       smem);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid,
           void* o, float* lse, int bh, int heads, int t, float scale,
           cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  const int threads = f32 ? attn_tile::F32_THREADS : BF16_THREADS;
  const int smem = f32 ? (int)sizeof(attn_tile::F32Smem) : (int)sizeof(Bf16Smem);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (t + BQ - 1) / BQ);
  flash_attention_fwd_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, static_cast<T*>(o), lse, heads, t,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (bh, t, 64) contiguous, dtype 0 = float32, 1 = bfloat16.
// valid: (bh / heads, t) bytes, nonzero = attend; may be null (all valid).
// lse: (bh, t) float32. Returns a cudaError_t (0 = launched).
extern "C" int vipers_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, const uint8_t* valid,
                                          void* o, float* lse, int bh,
                                          int heads, int t, int head_dim,
                                          float scale, int dtype,
                                          void* stream) {
  if (head_dim != HD || bh <= 0 || heads <= 0 || bh % heads || t <= 0 ||
      (t + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, valid, o, lse, bh, heads, t, scale, st);
  if (dtype == 1)
    return launch<bf16>(q, k, v, valid, o, lse, bh, heads, t, scale, st);
  return (int)cudaErrorInvalidValue;
}
