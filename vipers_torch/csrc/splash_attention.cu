// Unmasked multi-head attention forward on pre-scaled bf16 q for Hopper
// (sm_90a): the port of the splash-attention A/B.
//
// Replaces the TPU kernel that tools/bench_splash.py::make_splash builds:
// the library splash_attention kernel (make_splash_mha over a FullMask on
// every head, vmapped over the batch), O = softmax(Q K^T) V with q already
// multiplied by the scale and rounded to bf16 by the caller, f32 scores
// and softmax, bf16 out. It has no block-sparse masks: the tool builds
// only FullMask.
//
// The TPU tool sweeps its block sizes (448/896, VMEM tiles) and the q/k/v
// layouts (head-dim-minor or seq-minor). Here the block sizes are the tile
// of attention_tile.cuh as template instances, BLOCK_Q x BLOCK_KV in
// {64, 128}^2 (BLOCK_Q = 128 runs 8 warps), and K comes either as (T, 64)
// per head (head-dim-minor) or as (64, T) (seq-minor: the tile loads K^T
// and transposes it into shared memory). One block per (b*h, query tile).
//
// Bound on the card: at the A/B's shape (B*H = 32*6, T = 896, hd = 64) the
// work is 39.5 GFLOP on 88 MB of I/O, so operations bound it (0.040 ms at
// 989 TFLOP/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using attn_tile::bf16;
using attn_tile::HD;

template <int BQ, int BK, bool K_SEQ_MINOR>
__global__ void __launch_bounds__(attn_tile::bf16_threads<BQ>())
splash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o, int t) {
  extern __shared__ __align__(16) char smem[];
  const size_t base = (size_t)blockIdx.x * t * HD;
  attn_tile::fwd_bf16<BQ, BK, K_SEQ_MINOR>(q + base, HD, k + base, K_SEQ_MINOR ? t : HD,
                                           v + base, HD, nullptr, o + base, HD,
                                           nullptr, t, 1.f, blockIdx.y * BQ, smem);
}

template <int BQ, int BK, bool K_SEQ_MINOR>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int bh, int t,
           cudaStream_t stream) {
  const int smem = (int)sizeof(attn_tile::Bf16Smem<BQ, BK>);
  cudaError_t err = cudaFuncSetAttribute(splash_attention_kernel<BQ, BK, K_SEQ_MINOR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, t / BQ);
  splash_attention_kernel<BQ, BK, K_SEQ_MINOR>
      <<<grid, attn_tile::bf16_threads<BQ>(), smem, stream>>>(q, k, v, o, t);
  return (int)cudaGetLastError();
}

template <int BQ, int BK>
int launch_layout(const bf16* q, const bf16* k, const bf16* v, bf16* o, int bh,
                  int t, int k_seq_minor, cudaStream_t stream) {
  return k_seq_minor ? launch<BQ, BK, true>(q, k, v, o, bh, t, stream)
                     : launch<BQ, BK, false>(q, k, v, o, bh, t, stream);
}

}  // namespace

// q, v, o: (bh, t, 64) bf16 contiguous, q pre-scaled; k: (bh, t, 64), or
// (bh, 64, t) when k_seq_minor. block_q, block_kv in {64, 128}; t must be a
// multiple of 128. Returns a cudaError_t (0 = launched).
extern "C" int vipers_splash_attention(const void* q, const void* k, const void* v,
                                       void* o, int bh, int t, int head_dim,
                                       int block_q, int block_kv, int k_seq_minor,
                                       void* stream) {
  if (head_dim != HD || bh <= 0 || t <= 0 || t % 128 || t / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_q == 64 && block_kv == 64)
    return launch_layout<64, 64>(qp, kp, vp, op, bh, t, k_seq_minor, st);
  if (block_q == 64 && block_kv == 128)
    return launch_layout<64, 128>(qp, kp, vp, op, bh, t, k_seq_minor, st);
  if (block_q == 128 && block_kv == 64)
    return launch_layout<128, 64>(qp, kp, vp, op, bh, t, k_seq_minor, st);
  if (block_q == 128 && block_kv == 128)
    return launch_layout<128, 128>(qp, kp, vp, op, bh, t, k_seq_minor, st);
  return (int)cudaErrorInvalidValue;
}
