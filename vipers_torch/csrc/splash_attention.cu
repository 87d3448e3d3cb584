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
// Bound on the card: at the A/B's shape (B*H = 32*6, T = 896, hd = 64) the
// work is 39.5 GFLOP on 88 MB of I/O, so operations bound it (0.040 ms at
// 989 TFLOP/s).
//
// The kernel is the flash kernels' Hopper tile (attention_tile.cuh,
// attn_tile::hopper): a persistent grid of one CTA per SM over (head,
// query tile) pairs, one producer thread keeping Q and a ring of K/V tiles
// in flight by TMA (128-byte swizzle) with full / empty mbarriers, consumer
// warpgroups running S = Q K^T on wgmma from shared memory and O += P V on
// the register-A wgmma with V read through the transpose bit; each tile's
// softmax beside the last one's P V; no mask and no lse here, scale 1. The
// TPU tool sweeps its block sizes and the K layout; here they are the
// tile's template parameters: block_q = 64 or 128 query rows a CTA (one or
// two consumer warpgroups), block_kv = 64 or 128 keys a TMA stage of the
// K/V ring (6 or 3 stages: 96 KB either way), and K head-dim-minor (B*H, T,
// 64) or seq-minor (B*H, 64, T). Seq-minor K is loaded as it lies, 64-key
// boxes of its 64 dims, and read by wgmma as an MN-major B operand of
// S = Q K^T through the transpose bit (two 64-key swizzled tiles 8 KB
// apart, the descriptor's leading offset, at 128 keys): no transposing
// copy.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using attn_tile::bf16;
using attn_tile::HD;
namespace tile = attn_tile::hopper;

// Head bh: z = bh in all three maps and its own rows of o; no lse, no mask.
struct SplashLayout {
  bf16* o;
  int t;
  __device__ tile::HeadView head(int bh) const {
    return {bh, 0, 0, 0, o + (size_t)bh * t * HD, HD, nullptr, nullptr};
  }
};

template <int BLOCK_Q, int BLOCK_KV, bool K_SEQ_MINOR>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int bh, int t,
           cudaStream_t stream) {
  constexpr int RING = BLOCK_KV == 128 ? 3 : 6;
  const long long head = (long long)t * HD;
  auto maps = [=](CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv) {
    using hopper::encode_map;
    int err = encode_map(mq, q, HD, t, bh, HD, head, BLOCK_Q);
    if (err == 0)  // seq-minor: rows are the 64 dims, columns the keys
      err = K_SEQ_MINOR ? encode_map(mk, k, t, HD, bh, t, head, HD)
                        : encode_map(mk, k, HD, t, bh, HD, head, BLOCK_KV);
    if (err == 0) err = encode_map(mv, v, HD, t, bh, HD, head, BLOCK_KV);
    return err;
  };
  return tile::launch_tile<SplashLayout, BLOCK_Q / 64, BLOCK_KV, RING, K_SEQ_MINOR, false>(
      maps, SplashLayout{o, t}, bh, t, 1.f, stream);
}

template <int BLOCK_Q, int BLOCK_KV>
int launch_layout(const bf16* q, const bf16* k, const bf16* v, bf16* o, int bh, int t,
                  int k_seq_minor, cudaStream_t stream) {
  return k_seq_minor ? launch<BLOCK_Q, BLOCK_KV, true>(q, k, v, o, bh, t, stream)
                     : launch<BLOCK_Q, BLOCK_KV, false>(q, k, v, o, bh, t, stream);
}

}  // namespace

// q, v, o: (bh, t, 64) bf16 contiguous, q pre-scaled; k: (bh, t, 64), or
// (bh, 64, t) when k_seq_minor; all 16-byte aligned. block_q, block_kv in
// {64, 128}; t must be a multiple of 128. Returns a cudaError_t (0 =
// launched).
extern "C" int vipers_splash_attention(const void* q, const void* k, const void* v, void* o,
                                       int bh, int t, int head_dim, int block_q, int block_kv,
                                       int k_seq_minor, void* stream) {
  if (head_dim != HD || bh <= 0 || t <= 0 || t % 128) return (int)cudaErrorInvalidValue;
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
