// Fused LayerNorm -> fc1 -> tanh-GELU forward, bf16, for Hopper (sm_90a).
//
// Replaces the TPU kernel vipers/ops/fused_mlp.py::_kernel (driven by
// _fused_fwd_impl):  out = gelu_tanh(xhat @ W_eff + b_eff), where
// xhat = (x - mean) * rsqrt(var + eps) with var = max(E[x^2] - mean^2, 0)
// in f32 and no affine. The LayerNorm affine is folded into W_eff / b_eff
// in f32 by the caller (vipers_torch/ops/fused_mlp.py), as the JAX wrapper
// does, so the normalized rows never exist in device memory.
//
// Work layout: one block of 256 threads (8 warps) per 64-row tile of x.
// The block computes each row's statistics in f32 (one warp per 8 rows),
// writes xhat as bf16 into shared memory (64 x D), then walks the output
// columns in tiles of 128: W_eff^T streams through shared memory in 64-deep
// k-chunks, each warp accumulates a 32 x 32 piece in f32 with mma.sync
// m16n8k16, and the epilogue adds b_eff, applies tanh-GELU in f32 (tanhf,
// not tanh.approx) and stores bf16.
//
// Bound on the card: at the ViT-S/16 LOST shape (M = 128*896, D = 384,
// F = 1536) the product is 135 GFLOP on 441 MB of I/O: 0.137 ms of bf16
// tensor-core time against 0.132 ms of bytes, so the two bounds nearly
// coincide. This first version uses mma.sync from padded shared memory, not
// TMA or wgmma, and re-reads W_eff from L2 in every block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BM = 64;       // rows of x per block
constexpr int BN = 128;      // output columns per tile
constexpr int BKC = 64;      // k-chunk of W_eff^T held in smem
constexpr int THREADS = 256;
constexpr int W_LD = BKC + 8;  // padded smem rows: conflict-free fragments
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ float gelu_tanh(float y) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  const float inner = k * (y + 0.044715f * (y * y * y));
  return 0.5f * y * (1.f + tanhf(inner));
}

__global__ void __launch_bounds__(THREADS)
fused_ln_dense_gelu_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w_t,  // (F, D)
                           const float* __restrict__ b,            // (F,)
                           __nv_bfloat16* __restrict__ out,        // (M, F)
                           int m, int d, int f, float eps) {
  extern __shared__ __align__(16) char smem[];
  const int x_ld = d + 8;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BM][x_ld]
  __nv_bfloat16* ws = xs + BM * x_ld;                         // [BN][W_LD]
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int m0 = blockIdx.x * BM;

  // LayerNorm statistics in f32, one warp per 8 rows; xhat -> smem as bf16.
  for (int rr = 0; rr < BM / 8; ++rr) {
    const int r = warp * (BM / 8) + rr;
    const int gr = m0 + r;
    __nv_bfloat16* dst = xs + r * x_ld;
    if (gr >= m) {
      for (int c = lane * 2; c < d; c += 64)
        *reinterpret_cast<uint32_t*>(dst + c) = 0u;
      continue;
    }
    const __nv_bfloat16* src = x + (size_t)gr * d;
    float sum = 0.f, sq = 0.f;
    for (int c = lane * 2; c < d; c += 64) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(src + c));
      sum += v.x + v.y;
      sq += v.x * v.x + v.y * v.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    const float mu = sum / d;
    const float var = fmaxf(sq / d - mu * mu, 0.f);
    const float rs = rsqrtf(var + eps);
    for (int c = lane * 2; c < d; c += 64) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(src + c));
      *reinterpret_cast<uint32_t*>(dst + c) =
          pack_bf16x2((v.x - mu) * rs, (v.y - mu) * rs);
    }
  }

  const int wm = (warp / 4) * 32;  // warp's rows within the tile
  const int wn = (warp % 4) * 32;  // warp's columns within the column tile
  for (int n0 = 0; n0 < f; n0 += BN) {
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    for (int kc = 0; kc < d; kc += BKC) {
      __syncthreads();  // xs is written / previous chunk's readers are done
      for (int idx = tid; idx < BN * (BKC / 8); idx += THREADS) {
        const int r = idx / (BKC / 8), ch = idx % (BKC / 8);
        *reinterpret_cast<uint4*>(ws + r * W_LD + ch * 8) =
            *reinterpret_cast<const uint4*>(w_t + (size_t)(n0 + r) * d + kc + ch * 8);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BKC / 16; ++kk) {
        const int cx = kc + kk * 16 + tg * 2;  // column in xs
        const int cw = kk * 16 + tg * 2;       // column in ws
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const __nv_bfloat16* r0 = xs + (wm + mt * 16 + g) * x_ld;
          const __nv_bfloat16* r1 = r0 + 8 * x_ld;
          a[mt][0] = ld_bf16x2(r0 + cx);
          a[mt][1] = ld_bf16x2(r1 + cx);
          a[mt][2] = ld_bf16x2(r0 + cx + 8);
          a[mt][3] = ld_bf16x2(r1 + cx + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const __nv_bfloat16* wr = ws + (wn + nt * 8 + g) * W_LD;
          const uint32_t b0 = ld_bf16x2(wr + cw), b1 = ld_bf16x2(wr + cw + 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][nt], a[mt], b0, b1);
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r0 = m0 + wm + mt * 16 + g, r1 = r0 + 8;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = n0 + wn + nt * 8 + tg * 2;
        const float b0 = b[c], b1 = b[c + 1];
        if (r0 < m)
          *reinterpret_cast<uint32_t*>(out + (size_t)r0 * f + c) = pack_bf16x2(
              gelu_tanh(acc[mt][nt][0] + b0), gelu_tanh(acc[mt][nt][1] + b1));
        if (r1 < m)
          *reinterpret_cast<uint32_t*>(out + (size_t)r1 * f + c) = pack_bf16x2(
              gelu_tanh(acc[mt][nt][2] + b0), gelu_tanh(acc[mt][nt][3] + b1));
      }
    }
  }
}

}  // namespace

// x: (m, d) bf16, w_t: (f, d) bf16 = W_eff transposed, b: (f,) f32,
// out: (m, f) bf16; all contiguous. d % 64 == 0, f % 128 == 0.
// Returns a cudaError_t (0 = launched).
extern "C" int vipers_fused_ln_dense_gelu(const void* x, const void* w_t,
                                          const float* b, void* out, int m,
                                          int d, int f, float eps,
                                          void* stream) {
  const int smem = (BM * (d + 8) + BN * W_LD) * (int)sizeof(__nv_bfloat16);
  if (m <= 0 || d <= 0 || d % BKC || f <= 0 || f % BN || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_ln_dense_gelu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + BM - 1) / BM);
  fused_ln_dense_gelu_kernel<<<grid, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w_t), b,
      static_cast<__nv_bfloat16*>(out), m, d, f, eps);
  return (int)cudaGetLastError();
}
