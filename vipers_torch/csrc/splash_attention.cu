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
// layouts (head-dim-minor or seq-minor). Here the block sizes are the
// mma.sync tile below as template instances, BLOCK_Q x BLOCK_KV in
// {64, 128}^2 (BLOCK_Q = 128 runs 8 warps), and K comes either as (T, 64)
// per head (head-dim-minor) or as (64, T) (seq-minor: the tile loads K^T
// and transposes it into shared memory). One block per (b*h, query tile).
//
// The tile is the flash kernels' first bf16 tile, kept here as it was when
// they moved to TMA and wgmma (attention_tile.cuh): BQ / 16 warps, each
// owns 16 query rows; S = Q K^T and O += P V on mma.sync m16n8k16 with f32
// accumulation, the scale applied to the f32 scores; P goes from the S
// accumulators to A fragments in registers (no smem trip), so p is rounded
// to bf16 against the running max. K/V tiles load synchronously between
// two __syncthreads, V transposed into shared memory.
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
using attn_tile::NEG;

// ------------------------------------------------------ bf16 / mma.sync
template <int BQ>
__host__ __device__ constexpr int bf16_threads() {
  return BQ / 16 * 32;
}

constexpr int BF16_LD = HD + 8;  // 144-byte rows: conflict-free fragments

template <int BQ, int BK>
struct Bf16Smem {
  bf16 q[BQ][BF16_LD];
  bf16 k[BK][BF16_LD];     // [key][dim]
  bf16 vt[HD][BK + 8];     // V transposed: [dim][key]
  float ok[BK];
};

// ROWS rows of src (row stride ld) from row r0 into dst, zero beyond t.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16 (*dst)[BF16_LD],
                                          const bf16* __restrict__ src, int ld,
                                          int r0, int t, int tid) {
  for (int idx = tid; idx < ROWS * (HD / 8); idx += THREADS) {
    const int r = idx / (HD / 8), ch = idx % (HD / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + ch * 8);
    *reinterpret_cast<uint4*>(&dst[r][ch * 8]) = val;
  }
}

// q, v: element (row, c) at ptr[row * ld + c]. k: (key, c) at k[key * ldk +
// c], or with K_SEQ_MINOR (c, key) at k[c * ldk + key], which needs t % 8
// == 0. o: (row, c) at o[row * ldo + c]. valid and lse as for fwd_f32. The
// block computes query rows q0 .. q0 + BQ - 1 with bf16_threads<BQ>()
// threads and sizeof(Bf16Smem<BQ, BK>) bytes of dynamic shared memory.
template <int BQ, int BK, bool K_SEQ_MINOR>
__device__ void fwd_bf16(const bf16* __restrict__ q, int ldq,
                         const bf16* __restrict__ k, int ldk,
                         const bf16* __restrict__ v, int ldv,
                         const uint8_t* __restrict__ valid, bf16* __restrict__ o,
                         int ldo, float* __restrict__ lse, int t, float scale,
                         int q0, char* smem_raw) {
  constexpr int THREADS = bf16_threads<BQ>();
  Bf16Smem<BQ, BK>& s = *reinterpret_cast<Bf16Smem<BQ, BK>*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int wr = warp * 16;  // this warp's first query row in the tile

  load_rows<BQ, THREADS>(s.q, q, ldq, q0, t, tid);
  __syncthreads();
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + tg * 2;
    qa[kk][0] = ld_bf16x2(&s.q[wr + g][c]);
    qa[kk][1] = ld_bf16x2(&s.q[wr + g + 8][c]);
    qa[kk][2] = ld_bf16x2(&s.q[wr + g][c + 8]);
    qa[kk][3] = ld_bf16x2(&s.q[wr + g + 8][c + 8]);
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // rows g and g+8

  const int n_kt = (t + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's readers are done
    if constexpr (K_SEQ_MINOR) {
      for (int idx = tid; idx < HD * (BK / 8); idx += THREADS) {
        const int c = idx / (BK / 8), ch = idx % (BK / 8);
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + ch * 8 < t)
          val = *reinterpret_cast<const uint4*>(k + (size_t)c * ldk + k0 + ch * 8);
        const bf16* e8 = reinterpret_cast<const bf16*>(&val);
#pragma unroll
        for (int e = 0; e < 8; ++e) s.k[ch * 8 + e][c] = e8[e];
      }
    } else {
      load_rows<BK, THREADS>(s.k, k, ldk, k0, t, tid);
    }
    for (int idx = tid; idx < BK * (HD / 8); idx += THREADS) {
      const int r = idx / (HD / 8), ch = idx % (HD / 8);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < t)
        val = *reinterpret_cast<const uint4*>(v + (size_t)(k0 + r) * ldv + ch * 8);
      const bf16* e8 = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e) s.vt[ch * 8 + e][r] = e8[e];
    }
    for (int j = tid; j < BK; j += THREADS) {
      const int gk = k0 + j;
      s.ok[j] = (gk < t && (valid == nullptr || valid[gk])) ? 1.f : 0.f;
    }
    __syncthreads();

    float sc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 + tg * 2;
        mma_bf16_16816(sc[nt], qa[kk], ld_bf16x2(&s.k[nt * 8 + g][c]),
                       ld_bf16x2(&s.k[nt * 8 + g][c + 8]));
      }
    }

    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = s.ok[nt * 8 + tg * 2 + e] != 0.f;
        sc[nt][e] = ok ? sc[nt][e] * scale : NEG;
        sc[nt][e + 2] = ok ? sc[nt][e + 2] * scale : NEG;
        mx0 = fmaxf(mx0, sc[nt][e]);
        mx1 = fmaxf(mx1, sc[nt][e + 2]);
      }
    }
    // the 4 lanes of a quad share a row
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[nt][e] = expf(sc[nt][e] - mn0);
        sc[nt][e + 2] = expf(sc[nt][e + 2] - mn1);
        sum0 += sc[nt][e];
        sum1 += sc[nt][e + 2];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      acc[dt][0] *= al0;
      acc[dt][1] *= al0;
      acc[dt][2] *= al1;
      acc[dt][3] *= al1;
    }

    // P (16 x BK per warp) as A fragments: the C layout of n-tiles 2kk and
    // 2kk+1 is exactly the A layout of the 16-key step kk.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const int c = kk * 16 + tg * 2;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
        mma_bf16_16816(acc[dt], pa, ld_bf16x2(&s.vt[dt * 8 + g][c]),
                       ld_bf16x2(&s.vt[dt * 8 + g][c + 8]));
    }
  }

  const float ls0 = fmaxf(l0, 1e-20f), ls1 = fmaxf(l1, 1e-20f);
  const int r0 = q0 + wr + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int c = dt * 8 + tg * 2;
    if (r0 < t)
      *reinterpret_cast<__nv_bfloat162*>(o + (size_t)r0 * ldo + c) =
          __floats2bfloat162_rn(acc[dt][0] / ls0, acc[dt][1] / ls0);
    if (r1 < t)
      *reinterpret_cast<__nv_bfloat162*>(o + (size_t)r1 * ldo + c) =
          __floats2bfloat162_rn(acc[dt][2] / ls1, acc[dt][3] / ls1);
  }
  if (lse != nullptr && tg == 0) {
    if (r0 < t) lse[r0] = m0 + logf(ls0);
    if (r1 < t) lse[r1] = m1 + logf(ls1);
  }
}


template <int BQ, int BK, bool K_SEQ_MINOR>
__global__ void __launch_bounds__(bf16_threads<BQ>())
splash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o, int t) {
  extern __shared__ __align__(16) char smem[];
  const size_t base = (size_t)blockIdx.x * t * HD;
  fwd_bf16<BQ, BK, K_SEQ_MINOR>(q + base, HD, k + base, K_SEQ_MINOR ? t : HD, v + base, HD,
                                nullptr, o + base, HD, nullptr, t, 1.f, blockIdx.y * BQ, smem);
}

template <int BQ, int BK, bool K_SEQ_MINOR>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int bh, int t,
           cudaStream_t stream) {
  const int smem = (int)sizeof(Bf16Smem<BQ, BK>);
  cudaError_t err = cudaFuncSetAttribute(splash_attention_kernel<BQ, BK, K_SEQ_MINOR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, t / BQ);
  splash_attention_kernel<BQ, BK, K_SEQ_MINOR>
      <<<grid, bf16_threads<BQ>(), smem, stream>>>(q, k, v, o, t);
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
