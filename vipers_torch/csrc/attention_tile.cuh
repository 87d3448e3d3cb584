// The blockwise attention forward tile shared by the port's flash kernels:
// flash_attention_fwd.cu (head-major (B*H, T, 64)), flash_attention_packed.cu
// (token-major packed qkv stripes) and splash_attention.cu (unmasked, K
// optionally seq-minor). A caller hands one (head, query tile) to a tile
// function as base pointers plus row strides, so the layout lives only in
// the kernel that computes those pointers.
//
// One block owns BQ query rows of one head and streams BK-key tiles of K/V
// through shared memory. The running row max m and sum l stay in f32
// registers (online softmax), so the (T, T) matrix never reaches device
// memory. Keys beyond t and keys whose valid byte is 0 get -1e9 on the f32
// scores (the JAX kernels' mask: exp underflows to 0 once a valid key has
// been seen); keys beyond t read as zero rows. Query rows beyond t are not
// written. Final: l_safe = max(l, 1e-20), O = acc / l_safe and, where an
// lse row is given, lse = m + log(l_safe).
//
//   f32 tile:  64 queries, 64-key tiles, 256 threads; a 16x16 thread grid,
//              each thread owns a 4x4 tile of S and a 4x16 strip of O; FMA
//              from padded shared memory (no TF32). q is multiplied by the
//              scale as it is loaded.
//   bf16 tile: BQ / 16 warps, each owns 16 query rows; S = Q K^T and
//              O += P V on mma.sync m16n8k16 with f32 accumulation, the
//              scale applied to the f32 scores; P goes from the S
//              accumulators to A fragments in registers (no smem trip), so
//              p is rounded to bf16 against the running max.
// These first versions are simple and right; they use no TMA or wgmma.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace attn_tile {

typedef __nv_bfloat16 bf16;

constexpr int HD = 64;  // head dim (every wrapper rejects any other)
constexpr float NEG = -1e9f;

// ------------------------------------------------------------ f32 / FMA
constexpr int F32_BQ = 64;
constexpr int F32_BK = 64;
constexpr int F32_THREADS = 256;
constexpr int F32_LD = HD + 1;  // padded row: conflict-free column reads

struct F32Smem {
  float q[F32_BQ][F32_LD];
  float k[F32_BK][F32_LD];
  float v[F32_BK][F32_LD];
  float p[F32_BQ][F32_LD];
  float ok[F32_BK];
};

// q, k, v: element (row, c) at ptr[row * ld + c]; o at o[row * ldo + c];
// valid: this head's key bytes (null = all valid); lse: this head's lse row
// (null = not written). The block computes query rows q0 .. q0 + 63.
__device__ void fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, int ld,
                        const uint8_t* __restrict__ valid, float* __restrict__ o,
                        int ldo, float* __restrict__ lse, int t, float scale,
                        int q0, char* smem_raw) {
  F32Smem& s = *reinterpret_cast<F32Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty*4+a, cols tx+16*i

  for (int idx = tid; idx < F32_BQ * HD; idx += F32_THREADS) {
    const int r = idx / HD, c = idx % HD;
    const int gq = q0 + r;
    s.q[r][c] = gq < t ? q[(size_t)gq * ld + c] * scale : 0.f;
  }

  float acc[4][4], m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG;
    l[a] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[a][i] = 0.f;
  }

  const int n_kt = (t + F32_BK - 1) / F32_BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * F32_BK;
    __syncthreads();  // previous tile's readers are done
    for (int idx = tid; idx < F32_BK * HD; idx += F32_THREADS) {
      const int r = idx / HD, c = idx % HD;
      const int gk = k0 + r;
      const bool in = gk < t;
      s.k[r][c] = in ? k[(size_t)gk * ld + c] : 0.f;
      s.v[r][c] = in ? v[(size_t)gk * ld + c] : 0.f;
    }
    if (tid < F32_BK) {
      const int gk = k0 + tid;
      s.ok[tid] = (gk < t && (valid == nullptr || valid[gk])) ? 1.f : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[a][i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = s.q[ty * 4 + a][d];
#pragma unroll
      for (int i = 0; i < 4; ++i) kb[i] = s.k[tx + 16 * i][d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[a][i] = fmaf(qa[a], kb[i], sc[a][i]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (s.ok[tx + 16 * i] == 0.f) sc[a][i] = NEG;
        mx = fmaxf(mx, sc[a][i]);
      }
      // the 16 threads sharing a row are the 16 lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float alpha = expf(m[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(sc[a][i] - m_new);
        s.p[ty * 4 + a][tx + 16 * i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[a] = l[a] * alpha + sum;
      m[a] = m_new;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[a][i] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < F32_BK; ++j) {
      float pa[4], vb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = s.p[ty * 4 + a][j];
#pragma unroll
      for (int i = 0; i < 4; ++i) vb[i] = s.v[j][tx + 16 * i];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[a][i] = fmaf(pa[a], vb[i], acc[a][i]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gq = q0 + ty * 4 + a;
    if (gq >= t) continue;
    const float l_safe = fmaxf(l[a], 1e-20f);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[(size_t)gq * ldo + tx + 16 * i] = acc[a][i] / l_safe;
    if (lse != nullptr && tx == 0) lse[gq] = m[a] + logf(l_safe);
  }
}

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

}  // namespace attn_tile
