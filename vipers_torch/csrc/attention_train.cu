// Short-T training attention for Hopper (sm_90a): exact-softmax forward and
// one-pass backward, bf16 in and out, f32 accumulation.
//
// Replaces the TPU kernels of vipers/ops/attention_train.py: _fwd (:207) and
// _fwd_packed (:276) with the forward here, _bwd (:225) and _bwd_packed
// (:294) with the backward here. Both take q, k, v (and dq, dk, dv) as three
// base pointers over a (B*H, T, 64) layout, so the packed entry passes the
// three slabs of one contiguous (3, B, H, T, 64) buffer (and writes one
// packed dqkv) and the unpacked entry passes three tensors: one kernel pair
// serves both.
//
// Arithmetic (the Pallas kernels', attention_train.py:52-114):
//   qs = bf16(q * scale); s = qs . k^T in f32; pad keys get -1e9;
//   forward:  m = max over ALL keys, p = exp(s - m), l = sum p (f32),
//             o = bf16((bf16(p) . v) / l), lse = m + log l;
//   backward: p = exp(s - lse), D = rowsum(f32(dO) * f32(O)),
//             dV = bf16(p)^T . dO, dP = dO . V^T, dS = bf16((dP - D) * p),
//             dQ = (dS . K) * scale, dK = dS^T . qs; stored in bf16.
// Pad-query rows are computed like any other row; their cotangents are zero
// by contract (attention_train.py:26-28), so they add nothing to dK, dV.
//
// Forward: one block per (b*h, 64-query tile), 4 warps of 16 query rows.
// The TPU program holds the whole (T, T) f32 score matrix in VMEM; a block
// here cannot (256 KB at T = 256). To keep the exact softmax (p rounded to
// bf16 against the final row max, as the TPU does) without it, the block
// makes two passes over the 64-key tiles: pass 1 computes S for the row
// max, pass 2 recomputes S, forms p against that max and accumulates P.V.
// An online softmax would round p against a running max and rescale the
// bf16 products afterwards; the two passes cost one more Q.K^T instead.
//
// Backward: one block per b*h. It loops over 64-key tiles outside and
// 64-query tiles inside; each warp owns 16 keys of the key tile, so dK_j and
// dV_j accumulate in registers (S^T, P^T, dP^T and dS^T are computed
// key-major). dQ needs the sum over all key tiles: dS goes through shared
// memory, each warp multiplies 16 query rows of it by K_j and adds the
// result to an f32 scratch row of global memory that only this block and
// this thread touch (deterministic, no atomics); the last key tile writes
// bf16(dQ * scale) instead. D, lse and the key mask of the whole row sit in
// shared memory from a prologue.
//
// Softmax-precision variants (the TPU's tools/bench_softmax_prec.py fwd
// :124 and bwd :137, bodies fwd_kernel :38 and bwd_kernel :75), a template
// parameter of both kernels; the model path runs F32 only:
//   F32:     the arithmetic above (the train kernels, instruction for
//            instruction);
//   BF16EXP: p = exp(bf16(s - m)) evaluated on bf16 pairs (h2exp), l summed
//            in f32 from the bf16 p; the backward's p = exp(bf16(s - lse))
//            stays bf16 into both dV and dS = bf16((dP - D) * p);
//   NORMP:   forward only, p / l rounded to bf16 before P.V and no division
//            after. It needs l before the P.V pass, so pass 1 carries l
//            online next to the row max (rescaled on a new max), which
//            differs from the exact sum by f32 rounding only.
//
// Bound on the card: at the ViT-S/16 train shape (B*H = 768, T = 256,
// bf16) the forward does 12.9 GFLOP on ~101 MB of I/O and the backward
// 32.2 GFLOP on ~202 MB, so both are bound by bytes (0.030 and 0.060 ms at
// 3.35 TB/s). This first version is simple and right: mma.sync m16n8k16,
// plain 16-byte loads, no TMA, wgmma or persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HD = 64;       // head dim (the wrapper rejects any other)
constexpr int TILE = 64;     // queries and keys per tile
constexpr int THREADS = 128;  // 4 warps x 16 rows
constexpr int LD = HD + 8;   // 144-byte rows: conflict-free fragment reads
constexpr int MAX_T = 1024;
constexpr float NEG = -1e9f;

// 64 rows of src (row stride HD) into dst[row][col].
__device__ __forceinline__ void load_rows(bf16 (*dst)[LD], const bf16* src, int tid) {
  for (int idx = tid; idx < TILE * (HD / 8); idx += THREADS) {
    const int r = idx >> 3, ch = idx & 7;
    *reinterpret_cast<uint4*>(&dst[r][ch * 8]) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * HD + ch * 8);
  }
}

// 64 rows of src into rows[row][col] (if given) and cols[col][row] (if
// given), optionally multiplied by scale and rounded to bf16 first.
__device__ __forceinline__ void load_tile(bf16 (*rows)[LD], bf16 (*cols)[LD],
                                          const bf16* src, float scale,
                                          bool scaled, int tid) {
  for (int idx = tid; idx < TILE * (HD / 8); idx += THREADS) {
    const int r = idx >> 3, ch = idx & 7;
    uint4 val = *reinterpret_cast<const uint4*>(src + (size_t)r * HD + ch * 8);
    bf16* e8 = reinterpret_cast<bf16*>(&val);
    if (scaled) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        e8[e] = __float2bfloat16_rn(__bfloat162float(e8[e]) * scale);
    }
    if (rows) *reinterpret_cast<uint4*>(&rows[r][ch * 8]) = val;
    if (cols) {
#pragma unroll
      for (int e = 0; e < 8; ++e) cols[ch * 8 + e][r] = e8[e];
    }
  }
}

// A fragments (16 rows x 64 cols as 4 k-steps) of rows r0.. of a tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4],
                                       bf16 (*src)[LD], int r0, int g, int tg) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + tg * 2;
    a[kk][0] = ld_bf16x2(&src[r0 + g][c]);
    a[kk][1] = ld_bf16x2(&src[r0 + g + 8][c]);
    a[kk][2] = ld_bf16x2(&src[r0 + g][c + 8]);
    a[kk][3] = ld_bf16x2(&src[r0 + g + 8][c + 8]);
  }
}

// acc[nt] (16 x 64 as 8 n-tiles) = A (16 x 64) . B^T, B stored [n][k].
__device__ __forceinline__ void mma_16x64(float (&acc)[TILE / 8][4],
                                          const uint32_t (&a)[HD / 16][4],
                                          bf16 (*b)[LD], int g, int tg) {
#pragma unroll
  for (int nt = 0; nt < TILE / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk * 16 + tg * 2;
      mma_bf16_16816(acc[nt], a[kk], ld_bf16x2(&b[nt * 8 + g][c]),
                     ld_bf16x2(&b[nt * 8 + g][c + 8]));
    }
  }
}

// acc[dt] += P (16 x 64, C fragments in f32, rounded to bf16 here) . B^T,
// B stored [n][k]: the C layout of n-tiles 2kk and 2kk+1 is the A layout
// of the 16-wide k-step kk.
__device__ __forceinline__ void mma_p(float (&acc)[HD / 8][4],
                                      const float (&p)[TILE / 8][4],
                                      bf16 (*b)[LD], int g, int tg) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16x2(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16x2(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const int c = kk * 16 + tg * 2;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      mma_bf16_16816(acc[dt], pa, ld_bf16x2(&b[dt * 8 + g][c]),
                     ld_bf16x2(&b[dt * 8 + g][c + 8]));
  }
}

// ------------------------------------------------------------- forward
struct FwdSmem {
  bf16 q[TILE][LD];   // q * scale, [query][dim]
  bf16 k[TILE][LD];   // [key][dim]
  bf16 vt[HD][LD];    // V transposed, [dim][key]
  float ok[MAX_T];    // key mask of this batch row
};

enum FwdVariant { FWD_F32 = 0, FWD_BF16EXP = 1, FWD_NORMP = 2 };
enum BwdVariant { BWD_F32 = 0, BWD_BF16EXP = 1 };

// exp(bf16(a)), exp(bf16(b)) on one bf16 pair, back in f32
__device__ __forceinline__ float2 exp_bf16x2(float a, float b) {
  return __bfloat1622float2(h2exp(__floats2bfloat162_rn(a, b)));
}

template <int VARIANT>
__global__ void __launch_bounds__(THREADS)
attention_train_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const uint8_t* __restrict__ valid,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           int heads, int t, float scale) {
  extern __shared__ __align__(16) char smem_raw[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * TILE;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wr = warp * 16;
  const size_t base = (size_t)bh * t * HD;
  const uint8_t* vrow = valid + (size_t)(bh / heads) * t;

  for (int j = tid; j < t; j += THREADS) s.ok[j] = vrow[j] ? 1.f : 0.f;
  load_tile(s.q, nullptr, q + base + (size_t)q0 * HD, scale, true, tid);
  __syncthreads();
  uint32_t qa[HD / 16][4];
  load_a(qa, s.q, wr, g, tg);

  const int n_kt = t / TILE;
  float sc[TILE / 8][4];

  // pass 1: the exact row max over all keys (rows g and g+8 of the warp);
  // NORMP also carries this thread's share of l against its running max
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // previous tile's readers are done
    load_rows(s.k, k + base + (size_t)k0 * HD, tid);
    __syncthreads();
    mma_16x64(sc, qa, s.k, g, tg);
    float mt0 = m0, mt1 = m1;
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = s.ok[k0 + nt * 8 + tg * 2 + e] != 0.f;
        if (VARIANT == FWD_NORMP) {
          sc[nt][e] = ok ? sc[nt][e] : NEG;
          sc[nt][e + 2] = ok ? sc[nt][e + 2] : NEG;
        }
        mt0 = fmaxf(mt0, ok ? sc[nt][e] : NEG);
        mt1 = fmaxf(mt1, ok ? sc[nt][e + 2] : NEG);
      }
    }
    if (VARIANT == FWD_NORMP) {
      l0 *= expf(m0 - mt0);
      l1 *= expf(m1 - mt1);
#pragma unroll
      for (int nt = 0; nt < TILE / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          l0 += expf(sc[nt][e] - mt0);
          l1 += expf(sc[nt][e + 2] - mt1);
        }
      }
    }
    m0 = mt0;
    m1 = mt1;
  }
  float mq0 = m0, mq1 = m1;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a quad share a row
    mq0 = fmaxf(mq0, __shfl_xor_sync(0xffffffffu, mq0, off));
    mq1 = fmaxf(mq1, __shfl_xor_sync(0xffffffffu, mq1, off));
  }
  if (VARIANT == FWD_NORMP) {
    l0 *= expf(m0 - mq0);
    l1 *= expf(m1 - mq1);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
  }
  m0 = mq0;
  m1 = mq1;

  // pass 2: p = exp(s - m), l = sum p, acc = bf16(p) . V (NORMP:
  // acc = bf16(p / l) . V)
  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_rows(s.k, k + base + (size_t)k0 * HD, tid);
    load_tile(nullptr, s.vt, v + base + (size_t)k0 * HD, 1.f, false, tid);
    __syncthreads();
    mma_16x64(sc, qa, s.k, g, tg);
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt) {
      if (VARIANT == FWD_BF16EXP) {
        const bool ok0 = s.ok[k0 + nt * 8 + tg * 2] != 0.f;
        const bool ok1 = s.ok[k0 + nt * 8 + tg * 2 + 1] != 0.f;
        const float2 p0 = exp_bf16x2((ok0 ? sc[nt][0] : NEG) - m0,
                                     (ok1 ? sc[nt][1] : NEG) - m0);
        const float2 p1 = exp_bf16x2((ok0 ? sc[nt][2] : NEG) - m1,
                                     (ok1 ? sc[nt][3] : NEG) - m1);
        sc[nt][0] = p0.x;
        sc[nt][1] = p0.y;
        sc[nt][2] = p1.x;
        sc[nt][3] = p1.y;
        l0 += p0.x + p0.y;
        l1 += p1.x + p1.y;
        continue;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = s.ok[k0 + nt * 8 + tg * 2 + e] != 0.f;
        sc[nt][e] = expf((ok ? sc[nt][e] : NEG) - m0);
        sc[nt][e + 2] = expf((ok ? sc[nt][e + 2] : NEG) - m1);
        if (VARIANT == FWD_NORMP) {
          sc[nt][e] /= l0;
          sc[nt][e + 2] /= l1;
        } else {
          l0 += sc[nt][e];
          l1 += sc[nt][e + 2];
        }
      }
    }
    mma_p(acc, sc, s.vt, g, tg);
  }
  if (VARIANT != FWD_NORMP) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
  }

  const float od0 = VARIANT == FWD_NORMP ? 1.f : l0;
  const float od1 = VARIANT == FWD_NORMP ? 1.f : l1;
  const int r0 = q0 + wr + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int c = dt * 8 + tg * 2;
    *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)r0 * HD + c) =
        __floats2bfloat162_rn(acc[dt][0] / od0, acc[dt][1] / od0);
    *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)r1 * HD + c) =
        __floats2bfloat162_rn(acc[dt][2] / od1, acc[dt][3] / od1);
  }
  if (tg == 0) {
    lse[(size_t)bh * t + r0] = m0 + logf(l0);
    lse[(size_t)bh * t + r1] = m1 + logf(l1);
  }
}

// ------------------------------------------------------------ backward
struct BwdSmem {
  bf16 k[TILE][LD];    // K_j [key][dim]
  bf16 kt[HD][LD];     // K_j^T [dim][key]
  bf16 v[TILE][LD];    // V_j [key][dim]
  bf16 q[TILE][LD];    // (q * scale)_i [query][dim]
  bf16 qt[HD][LD];     // (q * scale)_i^T [dim][query]
  bf16 dout[TILE][LD];   // dO_i [query][dim]
  bf16 doutt[HD][LD];    // dO_i^T [dim][query]
  bf16 ds[TILE][LD];   // dS_i [query][key]
  float ok[MAX_T];     // key mask of this batch row
  float lse[MAX_T];
  float dsum[MAX_T];   // D = rowsum(dO * O)
};

template <int VARIANT>
__global__ void __launch_bounds__(THREADS)
attention_train_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ o,
                           const float* __restrict__ lse,
                           const bf16* __restrict__ dout,
                           const uint8_t* __restrict__ valid,
                           bf16* __restrict__ dq, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, float* __restrict__ dq_acc,
                           int heads, int t, float scale) {
  extern __shared__ __align__(16) char smem_raw[];
  BwdSmem& s = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wr = warp * 16;
  const size_t base = (size_t)bh * t * HD;
  const uint8_t* vrow = valid + (size_t)(bh / heads) * t;

  // prologue: key mask, lse and D of every row of this (b, h)
  for (int r = tid; r < t; r += THREADS) {
    s.ok[r] = vrow[r] ? 1.f : 0.f;
    s.lse[r] = lse[(size_t)bh * t + r];
    float d = 0.f;
#pragma unroll
    for (int ch = 0; ch < HD / 8; ++ch) {
      uint4 a = *reinterpret_cast<const uint4*>(dout + base + (size_t)r * HD + ch * 8);
      uint4 b = *reinterpret_cast<const uint4*>(o + base + (size_t)r * HD + ch * 8);
      const bf16* ea = reinterpret_cast<const bf16*>(&a);
      const bf16* eb = reinterpret_cast<const bf16*>(&b);
#pragma unroll
      for (int e = 0; e < 8; ++e) d += __bfloat162float(ea[e]) * __bfloat162float(eb[e]);
    }
    s.dsum[r] = d;
  }

  const int n_t = t / TILE;
  for (int jt = 0; jt < n_t; ++jt) {
    const int k0 = jt * TILE;
    __syncthreads();  // the previous key tile's readers are done
    load_tile(s.k, s.kt, k + base + (size_t)k0 * HD, 1.f, false, tid);
    load_rows(s.v, v + base + (size_t)k0 * HD, tid);

    float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

    for (int it = 0; it < n_t; ++it) {
      const int q0 = it * TILE;
      __syncthreads();  // the previous query tile's readers are done
      load_tile(s.q, s.qt, q + base + (size_t)q0 * HD, scale, true, tid);
      load_tile(s.dout, s.doutt, dout + base + (size_t)q0 * HD, 1.f, false, tid);
      __syncthreads();

      // this warp's 16 keys (rows wr+g, wr+g+8 of the key tile)
      const bool ok0 = s.ok[k0 + wr + g] != 0.f;
      const bool ok1 = s.ok[k0 + wr + g + 8] != 0.f;
      uint32_t fa[HD / 16][4];

      // P^T = exp(S^T - lse), S^T = K . (q*scale)^T  (keys x queries)
      float pt[TILE / 8][4];
      load_a(fa, s.k, wr, g, tg);
      mma_16x64(pt, fa, s.q, g, tg);
#pragma unroll
      for (int nt = 0; nt < TILE / 8; ++nt) {
        if (VARIANT == BWD_BF16EXP) {
          const float lq0 = s.lse[q0 + nt * 8 + tg * 2];
          const float lq1 = s.lse[q0 + nt * 8 + tg * 2 + 1];
          const float2 p0 = exp_bf16x2((ok0 ? pt[nt][0] : NEG) - lq0,
                                       (ok0 ? pt[nt][1] : NEG) - lq1);
          const float2 p1 = exp_bf16x2((ok1 ? pt[nt][2] : NEG) - lq0,
                                       (ok1 ? pt[nt][3] : NEG) - lq1);
          pt[nt][0] = p0.x;
          pt[nt][1] = p0.y;
          pt[nt][2] = p1.x;
          pt[nt][3] = p1.y;
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lq = s.lse[q0 + nt * 8 + tg * 2 + e];
          pt[nt][e] = expf((ok0 ? pt[nt][e] : NEG) - lq);
          pt[nt][e + 2] = expf((ok1 ? pt[nt][e + 2] : NEG) - lq);
        }
      }
      // dV_j += bf16(P)^T . dO
      mma_p(dva, pt, s.doutt, g, tg);

      // dP^T = V . dO^T; dS^T = (dP^T - D) * P^T  (rounded to bf16 below)
      float dst[TILE / 8][4];
      load_a(fa, s.v, wr, g, tg);
      mma_16x64(dst, fa, s.dout, g, tg);
#pragma unroll
      for (int nt = 0; nt < TILE / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d_row = s.dsum[q0 + nt * 8 + tg * 2 + e];
          dst[nt][e] = (dst[nt][e] - d_row) * pt[nt][e];
          dst[nt][e + 2] = (dst[nt][e + 2] - d_row) * pt[nt][e + 2];
        }
      }
      // dK_j += bf16(dS)^T . (q*scale)
      mma_p(dka, dst, s.qt, g, tg);

      // dS (queries x keys) to shared memory for dQ
#pragma unroll
      for (int nt = 0; nt < TILE / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = nt * 8 + tg * 2 + e;
          s.ds[c][wr + g] = __float2bfloat16_rn(dst[nt][e]);
          s.ds[c][wr + g + 8] = __float2bfloat16_rn(dst[nt][e + 2]);
        }
      }
      __syncthreads();

      // dQ_i rows wr.. += dS . K_j, into the f32 scratch; the last key tile
      // writes bf16(dQ * scale)
      float dqa[HD / 8][4];
      load_a(fa, s.ds, wr, g, tg);
      mma_16x64(dqa, fa, s.kt, g, tg);
      const int r0 = q0 + wr + g, r1 = r0 + 8;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const int c = dt * 8 + tg * 2;
        float2* a0 = reinterpret_cast<float2*>(dq_acc + base + (size_t)r0 * HD + c);
        float2* a1 = reinterpret_cast<float2*>(dq_acc + base + (size_t)r1 * HD + c);
        float2 v0 = make_float2(dqa[dt][0], dqa[dt][1]);
        float2 v1 = make_float2(dqa[dt][2], dqa[dt][3]);
        if (jt > 0) {
          const float2 p0 = *a0, p1 = *a1;
          v0.x += p0.x; v0.y += p0.y;
          v1.x += p1.x; v1.y += p1.y;
        }
        if (jt == n_t - 1) {
          *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)r0 * HD + c) =
              __floats2bfloat162_rn(v0.x * scale, v0.y * scale);
          *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)r1 * HD + c) =
              __floats2bfloat162_rn(v1.x * scale, v1.y * scale);
        } else {
          *a0 = v0;
          *a1 = v1;
        }
      }
    }

    const int r0 = k0 + wr + g, r1 = r0 + 8;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const int c = dt * 8 + tg * 2;
      *reinterpret_cast<__nv_bfloat162*>(dk + base + (size_t)r0 * HD + c) =
          __floats2bfloat162_rn(dka[dt][0], dka[dt][1]);
      *reinterpret_cast<__nv_bfloat162*>(dk + base + (size_t)r1 * HD + c) =
          __floats2bfloat162_rn(dka[dt][2], dka[dt][3]);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + (size_t)r0 * HD + c) =
          __floats2bfloat162_rn(dva[dt][0], dva[dt][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + (size_t)r1 * HD + c) =
          __floats2bfloat162_rn(dva[dt][2], dva[dt][3]);
    }
  }
}

bool shape_ok(int bh, int heads, int t, int head_dim) {
  return head_dim == HD && bh > 0 && heads > 0 && bh % heads == 0 && t > 0 &&
         t % TILE == 0 && t <= MAX_T;
}

template <int VARIANT>
int launch_fwd(const void* q, const void* k, const void* v, const uint8_t* valid,
               void* o, float* lse, int bh, int heads, int t, float scale,
               cudaStream_t stream) {
  const int smem = (int)sizeof(FwdSmem);
  cudaError_t err = cudaFuncSetAttribute(attention_train_fwd_kernel<VARIANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  attention_train_fwd_kernel<VARIANT><<<dim3(bh, t / TILE), THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), valid, static_cast<bf16*>(o), lse, heads, t,
      scale);
  return (int)cudaGetLastError();
}

template <int VARIANT>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, const uint8_t* valid, void* dq,
               void* dk, void* dv, float* dq_acc, int bh, int heads, int t,
               float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(BwdSmem);
  cudaError_t err = cudaFuncSetAttribute(attention_train_bwd_kernel<VARIANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  attention_train_bwd_kernel<VARIANT><<<bh, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o), lse,
      static_cast<const bf16*>(dout), valid, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), dq_acc, heads, t, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (bh, t, 64) bf16, contiguous each; valid: (bh / heads, t)
// bytes, nonzero = attend; lse: (bh, t) float32. t % 64 == 0, t <= 1024.
// variant: 0 = F32, 1 = BF16EXP, 2 = NORMP. Returns a cudaError_t
// (0 = launched).
extern "C" int vipers_attention_train_fwd(const void* q, const void* k,
                                          const void* v, const uint8_t* valid,
                                          void* o, float* lse, int bh,
                                          int heads, int t, int head_dim,
                                          float scale, int variant,
                                          void* stream) {
  if (!shape_ok(bh, heads, t, head_dim) || valid == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case FWD_F32:
      return launch_fwd<FWD_F32>(q, k, v, valid, o, lse, bh, heads, t, scale, st);
    case FWD_BF16EXP:
      return launch_fwd<FWD_BF16EXP>(q, k, v, valid, o, lse, bh, heads, t, scale, st);
    case FWD_NORMP:
      return launch_fwd<FWD_NORMP>(q, k, v, valid, o, lse, bh, heads, t, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Inputs as for the forward plus o, lse and dout (bh, t, 64) bf16; outputs
// dq, dk, dv (bh, t, 64) bf16 and an f32 scratch dq_acc (bh, t, 64) that
// needs no initialisation. variant: 0 = F32, 1 = BF16EXP.
extern "C" int vipers_attention_train_bwd(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const float* lse, const void* dout,
                                          const uint8_t* valid, void* dq,
                                          void* dk, void* dv, float* dq_acc,
                                          int bh, int heads, int t,
                                          int head_dim, float scale,
                                          int variant, void* stream) {
  if (!shape_ok(bh, heads, t, head_dim) || valid == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case BWD_F32:
      return launch_bwd<BWD_F32>(q, k, v, o, lse, dout, valid, dq, dk, dv, dq_acc,
                                 bh, heads, t, scale, st);
    case BWD_BF16EXP:
      return launch_bwd<BWD_BF16EXP>(q, k, v, o, lse, dout, valid, dq, dk, dv,
                                     dq_acc, bh, heads, t, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
