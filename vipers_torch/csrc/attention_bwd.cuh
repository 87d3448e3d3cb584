// The training kernels' one-pass attention backward for Hopper (sm_90a),
// bf16 in and out, f32 accumulation, instantiated by attention_train.cu
// (replacing vipers/ops/attention_train.py _bwd (:225) and _bwd_packed
// (:294) and the softmax-precision tool's bwd (bench_softmax_prec.py
// :137)); t % 64 == 0, t <= 1024, a key mask always given; head dim D = 64,
// or 80 (vit_h_14's 16 heads of 80, the model path's F32 variant only).
//
// Arithmetic (the Pallas kernels'):
//   qs = bf16(q * scale); s = qs . k^T in f32; keys whose valid byte is 0
//   get -1e9, keys beyond t -inf (p = 0);
//   p = exp(s - lse), D = rowsum(f32(dO) * f32(O)),
//   dV = bf16(p)^T . dO, dP = dO . V^T, dS = bf16((dP - D) * p),
//   dQ = (dS . K) * scale, dK = dS^T . qs; stored in bf16.
// Pad-query rows are computed like any other row; the model's cotangents
// on them are zero. A row whose keys are all invalid has lse = -1e9 (the
// forward's -1e9 + log l rounds to it in f32), so p = exp(-1e9 - lse) = 1
// for each of its t keys, as in JAX.
//
// Design: one CTA per (b, h) at a time, persistent over the heads, and a
// deterministic dQ with no atomics. Two consumer warpgroups own 128 keys of
// the head each, as two m64 halves, with dK and dV accumulating in
// registers; a round's 256 keys are resident as K and V (64 KB). Q, dO, O
// and the lse row stream through a TMA ring of three 64-query stages. A
// pre-pass over each block multiplies Q by the scale in place, takes lse
// to log2 units and sums D = rowsum(dO * O) (fence.proxy.async and a named
// barrier before wgmma reads them). Per key half and SUB = 32 queries of the
// block (N = 32 keeps S^T and dP^T at 16 registers each beside dK and dV's
// 128: at N = 64 ptxas spilled and serialized the wgmma pipeline), every
// product is one wgmma with its operands K-major or through the transpose
// bit:
//   S^T = K . qs^T and dP^T = V . dO^T (both K-major), one group;
//   P^T = exp(S^T - lse); dS^T = bf16((dP^T - D) * P^T);
//   dV += bf16(P^T) . dO and dK += dS^T . qs (register A; dO and qs
//   MN-major), one group.
// dS^T goes to a staging buffer by stmatrix in the 128-byte swizzle,
// [key][query]. After a named barrier one warpgroup, alternating by block,
// computes dQ = dS . K over the round's 256 keys: A is dS read MN-major
// through the transpose bit on A, B is K, MN-major; both then hold one
// swizzle row along M or N, the layout of the forward's V. The staging is
// double-buffered, so the next block's S^T overlaps this block's dQ. Where
// t > 256 the keys go in rounds of 256 and dQ is summed in an f32 scratch
// of the head, written once per (round, query block) by the warpgroup that
// owns the block (the same threads each round: no synchronisation).
//
// Head dim 80: a 160-byte row fits no swizzle row, so each row of Q, K, V,
// O and dO is two TMA boxes from two tensor maps (attention_tile.cuh's
// design for the flash forward): its first 64 columns as above and a
// 16-column tail of 32 bytes with the 32-byte swizzle, in tiles of their
// own. S^T and dP^T take a fifth k16 step from the tails (K-major); dV, dK
// and dQ are an n64 product into their first eight 8-column groups and an
// n16 product on the tail tile (MN-major through the transpose bit) into
// the last two. Nothing is padded. A round holds 128 keys, one m64 half a
// warpgroup: dK and dV of two halves would take 160 registers a thread
// (ptxas spilled 784 bytes at 256 keys a round), and 256 keys with three
// stages would not fit in shared memory (238 KB).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace attn_bwd {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int HD = 64;       // head dim of the first part of a row (64 or 80 in all)
constexpr int ROW = HD * 2;  // bytes in a row's first part: one 128-byte swizzle row
constexpr int TROW = 32;     // bytes in a tail row at hd 80: one 32-byte swizzle row
constexpr int CHUNK = 256;   // keys resident at once
constexpr float NEG = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG2 = NEG * LOG2E;  // the -1e9 mask in log2 units

// Columns of a row beyond HD: 0, or 16 at hd 80.
template <int D>
__host__ __device__ constexpr int tail_of() {
  static_assert(D == HD || D == HD + 16, "head dim 64 or 80");
  return D - HD;
}

constexpr int WGS = 2;                    // consumer warpgroups
constexpr int CONSUMERS = 4 * WGS;        // consumer warps
constexpr int THREADS = 128 * (WGS + 1);  // + the producer warpgroup
// Registers a thread: R0 at launch (the launch bounds' share, in 8s),
// CREGS for a consumer, 24 for the producer. setmaxnreg.inc draws only on
// what the producer warpgroup gave back, and waits for it forever.
constexpr int R0 = (65536 / THREADS) & ~7;
constexpr int CREGS = 240;
static_assert(WGS * 128 * (CREGS - R0) <= 128 * (R0 - 24), "consumer registers");

// The tensor maps of the rows' 16-column tails at hd 80 (boxes of 16
// columns, 32-byte swizzle, read at column HD); none at hd 64. The forward
// uses q, k and v.
template <int TAIL>
struct Tails {
  CUtensorMap q, k, v, o, dout;
};
template <>
struct Tails<0> {};

enum BwdVariant { BWD_F32 = 0, BWD_BF16EXP = 1 };

// exp(bf16(a)), exp(bf16(b)) on one bf16 pair, back in f32
__device__ __forceinline__ float2 exp_bf16x2(float a, float b) {
  return __bfloat1622float2(h2exp(__floats2bfloat162_rn(a, b)));
}

// `rows` rows of RB bytes of a swizzled bf16 tile times the bf16 scale,
// rounded to bf16 (the TPU's bf16(q * scale)), by threads tid of n. The
// swizzle permutes 16-byte chunks within a row, which an elementwise pass
// does not see.
template <int RB = ROW>
__device__ __forceinline__ void scale_rows(bf16* tile, int rows, float scale, int tid, int n) {
  uint4* p = reinterpret_cast<uint4*>(tile);
  for (int i = tid; i < rows * (RB / 16); i += n) {
    uint4 val = p[i];
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      e[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    p[i] = val;
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rowsum(f32(a) * f32(b)) over the 8 bf16 of one 16-byte chunk
__device__ __forceinline__ float dot_chunk(uint4 a, uint4 b, float d) {
  const __nv_bfloat162* ea = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* eb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 fa = __bfloat1622float2(ea[e]), fb = __bfloat1622float2(eb[e]);
    d = fmaf(fa.x, fb.x, fmaf(fa.y, fb.y, d));
  }
  return d;
}

// A 3-D map over one (bh, t, D) operand in boxes of `rows` rows of its
// first 64 columns; rows beyond t read as zeros.
template <int D>
inline int head_map(CUtensorMap* map, const void* base, int bh, int t, int rows) {
  return encode_map(map, base, D, t, bh, D, (long long)t * D, rows);
}

// The same over the rows' last 16 columns (hd 80), 32-byte swizzle.
template <int D>
inline int tail_map(CUtensorMap* map, const void* base, int bh, int t, int rows) {
  return encode_map_tail(map, base, D, t, bh, D, (long long)t * D, rows);
}

constexpr int BWD_BQ = 64;     // queries of a block
constexpr int SUB = 32;        // queries of one S^T / dP^T product
constexpr int BWD_STAGES = 3;  // query blocks in the ring

// Keys a round by head dim: CHUNK, two m64 halves a warpgroup, at hd 64;
// one half at hd 80 (registers; see above).
template <int D>
__host__ __device__ constexpr int bwd_chunk() {
  return D == HD ? CHUNK : CHUNK / 2;
}

struct alignas(1024) BwdStage {
  bf16 q[BWD_BQ * HD];  // q, then q * scale after the block's pre-pass
  bf16 dout[BWD_BQ * HD];
  bf16 o[BWD_BQ * HD];
  float lse[BWD_BQ];   // in log2 units after the pre-pass
  float dsum[BWD_BQ];  // D of the block's rows
};

// The tails' tiles (hd 80) for rounds of CH keys, 32 bytes a row, every
// tile 256-byte aligned (the 32-byte swizzle's atom), the whole a multiple
// of 1024 bytes; an empty base at hd 64, which takes no bytes.
template <int TAIL, int CH>
struct alignas(1024) BwdTailSmem {
  bf16 kt[CH * TAIL], vt[CH * TAIL];
  bf16 qt[BWD_STAGES][BWD_BQ * TAIL], dt[BWD_STAGES][BWD_BQ * TAIL];
  bf16 ot[BWD_STAGES][BWD_BQ * TAIL];
};
template <int CH>
struct BwdTailSmem<0, CH> {};

template <int D>
struct BwdSmem : BwdTailSmem<tail_of<D>(), bwd_chunk<D>()> {
  bf16 k[bwd_chunk<D>() * HD];  // the round's keys, [key][dim]
  bf16 v[bwd_chunk<D>() * HD];
  bf16 ds[2][bwd_chunk<D>() * BWD_BQ];  // dS^T staging, [key][query]
  BwdStage st[BWD_STAGES];
  uint64_t full[BWD_STAGES], empty[BWD_STAGES], kv_full, kv_empty;
};
template <int D>
__host__ __device__ constexpr int bwd_smem() {
  return (int)sizeof(BwdSmem<D>) + 1024;
}
static_assert(bwd_smem<HD + 16>() <= 232448, "hd-80 backward shared memory");
template <int D>
__host__ __device__ constexpr int bwd_stage_tx() {  // Q, dO, O tiles and the lse row
  return 3 * BWD_BQ * D * 2 + BWD_BQ * 4;
}

// ONE: t <= bwd_chunk<D>(), one round of keys and no f32 scratch, compiled
// on its own.
// D: the head dim; at 80 `tails` holds the maps of the rows' last 16 columns
// (last, so that the hd-64 instances' parameters lie where they lay before).
template <int VARIANT, bool ONE, int D = HD>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_o,
                     const __grid_constant__ CUtensorMap map_do,
                     const float* __restrict__ lse, const uint8_t* __restrict__ valid,
                     bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     float* __restrict__ dq_acc, int n_bh, int heads, int t, float scale,
                     const __grid_constant__ Tails<tail_of<D>()> tails) {
  constexpr int TAIL = tail_of<D>(), CH = bwd_chunk<D>(), HALVES = CH / 128;
  constexpr int NU = BWD_BQ / SUB;  // query parts of a block
  extern __shared__ __align__(128) char smem_dyn[];
  BwdSmem<D>& s = *reinterpret_cast<BwdSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_blk = t / BWD_BQ, n_rounds = ONE ? 1 : (t + CH - 1) / CH;

  if (threadIdx.x == 0) {
    for (int i = 0; i < BWD_STAGES; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], CONSUMERS);
    }
    mbar_init(&s.kv_full, 1);
    mbar_init(&s.kv_empty, CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS) {  // ------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == CONSUMERS && lane == 0) {
      uint32_t it = 0, kv_i = 0;  // blocks and key rounds requested
      for (int bh = blockIdx.x; bh < n_bh; bh += gridDim.x)
        for (int r = 0; r < n_rounds; ++r, ++kv_i)
          for (int i = 0; i < n_blk; ++i, ++it) {
            const int st = it % BWD_STAGES;
            mbar_wait(&s.empty[st], ((it / BWD_STAGES) & 1) ^ 1);
            BwdStage& sb = s.st[st];
            mbar_expect_tx(&s.full[st], bwd_stage_tx<D>());
            tma_load_3d(sb.q, &map_q, &s.full[st], 0, i * BWD_BQ, bh);
            tma_load_3d(sb.dout, &map_do, &s.full[st], 0, i * BWD_BQ, bh);
            tma_load_3d(sb.o, &map_o, &s.full[st], 0, i * BWD_BQ, bh);
            if constexpr (TAIL > 0) {
              tma_load_3d(s.qt[st], &tails.q, &s.full[st], HD, i * BWD_BQ, bh);
              tma_load_3d(s.dt[st], &tails.dout, &s.full[st], HD, i * BWD_BQ, bh);
              tma_load_3d(s.ot[st], &tails.o, &s.full[st], HD, i * BWD_BQ, bh);
            }
            bulk_load(sb.lse, lse + (size_t)bh * t + i * BWD_BQ, BWD_BQ * 4, &s.full[st]);
            if (i == 0) {  // the round's K and V, once its first block is on its way
              mbar_wait(&s.kv_empty, (kv_i & 1) ^ 1);
              mbar_expect_tx(&s.kv_full, 2 * CH * D * 2);
              tma_load_3d(s.k, &map_k, &s.kv_full, 0, r * CH, bh);
              tma_load_3d(s.v, &map_v, &s.kv_full, 0, r * CH, bh);
              if constexpr (TAIL > 0) {
                tma_load_3d(s.kt, &tails.k, &s.kv_full, HD, r * CH, bh);
                tma_load_3d(s.vt, &tails.v, &s.kv_full, HD, r * CH, bh);
              }
            }
          }
    }
  } else {  // ------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CREGS));
    const int wg = warp / 4, w = warp % 4, g = lane / 4, tg = lane % 4;
    const int ctid = threadIdx.x;  // 0 .. 255
    const float qscale = __bfloat162float(__float2bfloat16_rn(scale));
    uint32_t it = 0, kv_i = 0;
    for (int bh = blockIdx.x; bh < n_bh; bh += gridDim.x) {
      const uint8_t* vrow = valid + (size_t)(bh / heads) * t;
      const size_t base = (size_t)bh * t * D;
      for (int r = 0; r < n_rounds; ++r, ++kv_i) {
        // this thread's keys: k0 + 64h + 16w + g + 8e of the warpgroup's CH / 2
        const int k0 = r * CH + (CH / 2) * wg;
        uint32_t kstate = 0;  // 2 bits a key (h, e): 0 valid, 1 masked (-1e9), 2 beyond t (-inf)
#pragma unroll
        for (int h = 0; h < HALVES; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 64 * h + 16 * w + g + 8 * e;
            kstate |= (key >= t ? 2u : (__ldg(vrow + key) ? 0u : 1u)) << (2 * (2 * h + e));
          }
        float dka[HALVES][D / 8][4], dva[HALVES][D / 8][4];
#pragma unroll
        for (int h = 0; h < HALVES; ++h)
#pragma unroll
          for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dka[h][dt][e] = dva[h][dt][e] = 0.f;
        mbar_wait(&s.kv_full, kv_i & 1);

        for (int i = 0; i < n_blk; ++i, ++it) {
          const int st = it % BWD_STAGES;
          BwdStage& sb = s.st[st];
          mbar_wait(&s.full[st], (it / BWD_STAGES) & 1);
          // pre-pass: q *= scale and lse *= log2(e) in place; D of the
          // block's 64 rows (4 threads a row, 16 elements each, and at hd 80
          // two of them 8 more from the tails: the swizzle permutes chunks
          // within a row only, the same way in O and dO)
          scale_rows(sb.q, BWD_BQ, qscale, ctid, 128 * WGS);
          if constexpr (TAIL > 0) scale_rows<TROW>(s.qt[st], BWD_BQ, qscale, ctid, 128 * WGS);
          if (ctid < BWD_BQ) sb.lse[ctid] *= LOG2E;
          {
            const int row = ctid / 4, part = ctid % 4;
            float d = 0.f;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int off = row * (ROW / 16) + part * 2 + c;
              d = dot_chunk(reinterpret_cast<const uint4*>(sb.dout)[off],
                            reinterpret_cast<const uint4*>(sb.o)[off], d);
            }
            if constexpr (TAIL > 0) {
              if (part < TROW / 16) {
                const int off = row * (TROW / 16) + part;
                d = dot_chunk(reinterpret_cast<const uint4*>(s.dt[st])[off],
                              reinterpret_cast<const uint4*>(s.ot[st])[off], d);
              }
            }
            d = quad_sum(d);
            if (part == 0) sb.dsum[row] = d;
          }
          fence_proxy_async();  // the scaled q, before wgmma reads it (lse and D:
                                // generic reads after the barrier)
          bar_sync(1, 128 * WGS);

          const uint32_t qa = smem_u32(sb.q), da = smem_u32(sb.dout);
          uint32_t qta = 0, dta = 0;  // the tails' tiles (hd 80)
          if constexpr (TAIL > 0) {
            qta = smem_u32(s.qt[st]);
            dta = smem_u32(s.dt[st]);
          }
          const uint32_t stage_ds = smem_u32(s.ds[i & 1]);
          // per key half h and SUB-query part u of the block (N = SUB keeps
          // S^T and dP^T small beside dK and dV)
#pragma unroll
          for (int hu = 0; hu < HALVES * NU; ++hu) {
            const int h = hu / NU, u = hu % NU;
            const uint32_t krow = (uint32_t)((CH / 2) * wg + 64 * h) * ROW;
            const uint32_t qrow = (uint32_t)(SUB * u) * ROW;
            // S^T = K_h . qs_u^T and dP^T = V_h . dO_u^T (64 keys x SUB
            // queries each), one group
            float pt[SUB / 8][4], dpt[SUB / 8][4];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)
              wgmma_ss_n32(pt, desc_sw128(smem_u32(s.k) + krow, 16) + 2 * kk,
                                desc_sw128(qa + qrow, 16) + 2 * kk, kk);
            if constexpr (TAIL > 0)
              wgmma_ss_n32(pt, desc_sw32(smem_u32(s.kt) + krow / ROW * TROW),
                                desc_sw32(qta + qrow / ROW * TROW), 1);
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)
              wgmma_ss_n32(dpt, desc_sw128(smem_u32(s.v) + krow, 16) + 2 * kk,
                                desc_sw128(da + qrow, 16) + 2 * kk, kk);
            if constexpr (TAIL > 0)
              wgmma_ss_n32(dpt, desc_sw32(smem_u32(s.vt) + krow / ROW * TROW),
                                desc_sw32(dta + qrow / ROW * TROW), 1);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(pt);
            fence_regs(dpt);
            // P^T = exp(S^T - lse) in log2 units: s log2e - lse log2e;
            // dS^T = bf16((dP^T - D) * P^T), both packed as A fragments
            // (the C layout of query groups 2kk and 2kk + 1 is the A layout
            // of step kk)
            uint32_t pa[SUB / 16][4], dsf[SUB / 16][4];
#pragma unroll
            for (int j = 0; j < SUB / 8; ++j) {
              const int col = SUB * u + 8 * j + 2 * tg;
              const float2 ls = *reinterpret_cast<const float2*>(&sb.lse[col]);
              const float2 dd = *reinterpret_cast<const float2*>(&sb.dsum[col]);
              const float l2[2] = {ls.x, ls.y};
#pragma unroll
              for (int rr = 0; rr < 2; ++rr) {
                const uint32_t ks = (kstate >> (2 * (2 * h + rr))) & 3u;
                float x[2];
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  x[e] = ks == 2 ? -INFINITY
                                 : (ks == 0 ? fmaf(pt[j][2 * rr + e], LOG2E, -l2[e]) : NEG2 - l2[e]);
                const float2 p = VARIANT == BWD_BF16EXP ? exp_bf16x2(x[0] * LN2, x[1] * LN2)
                                                        : make_float2(ex2(x[0]), ex2(x[1]));
                const int kk = j / 2, e4 = (j & 1) * 2 + rr;
                pa[kk][e4] = pack_bf16x2(p.x, p.y);
                dsf[kk][e4] = pack_bf16x2((dpt[j][2 * rr] - dd.x) * p.x,
                                          (dpt[j][2 * rr + 1] - dd.y) * p.y);
              }
            }
            // dS^T to the staging in the 128-byte swizzle: lane l gives row
            // l % 8 of matrix l / 8 (rows + 8 for odd matrices, the next 8
            // queries for matrices 2 and 3)
            {
              const int mat = lane / 8, rw = lane % 8;
              const uint32_t row = (CH / 2) * wg + 64 * h + 16 * w + (mat & 1) * 8 + rw;
#pragma unroll
              for (int kk = 0; kk < SUB / 16; ++kk) {
                const uint32_t chunk = (SUB / 8) * u + 2 * kk + (mat >> 1);
                stmatrix_x4(stage_ds + row * ROW + ((chunk ^ rw) << 4), dsf[kk][0], dsf[kk][1],
                            dsf[kk][2], dsf[kk][3]);
              }
            }
            // dV_h += bf16(P^T) . dO_u; dK_h += dS^T . qs_u (16 queries =
            // 2048 bytes a step; at hd 80 the tails' 512 into the last two
            // 8-column groups)
            float (&dvh)[HD / 8][4] = *reinterpret_cast<float (*)[HD / 8][4]>(&dva[h][0]);
            float (&dkh)[HD / 8][4] = *reinterpret_cast<float (*)[HD / 8][4]>(&dka[h][0]);
            fence_regs(dva[h]);
            fence_regs(dka[h]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < SUB / 16; ++kk)
              wgmma_rs_n64_tb(dvh, pa[kk], desc_sw128(da + qrow, 1024) + 128 * kk);
#pragma unroll
            for (int kk = 0; kk < SUB / 16; ++kk)
              wgmma_rs_n64_tb(dkh, dsf[kk], desc_sw128(qa + qrow, 1024) + 128 * kk);
            if constexpr (TAIL > 0) {
              float (&dvt)[TAIL / 8][4] = *reinterpret_cast<float (*)[TAIL / 8][4]>(&dva[h][HD / 8]);
              float (&dkt)[TAIL / 8][4] = *reinterpret_cast<float (*)[TAIL / 8][4]>(&dka[h][HD / 8]);
#pragma unroll
              for (int kk = 0; kk < SUB / 16; ++kk) {
                wgmma_rs_n16_tb(dvt, pa[kk], desc_sw32(dta + SUB * u * TROW) + 32 * kk);
                wgmma_rs_n16_tb(dkt, dsf[kk], desc_sw32(qta + SUB * u * TROW) + 32 * kk);
              }
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dva[h]);
            fence_regs(dka[h]);
            fence_regs(pa);
            fence_regs(dsf);
          }
          fence_proxy_async();  // the staged dS^T, before wgmma reads it
          bar_sync(1, 128 * WGS);

          if (wg == (i & 1)) {  // this warpgroup's block: dQ = dS . K over the round's keys
            float dqa[D / 8][4];
            float (&dqh)[HD / 8][4] = *reinterpret_cast<float (*)[HD / 8][4]>(&dqa[0]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < CH / 16; ++kk)  // 16 keys = 2048 bytes in both
              wgmma_ss_n64_tt(dqh, desc_sw128(stage_ds, 1024) + 128 * kk,
                              desc_sw128(smem_u32(s.k), 1024) + 128 * kk, kk);
            if constexpr (TAIL > 0) {
              float (&dqt)[TAIL / 8][4] = *reinterpret_cast<float (*)[TAIL / 8][4]>(&dqa[HD / 8]);
#pragma unroll
              for (int kk = 0; kk < CH / 16; ++kk)  // K's tail: 16 keys = 512 bytes
                wgmma_ss_n16_tt(dqt, desc_sw128(stage_ds, 1024) + 128 * kk,
                                desc_sw32(smem_u32(s.kt)) + 32 * kk, kk);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dqa);
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const size_t row = (size_t)i * BWD_BQ + 16 * w + g + 8 * rr;
#pragma unroll
              for (int dt = 0; dt < D / 8; ++dt) {
                const size_t at = base + row * D + dt * 8 + 2 * tg;
                float2 val = make_float2(dqa[dt][2 * rr], dqa[dt][2 * rr + 1]);
                if (r > 0) {
                  const float2 prev = *reinterpret_cast<const float2*>(dq_acc + at);
                  val.x += prev.x;
                  val.y += prev.y;
                }
                if (r == n_rounds - 1)
                  *reinterpret_cast<__nv_bfloat162*>(dq + at) =
                      __floats2bfloat162_rn(val.x * scale, val.y * scale);
                else
                  *reinterpret_cast<float2*>(dq_acc + at) = val;
              }
            }
          }
          if (lane == 0) mbar_arrive(&s.empty[st]);
        }

        if (lane == 0) mbar_arrive(&s.kv_empty);
#pragma unroll
        for (int h = 0; h < HALVES; ++h)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int key = k0 + 64 * h + 16 * w + g + 8 * rr;
            if (key >= t) continue;
#pragma unroll
            for (int dt = 0; dt < D / 8; ++dt) {
              const size_t at = base + (size_t)key * D + dt * 8 + 2 * tg;
              *reinterpret_cast<__nv_bfloat162*>(dk + at) =
                  __floats2bfloat162_rn(dka[h][dt][2 * rr], dka[h][dt][2 * rr + 1]);
              *reinterpret_cast<__nv_bfloat162*>(dv + at) =
                  __floats2bfloat162_rn(dva[h][dt][2 * rr], dva[h][dt][2 * rr + 1]);
            }
          }
      }
    }
  }
}

template <int VARIANT, bool ONE, int D>
int launch_bwd_one(const void* q, const void* k, const void* v, const void* o, const float* lse,
                   const void* dout, const uint8_t* valid, void* dq, void* dk, void* dv,
                   float* dq_acc, int bh, int heads, int t, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo, mdo;
  int err = head_map<D>(&mq, q, bh, t, BWD_BQ);
  if (err == 0) err = head_map<D>(&mk, k, bh, t, bwd_chunk<D>());
  if (err == 0) err = head_map<D>(&mv, v, bh, t, bwd_chunk<D>());
  if (err == 0) err = head_map<D>(&mo, o, bh, t, BWD_BQ);
  if (err == 0) err = head_map<D>(&mdo, dout, bh, t, BWD_BQ);
  Tails<tail_of<D>()> tails;
  if constexpr (tail_of<D>() > 0) {
    if (err == 0) err = tail_map<D>(&tails.q, q, bh, t, BWD_BQ);
    if (err == 0) err = tail_map<D>(&tails.k, k, bh, t, bwd_chunk<D>());
    if (err == 0) err = tail_map<D>(&tails.v, v, bh, t, bwd_chunk<D>());
    if (err == 0) err = tail_map<D>(&tails.o, o, bh, t, BWD_BQ);
    if (err == 0) err = tail_map<D>(&tails.dout, dout, bh, t, BWD_BQ);
  }
  if (err != 0) return err;
  static LaunchSetup setup;
  int sms = 0;
  err = setup.sms(attention_bwd_kernel<VARIANT, ONE, D>, bwd_smem<D>(), &sms);
  if (err != 0) return err;
  attention_bwd_kernel<VARIANT, ONE, D><<<bh < sms ? bh : sms, THREADS, bwd_smem<D>(), stream>>>(
      mq, mk, mv, mo, mdo, lse, valid, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dq_acc, bh, heads, t, scale, tails);
  return (int)cudaGetLastError();
}

// q, k, v, o, dout, dq, dk, dv: (bh, t, D) bf16, contiguous each, 16-byte
// aligned; lse: (bh, t) f32; dq_acc: an f32 (bh, t, D) scratch, unused
// where t <= bwd_chunk<D>(). Returns a cudaError_t.
template <int VARIANT, int D = HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const float* lse,
               const void* dout, const uint8_t* valid, void* dq, void* dk, void* dv,
               float* dq_acc, int bh, int heads, int t, float scale, cudaStream_t stream) {
  return t <= bwd_chunk<D>()
             ? launch_bwd_one<VARIANT, true, D>(q, k, v, o, lse, dout, valid, dq, dk, dv, dq_acc,
                                                bh, heads, t, scale, stream)
             : launch_bwd_one<VARIANT, false, D>(q, k, v, o, lse, dout, valid, dq, dk, dv, dq_acc,
                                                 bh, heads, t, scale, stream);
}

}  // namespace attn_bwd
