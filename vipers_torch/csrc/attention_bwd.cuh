// The training kernels' one-pass attention backward for Hopper (sm_90a),
// bf16 in and out, f32 accumulation, instantiated by attention_train.cu
// (replacing vipers/ops/attention_train.py _bwd (:225) and _bwd_packed
// (:294) and the softmax-precision tool's bwd (bench_softmax_prec.py
// :137)); t % 64 == 0, t <= 1024, a key mask always given.
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
// barrier before wgmma reads them). Per key half and 32 queries of the
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

constexpr int HD = 64;       // head dim (the wrappers reject any other)
constexpr int ROW = HD * 2;  // bytes in a row: one 128-byte swizzle row
constexpr int CHUNK = 256;   // keys resident at once
constexpr float NEG = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG2 = NEG * LOG2E;  // the -1e9 mask in log2 units

constexpr int WGS = 2;                    // consumer warpgroups
constexpr int CONSUMERS = 4 * WGS;        // consumer warps
constexpr int THREADS = 128 * (WGS + 1);  // + the producer warpgroup
// Registers a thread: R0 at launch (the launch bounds' share, in 8s),
// CREGS for a consumer, 24 for the producer. setmaxnreg.inc draws only on
// what the producer warpgroup gave back, and waits for it forever.
constexpr int R0 = (65536 / THREADS) & ~7;
constexpr int CREGS = 240;
static_assert(WGS * 128 * (CREGS - R0) <= 128 * (R0 - 24), "consumer registers");

enum BwdVariant { BWD_F32 = 0, BWD_BF16EXP = 1 };

// exp(bf16(a)), exp(bf16(b)) on one bf16 pair, back in f32
__device__ __forceinline__ float2 exp_bf16x2(float a, float b) {
  return __bfloat1622float2(h2exp(__floats2bfloat162_rn(a, b)));
}

// `rows` rows of a swizzled bf16 tile times the bf16 scale, rounded to bf16
// (the TPU's bf16(q * scale)), by threads tid of n. The swizzle permutes
// 16-byte chunks within a row, which an elementwise pass does not see.
__device__ __forceinline__ void scale_rows(bf16* tile, int rows, float scale, int tid, int n) {
  uint4* p = reinterpret_cast<uint4*>(tile);
  for (int i = tid; i < rows * (ROW / 16); i += n) {
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

// A 3-D map over one (bh, t, 64) operand in boxes of `rows` rows; rows
// beyond t read as zeros.
inline int head_map(CUtensorMap* map, const void* base, int bh, int t, int rows) {
  return encode_map(map, base, HD, t, bh, HD, (long long)t * HD, rows);
}

constexpr int BWD_BQ = 64;     // queries of a block
constexpr int SUB = 32;        // queries of one S^T / dP^T product
constexpr int BWD_STAGES = 3;  // query blocks in the ring

struct alignas(1024) BwdStage {
  bf16 q[BWD_BQ * HD];  // q, then q * scale after the block's pre-pass
  bf16 dout[BWD_BQ * HD];
  bf16 o[BWD_BQ * HD];
  float lse[BWD_BQ];   // in log2 units after the pre-pass
  float dsum[BWD_BQ];  // D of the block's rows
};

struct BwdSmem {
  bf16 k[CHUNK * HD];  // the round's keys, [key][dim]
  bf16 v[CHUNK * HD];
  bf16 ds[2][CHUNK * BWD_BQ];  // dS^T staging, [key][query]
  BwdStage st[BWD_STAGES];
  uint64_t full[BWD_STAGES], empty[BWD_STAGES], kv_full, kv_empty;
};
constexpr int BWD_SMEM = (int)sizeof(BwdSmem) + 1024;
constexpr int BWD_STAGE_TX = 3 * BWD_BQ * ROW + BWD_BQ * 4;  // Q, dO, O tiles and the lse row

// ONE: t <= CHUNK, one round of keys and no f32 scratch, compiled on its own.
template <int VARIANT, bool ONE>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_o,
                     const __grid_constant__ CUtensorMap map_do,
                     const float* __restrict__ lse, const uint8_t* __restrict__ valid,
                     bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     float* __restrict__ dq_acc, int n_bh, int heads, int t, float scale) {
  extern __shared__ __align__(128) char smem_dyn[];
  BwdSmem& s = *reinterpret_cast<BwdSmem*>((reinterpret_cast<uintptr_t>(smem_dyn) + 1023) &
                                           ~uintptr_t(1023));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_blk = t / BWD_BQ, n_rounds = ONE ? 1 : (t + CHUNK - 1) / CHUNK;

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
            mbar_expect_tx(&s.full[st], BWD_STAGE_TX);
            tma_load_3d(sb.q, &map_q, &s.full[st], 0, i * BWD_BQ, bh);
            tma_load_3d(sb.dout, &map_do, &s.full[st], 0, i * BWD_BQ, bh);
            tma_load_3d(sb.o, &map_o, &s.full[st], 0, i * BWD_BQ, bh);
            bulk_load(sb.lse, lse + (size_t)bh * t + i * BWD_BQ, BWD_BQ * 4, &s.full[st]);
            if (i == 0) {  // the round's K and V, once its first block is on its way
              mbar_wait(&s.kv_empty, (kv_i & 1) ^ 1);
              mbar_expect_tx(&s.kv_full, 2 * CHUNK * ROW);
              tma_load_3d(s.k, &map_k, &s.kv_full, 0, r * CHUNK, bh);
              tma_load_3d(s.v, &map_v, &s.kv_full, 0, r * CHUNK, bh);
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
      const size_t base = (size_t)bh * t * HD;
      for (int r = 0; r < n_rounds; ++r, ++kv_i) {
        // this thread's keys: k0 + 64h + 16w + g + 8e of the warpgroup's 128
        const int k0 = r * CHUNK + 128 * wg;
        uint32_t kstate = 0;  // 2 bits a key (h, e): 0 valid, 1 masked (-1e9), 2 beyond t (-inf)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 64 * h + 16 * w + g + 8 * e;
            kstate |= (key >= t ? 2u : (__ldg(vrow + key) ? 0u : 1u)) << (2 * (2 * h + e));
          }
        float dka[2][HD / 8][4], dva[2][HD / 8][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dka[h][dt][e] = dva[h][dt][e] = 0.f;
        mbar_wait(&s.kv_full, kv_i & 1);

        for (int i = 0; i < n_blk; ++i, ++it) {
          const int st = it % BWD_STAGES;
          BwdStage& sb = s.st[st];
          mbar_wait(&s.full[st], (it / BWD_STAGES) & 1);
          // pre-pass: q *= scale and lse *= log2(e) in place; D of the
          // block's 64 rows (4 threads a row, 16 elements each: the swizzle
          // permutes chunks within a row only, the same way in O and dO)
          scale_rows(sb.q, BWD_BQ, qscale, ctid, 128 * WGS);
          if (ctid < BWD_BQ) sb.lse[ctid] *= LOG2E;
          {
            const int row = ctid / 4, part = ctid % 4;
            float d = 0.f;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int off = row * (ROW / 16) + part * 2 + c;
              uint4 a = reinterpret_cast<const uint4*>(sb.dout)[off];
              uint4 b = reinterpret_cast<const uint4*>(sb.o)[off];
              const __nv_bfloat162* ea = reinterpret_cast<const __nv_bfloat162*>(&a);
              const __nv_bfloat162* eb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 fa = __bfloat1622float2(ea[e]), fb = __bfloat1622float2(eb[e]);
                d = fmaf(fa.x, fb.x, fmaf(fa.y, fb.y, d));
              }
            }
            d = quad_sum(d);
            if (part == 0) sb.dsum[row] = d;
          }
          fence_proxy_async();  // the scaled q, before wgmma reads it (lse and D:
                                // generic reads after the barrier)
          bar_sync(1, 128 * WGS);

          const uint32_t qa = smem_u32(sb.q), da = smem_u32(sb.dout);
          const uint32_t stage_ds = smem_u32(s.ds[i & 1]);
          // per key half h and 32-query half u of the block (N = 32 keeps
          // S^T and dP^T at 16 registers each beside dK and dV's 128)
#pragma unroll
          for (int hu = 0; hu < 4; ++hu) {
            const int h = hu / 2, u = hu % 2;
            const uint32_t krow = (uint32_t)(128 * wg + 64 * h) * ROW;
            const uint32_t qrow = (uint32_t)(SUB * u) * ROW;
            // S^T = K_h . qs_u^T and dP^T = V_h . dO_u^T (64 keys x 32
            // queries each), one group
            float pt[SUB / 8][4], dpt[SUB / 8][4];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)
              wgmma_ss_n32(pt, desc_sw128(smem_u32(s.k) + krow, 16) + 2 * kk,
                           desc_sw128(qa + qrow, 16) + 2 * kk, kk);
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)
              wgmma_ss_n32(dpt, desc_sw128(smem_u32(s.v) + krow, 16) + 2 * kk,
                           desc_sw128(da + qrow, 16) + 2 * kk, kk);
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
              const uint32_t row = 128 * wg + 64 * h + 16 * w + (mat & 1) * 8 + rw;
#pragma unroll
              for (int kk = 0; kk < SUB / 16; ++kk) {
                const uint32_t chunk = (SUB / 8) * u + 2 * kk + (mat >> 1);
                stmatrix_x4(stage_ds + row * ROW + ((chunk ^ rw) << 4), dsf[kk][0], dsf[kk][1],
                            dsf[kk][2], dsf[kk][3]);
              }
            }
            // dV_h += bf16(P^T) . dO_u; dK_h += dS^T . qs_u (16 queries =
            // 2048 bytes a step)
            fence_regs(dva[h]);
            fence_regs(dka[h]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < SUB / 16; ++kk)
              wgmma_rs_n64_tb(dva[h], pa[kk], desc_sw128(da + qrow, 1024) + 128 * kk);
#pragma unroll
            for (int kk = 0; kk < SUB / 16; ++kk)
              wgmma_rs_n64_tb(dka[h], dsf[kk], desc_sw128(qa + qrow, 1024) + 128 * kk);
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
            float dqa[HD / 8][4];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < CHUNK / 16; ++kk)  // 16 keys = 2048 bytes in both
              wgmma_ss_n64_tt(dqa, desc_sw128(stage_ds, 1024) + 128 * kk,
                              desc_sw128(smem_u32(s.k), 1024) + 128 * kk, kk);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dqa);
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const size_t row = (size_t)i * BWD_BQ + 16 * w + g + 8 * rr;
#pragma unroll
              for (int dt = 0; dt < HD / 8; ++dt) {
                const size_t at = base + row * HD + dt * 8 + 2 * tg;
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
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int key = k0 + 64 * h + 16 * w + g + 8 * rr;
            if (key >= t) continue;
#pragma unroll
            for (int dt = 0; dt < HD / 8; ++dt) {
              const size_t at = base + (size_t)key * HD + dt * 8 + 2 * tg;
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

template <int VARIANT, bool ONE>
int launch_bwd_one(const void* q, const void* k, const void* v, const void* o, const float* lse,
                   const void* dout, const uint8_t* valid, void* dq, void* dk, void* dv,
                   float* dq_acc, int bh, int heads, int t, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo, mdo;
  int err = head_map(&mq, q, bh, t, BWD_BQ);
  if (err == 0) err = head_map(&mk, k, bh, t, CHUNK);
  if (err == 0) err = head_map(&mv, v, bh, t, CHUNK);
  if (err == 0) err = head_map(&mo, o, bh, t, BWD_BQ);
  if (err == 0) err = head_map(&mdo, dout, bh, t, BWD_BQ);
  if (err != 0) return err;
  static LaunchSetup setup;
  int sms = 0;
  err = setup.sms(attention_bwd_kernel<VARIANT, ONE>, BWD_SMEM, &sms);
  if (err != 0) return err;
  attention_bwd_kernel<VARIANT, ONE><<<bh < sms ? bh : sms, THREADS, BWD_SMEM, stream>>>(
      mq, mk, mv, mo, mdo, lse, valid, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dq_acc, bh, heads, t, scale);
  return (int)cudaGetLastError();
}

// q, k, v, o, dout, dq, dk, dv: (bh, t, 64) bf16, contiguous each, 16-byte
// aligned; lse: (bh, t) f32; dq_acc: an f32 (bh, t, 64) scratch, unused
// where t <= 256. Returns a cudaError_t.
template <int VARIANT>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const float* lse,
               const void* dout, const uint8_t* valid, void* dq, void* dk, void* dv,
               float* dq_acc, int bh, int heads, int t, float scale, cudaStream_t stream) {
  return t <= CHUNK
             ? launch_bwd_one<VARIANT, true>(q, k, v, o, lse, dout, valid, dq, dk, dv, dq_acc,
                                             bh, heads, t, scale, stream)
             : launch_bwd_one<VARIANT, false>(q, k, v, o, lse, dout, valid, dq, dk, dv, dq_acc,
                                              bh, heads, t, scale, stream);
}

}  // namespace attn_bwd
