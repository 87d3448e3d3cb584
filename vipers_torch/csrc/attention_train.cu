// Short-T training attention for Hopper (sm_90a): exact-softmax forward and
// one-pass backward, bf16 in and out, f32 accumulation.
//
// Replaces the TPU kernels of vipers/ops/attention_train.py: _fwd (:207) and
// _fwd_packed (:276) with the forward here (kernel bodies :52-75, :117-141),
// _bwd (:225) and _bwd_packed (:294) with the backward (bodies :78-114,
// :144-182). Both take q, k, v (and dq, dk, dv) as three base pointers over
// a (B*H, T, 64) layout, so the packed entry passes the three slabs of one
// contiguous (3, B, H, T, 64) buffer (and writes one packed dqkv) and the
// unpacked entry passes three tensors: one kernel pair serves both.
//
// Arithmetic (the Pallas kernels'):
//   qs = bf16(q * scale); s = qs . k^T in f32; keys whose valid byte is 0
//   get -1e9;
//   forward:  m = max over ALL keys, p = exp(s - m), l = sum p (f32),
//             o = bf16((bf16(p) . v) / l), lse = m + log l;
//   backward: p = exp(s - lse), D = rowsum(f32(dO) * f32(O)),
//             dV = bf16(p)^T . dO, dP = dO . V^T, dS = bf16((dP - D) * p),
//             dQ = (dS . K) * scale, dK = dS^T . qs; stored in bf16.
// Pad-query rows are computed like any other row; their cotangents are zero
// by contract (attention_train.py:26-28), so they add nothing to dK, dV.
// Keys beyond t (a chunk that TMA zero-fills past the end) get -inf, so an
// image whose keys are all invalid averages v over exactly t keys, as in
// JAX; its lse rounds to -1e9 in f32 and the backward's p = exp(s - lse) is
// then 1 for every key, as in JAX.
//
// Bound on the card: at the ViT-S/16 train shape (B*H = 768, T = 256,
// bf16) the forward does 12.9 GFLOP on ~101 MB of I/O and the backward
// 32.2 GFLOP on ~202 MB, so both are bound by bytes (0.030 and 0.060 ms at
// 3.35 TB/s). The design reads each operand once from device memory by TMA
// and keeps every (T, T) intermediate on the SM:
//
// Forward: a persistent grid of at most one CTA an SM walks over (b*h,
// 128-query tile) pairs, head-major. Two consumer warpgroups own 64 query
// rows each; one producer thread loads by TMA (128-byte swizzle, full/empty
// mbarriers): Q into one of two buffers, K and V in chunks of CHUNK = 256
// keys into a ring of two stages, so the next tile's loads run under this
// tile's math. Each warpgroup multiplies its Q rows by the bf16 scale in
// shared memory (order-free, so the swizzle does not matter), then S =
// qs . K^T by wgmma, both operands K-major. Where T <= 256 (the whole train
// path) the 64 x 256 f32 scores of a warpgroup stay in registers (128 a
// thread, as two m64n128 accumulators: one m64n256 block left ptxas no room
// for P and spilled it), so the exact softmax takes one pass: mask, row
// max from the registers and quad shuffles, p, l, then O = bf16(p) . V by
// the register-A wgmma m64n64k16 with V read in its [key][dim] layout
// through the descriptor's transpose bit: nothing is transposed in shared
// memory. The second half's P fragments are packed while the first half's
// P V runs. Where 256 < T <= 1024 it makes two passes over the chunks on
// the same pieces (pass 1: row max; pass 2: S again, p, P V), compiled as
// their own instance. Exponents are in log2 units. The two query tiles of a
// head run on neighbouring CTAs at the same time, so each CTA loads K and V
// itself and the second read comes from L2. At 240 registers a consumer
// thread ptxas still serializes the wgmma pipeline of the F32 and BF16EXP
// one-pass instances (C7512, register resources): the chunk's 128 score
// registers, O and P leave it no room to overlap the products.
//
// Backward: one CTA per (b, h) at a time, persistent over the heads, and a
// deterministic dQ with no atomics. Two consumer warpgroups own 128 keys of
// the head each, as two m64 halves, with dK and dV accumulating in
// registers; the head's 256 keys are resident as K and V (64 KB). Q, dO, O
// and the lse row stream through a TMA ring of three 64-query stages. A
// pre-pass over each block multiplies Q by the scale in place and sums
// D = rowsum(dO * O) (fence.proxy.async and a named barrier before wgmma
// reads them). Per key half and 32 queries of the block (N = 32 keeps S^T
// and dP^T at 16 registers each beside dK and dV's 128: at N = 64 ptxas
// spilled and serialized the wgmma pipeline), every product is one wgmma
// with its operands K-major or through the transpose bit:
//   S^T = K . qs^T and dP^T = V . dO^T (both K-major), one group;
//   P^T = exp(S^T - lse); dS^T = bf16((dP^T - D) * P^T);
//   dV += bf16(P^T) . dO and dK += dS^T . qs (register A; dO and qs
//   MN-major), one group.
// dS^T goes to a staging buffer by stmatrix in the 128-byte swizzle,
// [key][query]. After a named barrier one warpgroup, alternating by block,
// computes dQ = dS . K over all 256 keys: A is dS read MN-major through the
// transpose bit on A, B is K, MN-major; both then hold one swizzle row along
// M or N, the layout of the forward's V. The staging is double-buffered, so
// the next block's S^T overlaps this block's dQ. Where T > 256 the keys go
// in rounds of 256 and dQ is summed in an f32 scratch of the head, written
// once per (round, query block) by the warpgroup that owns the block.
//
// Softmax-precision variants (the TPU's tools/bench_softmax_prec.py fwd
// :124 and bwd :137, bodies fwd_kernel :38 and bwd_kernel :75), a template
// parameter of both kernels that touches only the softmax step; the model
// path runs F32:
//   F32:     the arithmetic above;
//   BF16EXP: p = exp(bf16(s - m)) evaluated on bf16 pairs (h2exp), l summed
//            in f32 from the bf16 p; the backward's p = exp(bf16(s - lse))
//            stays bf16 into both dV and dS = bf16((dP - D) * p);
//   NORMP:   forward only, bf16(p / l) before P.V and no division after;
//            l is the exact sum in one pass, and carried online next to
//            the row max by pass 1 of two.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int HD = 64;       // head dim (the wrapper rejects any other)
constexpr int ROW = HD * 2;  // bytes in a row: one 128-byte swizzle row
constexpr int MAX_T = 1024;
constexpr int CHUNK = 256;   // keys resident at once
constexpr int HALF = CHUNK / 2;  // keys of one m64n128 score accumulator
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

enum FwdVariant { FWD_F32 = 0, FWD_BF16EXP = 1, FWD_NORMP = 2 };
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

// ------------------------------------------------------------- forward
constexpr int FWD_BQ = 64 * WGS;  // query rows of a tile
constexpr int FWD_STAGES = 2;     // K/V chunks in the ring

struct FwdSmem {
  bf16 q[2][FWD_BQ * HD];  // every tile 1024-byte aligned: the swizzle atom
  bf16 k[FWD_STAGES][CHUNK * HD];
  bf16 v[FWD_STAGES][CHUNK * HD];
  uint64_t q_full[2], q_empty[2], kv_full[FWD_STAGES], kv_empty[FWD_STAGES];
};
constexpr int FWD_SMEM = (int)sizeof(FwdSmem) + 1024;  // + the alignment slack

// A chunk's scores as two m64n128 accumulators: s[h][j][e] is key 128h +
// 8j + 2tg + e%2 of the chunk (the wgmma C layout; tg = lane % 4), rows g
// and g + 8 of the warp's 16 for e < 2 and e >= 2. Two accumulators, not
// one of m64n256, so that P of the first half can take registers while the
// second half still holds scores.
typedef float Scores[2][HALF / 8][4];

// Scores in log2 units with the mask of keys k0 .. k0 + CHUNK - 1: -1e9
// (log2 units) where the valid byte is 0, -inf beyond t. Each warp reads
// the chunk's valid bytes once, 8 a lane, and ballots them. Every chunk
// takes the same selects, masked keys or not: a branch that left an
// all-valid chunk as it is made ptxas keep the scores of both ways in local
// memory. t is a multiple of 64.
__device__ __forceinline__ void mask_chunk(Scores& s, const uint8_t* valid, int k0, int t,
                                           int lane) {
  const int tg = lane & 3;
  uint2 bytes = make_uint2(0u, 0u);
  if (k0 + lane * 8 < t) bytes = __ldg(reinterpret_cast<const uint2*>(valid + k0 + lane * 8));
  uint32_t w[8];  // bit J of word i: key 8J + i of the chunk
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t word = i < 4 ? bytes.x : bytes.y;
    w[i] = __ballot_sync(0xffffffffu, ((word >> (8 * (i & 3))) & 0xffu) != 0u);
  }
  uint32_t sel[2];  // this thread's columns 2tg + e
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    sel[e] = w[e];
#pragma unroll
    for (int i = 1; i < 4; ++i) sel[e] = tg == i ? w[2 * i + e] : sel[e];
  }
  const int live = (t - k0) / 8;  // key groups J below t
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jg = h * (HALF / 8) + j;
        const bool ok = (sel[e & 1] >> jg) & 1u;
        s[h][j][e] = jg >= live ? -INFINITY : (ok ? s[h][j][e] * LOG2E : NEG2);
      }
}

// Running row max m of this thread's two rows over a chunk of scores (log2
// units). With `online`, l (this thread's partial sum) follows it:
// l = l 2^(m_old - m) + sum 2^(s - m).
__device__ __forceinline__ void max_chunk(const Scores& s, float (&m)[2], float (&l)[2],
                                          bool online) {
  float mx[2] = {s[0][0][0], s[0][0][2]};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[h][j][0], s[h][j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[h][j][2], s[h][j][3]));
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] = fmaxf(m[r], mx[r]);
  }
  if (online) {
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e / 2] += ex2(s[h][j][e] - mx[e / 2]);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * ex2(m[r] - mx[r]) + sum[r];
  }
  m[0] = mx[0];
  m[1] = mx[1];
}

// p = 2^(s - m) of one half in place (BF16EXP: e^bf16((s - m) ln 2) on
// bf16 pairs); with `sum`, l += p.
template <int VARIANT>
__device__ __forceinline__ void exp_half(float (&s)[HALF / 8][4], const float (&m)[2],
                                         float (&l)[2], bool sum) {
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float a = s[j][2 * r] - m[r], b = s[j][2 * r + 1] - m[r];
      const float2 p =
          VARIANT == FWD_BF16EXP ? exp_bf16x2(a * LN2, b * LN2) : make_float2(ex2(a), ex2(b));
      s[j][2 * r] = p.x;
      s[j][2 * r + 1] = p.y;
      if (sum) l[r] += p.x + p.y;
    }
}

// bf16(p * inv) of one half as A fragments: the C layout of key groups 2kk
// and 2kk + 1 is the A layout of the 16-key step kk.
__device__ __forceinline__ void pack_half(const float (&s)[HALF / 8][4], const float (&inv)[2],
                                          uint32_t (&p)[HALF / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < HALF / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 2 * kk + e / 2, r = e & 1;
      p[kk][e] = pack_bf16x2(s[j][2 * r] * inv[r], s[j][2 * r + 1] * inv[r]);
    }
}

// S = qs . K^T of one chunk (both K-major; 16 dims = 32 bytes along the
// swizzled row), as two m64n128 products in one group, waited for.
__device__ __forceinline__ void chunk_scores(Scores& sc, uint64_t dq, uint32_t kb) {
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint64_t dk = desc_sw128(kb + h * HALF * ROW, 16);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss_n128(sc[h], dq + 2 * kk, dk + 2 * kk, kk);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc[0]);
  fence_regs(sc[1]);
}

// Start O += P V over one half on wgmma: P from registers, V MN-major
// through the transpose bit (16 keys = 2048 bytes a step). The caller
// fences before and commits after.
__device__ __forceinline__ void start_pv(float (&o)[HD / 8][4], const uint32_t (&p)[HALF / 16][4],
                                         uint32_t vb) {
  const uint64_t dv = desc_sw128(vb, 1024);
#pragma unroll
  for (int kk = 0; kk < HALF / 16; ++kk) wgmma_rs_n64_tb(o, p[kk], dv + 128 * kk);
}

// ONE: t <= CHUNK, the one-pass path, compiled on its own.
template <int VARIANT, bool ONE>
__global__ void __launch_bounds__(THREADS, 1)
attention_train_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const uint8_t* __restrict__ valid, bf16* __restrict__ o,
                           float* __restrict__ lse, int heads, int t, int n_tiles,
                           float scale) {
  extern __shared__ __align__(128) char smem_dyn[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>((reinterpret_cast<uintptr_t>(smem_dyn) + 1023) &
                                           ~uintptr_t(1023));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nq = (t + FWD_BQ - 1) / FWD_BQ, n_ch = ONE ? 1 : (t + CHUNK - 1) / CHUNK;
  // chunk loads a tile: one pass loads K and V once; two passes load K for
  // pass 1, then K and V for pass 2
  const int loads = ONE ? 1 : 2 * n_ch;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.q_full[i], 1);
      mbar_init(&s.q_empty[i], CONSUMERS);
    }
    for (int i = 0; i < FWD_STAGES; ++i) {
      mbar_init(&s.kv_full[i], 1);
      mbar_init(&s.kv_empty[i], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS) {  // ------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == CONSUMERS && lane == 0) {
      uint32_t it = 0;  // chunks requested, over all of this CTA's tiles
      int i = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
        const int bh = tile / nq, qb = i & 1;
        mbar_wait(&s.q_empty[qb], ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(&s.q_full[qb], FWD_BQ * ROW);
        tma_load_3d(s.q[qb], &map_q, &s.q_full[qb], 0, (tile % nq) * FWD_BQ, bh);
        for (int j = 0; j < loads; ++j, ++it) {
          const int st = it % FWD_STAGES;
          const bool with_v = j >= loads - n_ch;
          mbar_wait(&s.kv_empty[st], ((it / FWD_STAGES) & 1) ^ 1);
          mbar_expect_tx(&s.kv_full[st], (with_v ? 2 : 1) * CHUNK * ROW);
          tma_load_3d(s.k[st], &map_k, &s.kv_full[st], 0, (j % n_ch) * CHUNK, bh);
          if (with_v) tma_load_3d(s.v[st], &map_v, &s.kv_full[st], 0, (j % n_ch) * CHUNK, bh);
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CREGS));
    const int wg = warp / 4, g = lane / 4, tg = lane % 4;
    const float qscale = __bfloat162float(__float2bfloat16_rn(scale));
    uint32_t it = 0;
    int i = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const int bh = tile / nq, q0 = (tile % nq) * FWD_BQ, qb = i & 1;
      const uint8_t* vrow = valid + (size_t)(bh / heads) * t;
      mbar_wait(&s.q_full[qb], (i >> 1) & 1);
      bf16* qw = s.q[qb] + wg * 64 * HD;  // this warpgroup's 64 rows
      scale_rows(qw, 64, qscale, threadIdx.x % 128, 128);
      fence_proxy_async();  // the generic writes, before wgmma reads them
      bar_sync(1 + wg, 128);
      const uint64_t dq = desc_sw128(smem_u32(qw), 16);

      float acc[HD / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

      // pass 1 (T > CHUNK only): the row max over every chunk (NORMP also
      // carries l online)
      for (int j = 0; !ONE && j < n_ch; ++j, ++it) {
        const int st = it % FWD_STAGES;
        mbar_wait(&s.kv_full[st], (it / FWD_STAGES) & 1);
        Scores sc;
        chunk_scores(sc, dq, smem_u32(s.k[st]));
        mask_chunk(sc, vrow, j * CHUNK, t, lane);
        max_chunk(sc, m, l, VARIANT == FWD_NORMP);
        if (lane == 0) mbar_arrive(&s.kv_empty[st]);
      }
      if (!ONE && VARIANT == FWD_NORMP) {
        l[0] = quad_sum(l[0]);  // pass 1's online sum, whole rows
        l[1] = quad_sum(l[1]);
      }
      // the one pass, or pass 2: p against the row max, P V
      for (int j = 0; j < n_ch; ++j, ++it) {
        const int st = it % FWD_STAGES;
        mbar_wait(&s.kv_full[st], (it / FWD_STAGES) & 1);
        Scores sc;
        fence_regs(acc);
        chunk_scores(sc, dq, smem_u32(s.k[st]));
        if (j == n_ch - 1 && lane == 0) mbar_arrive(&s.q_empty[qb]);
        mask_chunk(sc, vrow, j * CHUNK, t, lane);
        if (ONE) max_chunk(sc, m, l, false);
        const uint32_t vb = smem_u32(s.v[st]);
        // p of the whole chunk first (NORMP rounds p / l, so needs l whole),
        // then P V by halves as one group, the second half's fragments
        // packed while the first half's product runs.
        const bool sum = VARIANT != FWD_NORMP || ONE;
        exp_half<VARIANT>(sc[0], m, l, sum);
        exp_half<VARIANT>(sc[1], m, l, sum);
        float inv[2] = {1.f, 1.f};
        if (VARIANT == FWD_NORMP) {
          if (ONE) {
            l[0] = quad_sum(l[0]);
            l[1] = quad_sum(l[1]);
          }
          inv[0] = 1.f / l[0];
          inv[1] = 1.f / l[1];
        }
        uint32_t pp[2][HALF / 16][4];
        pack_half(sc[0], inv, pp[0]);
        fence_regs(acc);
        wgmma_fence();
        start_pv(acc, pp[0], vb);
        pack_half(sc[1], inv, pp[1]);
        wgmma_fence();
        start_pv(acc, pp[1], vb + HALF * ROW);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pp[0]);
        fence_regs(pp[1]);
        if (lane == 0) mbar_arrive(&s.kv_empty[st]);
      }

      if (VARIANT != FWD_NORMP) {
        l[0] = quad_sum(l[0]);
        l[1] = quad_sum(l[1]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + g + 8 * r;
        if (row >= t) continue;
        const float inv = VARIANT == FWD_NORMP ? 1.f : 1.f / l[r];
        bf16* orow = o + ((size_t)bh * t + row) * HD + 2 * tg;
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt)
          *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
              __floats2bfloat162_rn(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
        if (tg == 0) lse[(size_t)bh * t + row] = (m[r] == NEG2 ? NEG : m[r] * LN2) + logf(l[r]);
      }
    }
  }
}

// ------------------------------------------------------------ backward
constexpr int BWD_BQ = 64;     // queries of a block
constexpr int SUB = 32;        // queries of one S^T / dP^T product
constexpr int BWD_STAGES = 3;  // query blocks in the ring

struct alignas(1024) BwdStage {
  bf16 q[BWD_BQ * HD];  // q, then q * scale after the block's pre-pass
  bf16 dout[BWD_BQ * HD];
  bf16 o[BWD_BQ * HD];
  float lse[BWD_BQ];
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
attention_train_bwd_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_o,
                           const __grid_constant__ CUtensorMap map_do,
                           const float* __restrict__ lse, const uint8_t* __restrict__ valid,
                           bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                           float* __restrict__ dq_acc, int n_bh, int heads, int t,
                           float scale) {
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

// ---------------------------------------------------------------- host

bool shape_ok(int bh, int heads, int t, int head_dim) {
  return head_dim == HD && bh > 0 && heads > 0 && bh % heads == 0 && t > 0 && t % 64 == 0 &&
         t <= MAX_T;
}

// A 3-D map over one (bh, t, 64) operand in boxes of `rows` rows.
int head_map(CUtensorMap* map, const void* base, int bh, int t, int rows) {
  return encode_map(map, base, HD, t, bh, HD, (long long)t * HD, rows);
}

template <int VARIANT, bool ONE>
int launch_fwd_one(const void* q, const void* k, const void* v, const uint8_t* valid, void* o,
               float* lse, int bh, int heads, int t, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = head_map(&mq, q, bh, t, FWD_BQ);
  if (err == 0) err = head_map(&mk, k, bh, t, CHUNK);
  if (err == 0) err = head_map(&mv, v, bh, t, CHUNK);
  if (err != 0) return err;
  static LaunchSetup setup;
  int sms = 0;
  err = setup.sms(attention_train_fwd_kernel<VARIANT, ONE>, FWD_SMEM, &sms);
  if (err != 0) return err;
  const int n_tiles = bh * ((t + FWD_BQ - 1) / FWD_BQ);
  attention_train_fwd_kernel<VARIANT, ONE><<<n_tiles < sms ? n_tiles : sms, THREADS, FWD_SMEM,
                                        stream>>>(mq, mk, mv, valid, static_cast<bf16*>(o), lse,
                                                  heads, t, n_tiles, scale);
  return (int)cudaGetLastError();
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
  err = setup.sms(attention_train_bwd_kernel<VARIANT, ONE>, BWD_SMEM, &sms);
  if (err != 0) return err;
  attention_train_bwd_kernel<VARIANT, ONE><<<bh < sms ? bh : sms, THREADS, BWD_SMEM, stream>>>(
      mq, mk, mv, mo, mdo, lse, valid, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dq_acc, bh, heads, t, scale);
  return (int)cudaGetLastError();
}

template <int VARIANT>
int launch_fwd(const void* q, const void* k, const void* v, const uint8_t* valid, void* o,
               float* lse, int bh, int heads, int t, float scale, cudaStream_t stream) {
  return t <= CHUNK
             ? launch_fwd_one<VARIANT, true>(q, k, v, valid, o, lse, bh, heads, t, scale, stream)
             : launch_fwd_one<VARIANT, false>(q, k, v, valid, o, lse, bh, heads, t, scale, stream);
}

template <int VARIANT>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const float* lse,
               const void* dout, const uint8_t* valid, void* dq, void* dk, void* dv,
               float* dq_acc, int bh, int heads, int t, float scale, cudaStream_t stream) {
  return t <= CHUNK ? launch_bwd_one<VARIANT, true>(q, k, v, o, lse, dout, valid, dq, dk, dv,
                                                    dq_acc, bh, heads, t, scale, stream)
                    : launch_bwd_one<VARIANT, false>(q, k, v, o, lse, dout, valid, dq, dk, dv,
                                                     dq_acc, bh, heads, t, scale, stream);
}

// Make `device` current on this thread. The backward runs on autograd's
// worker thread, where no CUDA context need be current yet (PyTorch's
// device guard sets none when its device already matches), and
// cuTensorMapEncodeTiled then refuses every address.
int use_device(int device) { return (int)cudaSetDevice(device); }

}  // namespace

// q, k, v, o: (bh, t, 64) bf16, contiguous each, 16-byte aligned; valid:
// (bh / heads, t) bytes, nonzero = attend; lse: (bh, t) float32. t % 64 ==
// 0, t <= 1024. variant: 0 = F32, 1 = BF16EXP, 2 = NORMP. device: the
// tensors' CUDA device. Returns a cudaError_t (0 = launched).
extern "C" int vipers_attention_train_fwd(const void* q, const void* k,
                                          const void* v, const uint8_t* valid,
                                          void* o, float* lse, int bh,
                                          int heads, int t, int head_dim,
                                          float scale, int variant, int device,
                                          void* stream) {
  if (!shape_ok(bh, heads, t, head_dim) || valid == nullptr)
    return (int)cudaErrorInvalidValue;
  const int err = use_device(device);
  if (err != 0) return err;
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
// dq, dk, dv (bh, t, 64) bf16. dq_acc: an f32 scratch (bh, t, 64) that
// needs no initialisation where t > 256, else unused (may be null).
// variant: 0 = F32, 1 = BF16EXP.
extern "C" int vipers_attention_train_bwd(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const float* lse, const void* dout,
                                          const uint8_t* valid, void* dq,
                                          void* dk, void* dv, float* dq_acc,
                                          int bh, int heads, int t,
                                          int head_dim, float scale,
                                          int variant, int device, void* stream) {
  if (!shape_ok(bh, heads, t, head_dim) || valid == nullptr ||
      (t > CHUNK && dq_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  const int err = use_device(device);
  if (err != 0) return err;
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

// The compiled design, for the kernels' report lines: the forward's query
// rows a tile, keys a chunk and K/V stages; the backward's query rows a
// block and ring stages (its keys a round are the chunk).
extern "C" void vipers_attention_train_design(int* fwd_block_q, int* chunk, int* fwd_stages,
                                              int* bwd_block_q, int* bwd_stages) {
  *fwd_block_q = FWD_BQ;
  *chunk = CHUNK;
  *fwd_stages = FWD_STAGES;
  *bwd_block_q = BWD_BQ;
  *bwd_stages = BWD_STAGES;
}
