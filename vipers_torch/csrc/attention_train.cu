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
//
// Backward: attention_bwd.cuh's one-pass kernel, its design described
// there: one CTA per (b, h), dK and dV in registers, dQ from dS^T staged
// by stmatrix, keys in rounds of 256 with dQ summed in an f32 scratch
// beyond.
//
// Head dim 80 (vit_h_14's 16 heads of 80; the F32 variant only, the model
// path's): each row of Q, K and V is two TMA boxes, its first 64 columns as
// above and a 16-column tail with the 32-byte swizzle in tiles of its own
// (attention_bwd.cuh, attention_tile.cuh). S takes a fifth k16 step from
// the tails; P V is an n64 product on V and an n16 on its tail into the
// accumulator's last two 8-column groups. The forward's shared memory
// grows to 202 KB (the tails' 40 KB); its shape stays.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd.cuh"

namespace {

using namespace attn_bwd;  // the warp layout, constants and helpers both kernels share

constexpr int MAX_T = 1024;
constexpr int HALF = CHUNK / 2;  // keys of one m64n128 score accumulator

enum FwdVariant { FWD_F32 = 0, FWD_BF16EXP = 1, FWD_NORMP = 2 };

// ------------------------------------------------------------- forward
constexpr int FWD_BQ = 64 * WGS;  // query rows of a tile
constexpr int FWD_STAGES = 2;     // K/V chunks in the ring

// The tails' tiles at hd 80 (32 bytes a row; an empty base at hd 64).
template <int TAIL>
struct alignas(1024) FwdTailSmem {
  bf16 qt[2][FWD_BQ * TAIL];
  bf16 kt[FWD_STAGES][CHUNK * TAIL];
  bf16 vt[FWD_STAGES][CHUNK * TAIL];
};
template <>
struct FwdTailSmem<0> {};

template <int D>
struct FwdSmem : FwdTailSmem<tail_of<D>()> {
  bf16 q[2][FWD_BQ * HD];  // every tile 1024-byte aligned: the swizzle atom
  bf16 k[FWD_STAGES][CHUNK * HD];
  bf16 v[FWD_STAGES][CHUNK * HD];
  uint64_t q_full[2], q_empty[2], kv_full[FWD_STAGES], kv_empty[FWD_STAGES];
};
template <int D>
__host__ __device__ constexpr int fwd_smem() {
  return (int)sizeof(FwdSmem<D>) + 1024;  // + the alignment slack
}
static_assert(fwd_smem<HD + 16>() <= 232448, "hd-80 forward shared memory");

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
// swizzled row), as two m64n128 products in one group, waited for. At hd 80
// (TAIL) a fifth k step reads the tails' tiles, qtb and ktb.
template <int TAIL = 0>
__device__ __forceinline__ void chunk_scores(Scores& sc, uint64_t dq, uint32_t kb,
                                             uint32_t qtb = 0, uint32_t ktb = 0) {
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint64_t dk = desc_sw128(kb + h * HALF * ROW, 16);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss_n128(sc[h], dq + 2 * kk, dk + 2 * kk, kk);
    if constexpr (TAIL > 0) wgmma_ss_n128(sc[h], desc_sw32(qtb), desc_sw32(ktb + h * HALF * TROW), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc[0]);
  fence_regs(sc[1]);
}

// Start O += P V over one half on wgmma: P from registers, V MN-major
// through the transpose bit (16 keys = 2048 bytes a step); at hd 80 (D)
// the tail's 16 columns (vtb; 512 bytes a step) into O's last two 8-column
// groups. The caller fences before and commits after.
template <int D = HD>
__device__ __forceinline__ void start_pv(float (&o)[D / 8][4], const uint32_t (&p)[HALF / 16][4],
                                         uint32_t vb, uint32_t vtb = 0) {
  const uint64_t dv = desc_sw128(vb, 1024);
  float (&oh)[HD / 8][4] = *reinterpret_cast<float (*)[HD / 8][4]>(&o[0]);
#pragma unroll
  for (int kk = 0; kk < HALF / 16; ++kk) wgmma_rs_n64_tb(oh, p[kk], dv + 128 * kk);
  if constexpr (D > HD) {
    float (&ot)[(D - HD) / 8][4] = *reinterpret_cast<float (*)[(D - HD) / 8][4]>(&o[HD / 8]);
    const uint64_t dvt = desc_sw32(vtb);
#pragma unroll
    for (int kk = 0; kk < HALF / 16; ++kk) wgmma_rs_n16_tb(ot, p[kk], dvt + 32 * kk);
  }
}

// The shared addresses of a K/V stage's tails (0 at hd 64, which has none).
template <int D>
__device__ __forceinline__ uint32_t kt_at(FwdSmem<D>& s, int st) {
  if constexpr (tail_of<D>() > 0) return smem_u32(s.kt[st]);
  return 0;
}
template <int D>
__device__ __forceinline__ uint32_t vt_at(FwdSmem<D>& s, int st) {
  if constexpr (tail_of<D>() > 0) return smem_u32(s.vt[st]);
  return 0;
}

// ONE: t <= CHUNK, the one-pass path, compiled on its own. D: the head
// dim; at 80 `tails` holds the maps of the rows' last 16 columns (q, k, v;
// last, so that the hd-64 instances' parameters lie where they lay before).
template <int VARIANT, bool ONE, int D = HD>
__global__ void __launch_bounds__(THREADS, 1)
attention_train_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const uint8_t* __restrict__ valid, bf16* __restrict__ o,
                           float* __restrict__ lse, int heads, int t, int n_tiles,
                           float scale, const __grid_constant__ Tails<tail_of<D>()> tails) {
  constexpr int TAIL = tail_of<D>();
  extern __shared__ __align__(128) char smem_dyn[];
  FwdSmem<D>& s = *reinterpret_cast<FwdSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
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
        mbar_expect_tx(&s.q_full[qb], FWD_BQ * D * 2);
        tma_load_3d(s.q[qb], &map_q, &s.q_full[qb], 0, (tile % nq) * FWD_BQ, bh);
        if constexpr (TAIL > 0)
          tma_load_3d(s.qt[qb], &tails.q, &s.q_full[qb], HD, (tile % nq) * FWD_BQ, bh);
        for (int j = 0; j < loads; ++j, ++it) {
          const int st = it % FWD_STAGES;
          const bool with_v = j >= loads - n_ch;
          mbar_wait(&s.kv_empty[st], ((it / FWD_STAGES) & 1) ^ 1);
          mbar_expect_tx(&s.kv_full[st], (with_v ? 2 : 1) * CHUNK * D * 2);
          tma_load_3d(s.k[st], &map_k, &s.kv_full[st], 0, (j % n_ch) * CHUNK, bh);
          if (with_v) tma_load_3d(s.v[st], &map_v, &s.kv_full[st], 0, (j % n_ch) * CHUNK, bh);
          if constexpr (TAIL > 0) {
            tma_load_3d(s.kt[st], &tails.k, &s.kv_full[st], HD, (j % n_ch) * CHUNK, bh);
            if (with_v)
              tma_load_3d(s.vt[st], &tails.v, &s.kv_full[st], HD, (j % n_ch) * CHUNK, bh);
          }
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
      uint32_t qtb = 0;  // the tail of its rows (hd 80)
      if constexpr (TAIL > 0) {
        bf16* qtw = s.qt[qb] + wg * 64 * TAIL;
        scale_rows<TROW>(qtw, 64, qscale, threadIdx.x % 128, 128);
        qtb = smem_u32(qtw);
      }
      fence_proxy_async();  // the generic writes, before wgmma reads them
      bar_sync(1 + wg, 128);
      const uint64_t dq = desc_sw128(smem_u32(qw), 16);

      float acc[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

      // pass 1 (T > CHUNK only): the row max over every chunk (NORMP also
      // carries l online)
      for (int j = 0; !ONE && j < n_ch; ++j, ++it) {
        const int st = it % FWD_STAGES;
        mbar_wait(&s.kv_full[st], (it / FWD_STAGES) & 1);
        Scores sc;
        chunk_scores<TAIL>(sc, dq, smem_u32(s.k[st]), qtb, kt_at(s, st));
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
        chunk_scores<TAIL>(sc, dq, smem_u32(s.k[st]), qtb, kt_at(s, st));
        if (j == n_ch - 1 && lane == 0) mbar_arrive(&s.q_empty[qb]);
        mask_chunk(sc, vrow, j * CHUNK, t, lane);
        if (ONE) max_chunk(sc, m, l, false);
        const uint32_t vb = smem_u32(s.v[st]), vtb = vt_at(s, st);
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
        start_pv<D>(acc, pp[0], vb, vtb);
        pack_half(sc[1], inv, pp[1]);
        wgmma_fence();
        start_pv<D>(acc, pp[1], vb + HALF * ROW, vtb + HALF * TROW);
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
        bf16* orow = o + ((size_t)bh * t + row) * D + 2 * tg;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
          *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
              __floats2bfloat162_rn(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
        if (tg == 0) lse[(size_t)bh * t + row] = (m[r] == NEG2 ? NEG : m[r] * LN2) + logf(l[r]);
      }
    }
  }
}

// ---------------------------------------------------------------- host

// Head dim 64 takes every variant, 80 the model path's F32 alone (the A/B
// tool runs its variants at 64).
bool shape_ok(int bh, int heads, int t, int head_dim, int variant) {
  return (head_dim == HD || (head_dim == HD + 16 && variant == 0)) && bh > 0 && heads > 0 &&
         bh % heads == 0 && t > 0 && t % 64 == 0 && t <= MAX_T;
}

template <int VARIANT, bool ONE, int D>
int launch_fwd_one(const void* q, const void* k, const void* v, const uint8_t* valid, void* o,
               float* lse, int bh, int heads, int t, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = head_map<D>(&mq, q, bh, t, FWD_BQ);
  if (err == 0) err = head_map<D>(&mk, k, bh, t, CHUNK);
  if (err == 0) err = head_map<D>(&mv, v, bh, t, CHUNK);
  Tails<tail_of<D>()> tails;
  if constexpr (tail_of<D>() > 0) {
    if (err == 0) err = tail_map<D>(&tails.q, q, bh, t, FWD_BQ);
    if (err == 0) err = tail_map<D>(&tails.k, k, bh, t, CHUNK);
    if (err == 0) err = tail_map<D>(&tails.v, v, bh, t, CHUNK);
  }
  if (err != 0) return err;
  static LaunchSetup setup;
  int sms = 0;
  err = setup.sms(attention_train_fwd_kernel<VARIANT, ONE, D>, fwd_smem<D>(), &sms);
  if (err != 0) return err;
  const int n_tiles = bh * ((t + FWD_BQ - 1) / FWD_BQ);
  attention_train_fwd_kernel<VARIANT, ONE, D><<<n_tiles < sms ? n_tiles : sms, THREADS,
                                                fwd_smem<D>(), stream>>>(
      mq, mk, mv, valid, static_cast<bf16*>(o), lse, heads, t, n_tiles, scale, tails);
  return (int)cudaGetLastError();
}

template <int VARIANT, int D = HD>
int launch_fwd(const void* q, const void* k, const void* v, const uint8_t* valid, void* o,
               float* lse, int bh, int heads, int t, float scale, cudaStream_t stream) {
  return t <= CHUNK
             ? launch_fwd_one<VARIANT, true, D>(q, k, v, valid, o, lse, bh, heads, t, scale,
                                                stream)
             : launch_fwd_one<VARIANT, false, D>(q, k, v, valid, o, lse, bh, heads, t, scale,
                                                 stream);
}

// Make `device` current on this thread. The backward runs on autograd's
// worker thread, where no CUDA context need be current yet (PyTorch's
// device guard sets none when its device already matches), and
// cuTensorMapEncodeTiled then refuses every address.
int use_device(int device) { return (int)cudaSetDevice(device); }

}  // namespace

// q, k, v, o: (bh, t, head_dim) bf16, contiguous each, 16-byte aligned;
// valid: (bh / heads, t) bytes, nonzero = attend; lse: (bh, t) float32. t %
// 64 == 0, t <= 1024. variant: 0 = F32, 1 = BF16EXP, 2 = NORMP; head_dim 64,
// or 80 with variant 0. device: the tensors' CUDA device. Returns a
// cudaError_t (0 = launched).
extern "C" int vipers_attention_train_fwd(const void* q, const void* k,
                                          const void* v, const uint8_t* valid,
                                          void* o, float* lse, int bh,
                                          int heads, int t, int head_dim,
                                          float scale, int variant, int device,
                                          void* stream) {
  if (!shape_ok(bh, heads, t, head_dim, variant) || valid == nullptr)
    return (int)cudaErrorInvalidValue;
  const int err = use_device(device);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim != HD)
    return launch_fwd<FWD_F32, HD + 16>(q, k, v, valid, o, lse, bh, heads, t, scale, st);
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

// Inputs as for the forward plus o, lse and dout (bh, t, head_dim) bf16;
// outputs dq, dk, dv (bh, t, head_dim) bf16. dq_acc: an f32 scratch (bh, t,
// head_dim) that needs no initialisation where t exceeds the backward's keys
// a round (256 at head dim 64, 128 at 80), else unused (may be null).
// variant: 0 = F32, 1 = BF16EXP (head dim 64 only).
extern "C" int vipers_attention_train_bwd(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const float* lse, const void* dout,
                                          const uint8_t* valid, void* dq,
                                          void* dk, void* dv, float* dq_acc,
                                          int bh, int heads, int t,
                                          int head_dim, float scale,
                                          int variant, int device, void* stream) {
  const int chunk = head_dim == HD ? bwd_chunk<HD>() : bwd_chunk<HD + 16>();
  if (!shape_ok(bh, heads, t, head_dim, variant) || valid == nullptr ||
      (t > chunk && dq_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  const int err = use_device(device);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim != HD)
    return launch_bwd<BWD_F32, HD + 16>(q, k, v, o, lse, dout, valid, dq, dk, dv, dq_acc, bh,
                                        heads, t, scale, st);
  switch (variant) {
    case BWD_F32:
      return launch_bwd<BWD_F32>(q, k, v, o, lse, dout, valid, dq, dk, dv, dq_acc, bh, heads,
                                 t, scale, st);
    case BWD_BF16EXP:
      return launch_bwd<BWD_BF16EXP>(q, k, v, o, lse, dout, valid, dq, dk, dv, dq_acc, bh,
                                     heads, t, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The compiled design of the head_dim instance (64 or 80), for the
// kernels' report lines: the forward's query rows a tile, keys a chunk and
// K/V stages; the backward's query rows a block, ring stages and keys a
// round, into out[6].
extern "C" void vipers_attention_train_design(int head_dim, int* out) {
  const int vals[6] = {FWD_BQ, CHUNK, FWD_STAGES, BWD_BQ, BWD_STAGES,
                       head_dim == HD ? bwd_chunk<HD>() : bwd_chunk<HD + 16>()};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
}
