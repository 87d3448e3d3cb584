// The blockwise attention forward tiles of the port's flash kernels:
// flash_attention_fwd.cu (head-major (B*H, T, 64)) and
// flash_attention_packed.cu (token-major packed qkv stripes), and of
// splash_attention.cu; and the f32 building blocks that the f32 forward
// shares with the f32 flash backward (flash_attention_bwd.cu). A caller
// hands one head to a tile as tensor-map coordinates and output rows
// (HeadViewOf), so the layout lives only in the kernel that computes them.
//
// Both tiles stream K/V past a block of query rows and keep the running
// row max m and sum l in f32 registers (online softmax, in log2 units), so
// the (T, T) matrix never reaches device memory. Keys whose valid byte is
// 0 get -1e9 on the f32 scores (the JAX kernels' mask: exp underflows to 0
// once a valid key has been seen); keys beyond t are excluded, so a row
// whose keys are all invalid is the average of v over the t keys, as in
// JAX. Final: l_safe = max(l, 1e-20), O = acc / l_safe and, where an lse
// row is given, lse = m + log(l_safe).
//
//   bf16 tile: Hopper's TMA, mbarriers and wgmma (namespace hopper below,
//              on the building blocks of hopper.cuh), also the splash
//              kernel's (splash_attention.cu: no mask, other tile shapes,
//              K optionally seq-minor).
//   f32 tile:  the same structure on TF32 wgmma, every product three TF32
//              products (3xTF32, hopper.cuh), f32 everywhere else: 128
//              query rows, K/V in 32-key stages split by the producer
//              warpgroup.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace attn_tile {

typedef __nv_bfloat16 bf16;

// Head dim of the shared pieces (the backward's, the packed and splash
// kernels'); the flash forward's tiles take 64 or HD + 16 = 80 as a template
// parameter D (the wrappers reject any other).
constexpr int HD = 64;
constexpr float NEG = -1e9f;

// Columns of a row beyond the first HD: 0, or 16 at hd 80.
template <int D>
__host__ __device__ constexpr int tail_cols() {
  static_assert(D == HD || D == HD + 16, "head dim 64 or 80");
  return D - HD;
}

// ------------------------------------------------- bf16 / Hopper (sm_90a)
//
// One CTA walks over (head, query tile) pairs, head-major: a persistent grid
// of at most one CTA per SM, so the next tile's Q arrives while this one
// finishes. WGS = 3 consumer warpgroups own 64 query rows each (BQ = 192);
// one thread of the last warpgroup produces: Q by one TMA load into one of
// two buffers, then K and V tiles of BK = 128 keys by TMA into a ring of
// STAGES = 3 stages, each 64-wide bf16 row 128 bytes with the 128-byte
// swizzle. That shape was the fastest of those timed at the LOST shape on
// an H100 (128 or 192 queries, 2-4 stages; see PERF.md).
// Head dim 80 (vit_h_14): a 160-byte row fits no one swizzle row, so each
// row of Q, K and V is two TMA boxes from two tensor maps, its first 64
// columns as above and a 16-column tail of 32 bytes with the 32-byte
// swizzle in tiles of its own. S = Q K^T takes four k16 steps from the
// 128-byte descriptors and a fifth from the tails'; O += P V is an n64
// product on the 64-column V tile and an n16 on the tail, into the
// accumulator's last two 8-column groups. Nothing is padded: the products
// do the 80 columns' work and no more. The tile has two consumer
// warpgroups (128 query rows), 128-key tiles and three stages (160 KB of
// shared memory): with three, a consumer's 160 registers do not hold the
// 40 accumulators a thread more, ptxas spilled 48 bytes and serialized the
// wgmma, and the kernel took 2.50 ms at vit_h_14's LOST shape against two
// warpgroups' 1.87 (240 registers a consumer, no spill; PERF.md).
// full/empty mbarriers hand the buffers over; setmaxnreg moves the
// producer's registers to the consumers.
//
// Consumers: S = Q K^T by wgmma m64nBKk16 from shared memory (both
// K-major); O += P V by the register-A wgmma m64n64k16, V read in its
// [key][dim] layout through the descriptor's transpose bit, so nothing is
// transposed in shared memory. S of key tile j starts together with P V
// of tile j - 1, so one tile's softmax runs while the tensor cores finish
// the last one's product.
//
// Softmax: running m and l per row in f32, in log2 units; p = exp2(s *
// scale*log2(e) - m), by one FMA where a tile has no masked key, rounded to
// bf16 for P V. Keys whose valid byte is 0 get the JAX kernels' -1e9 (in
// log2 units), keys beyond t are excluded (TMA reads them as zero rows);
// each warp reads the tile's valid bytes once and ballots them. The end:
// l_safe = max(l, 1e-20), O = acc / l_safe, lse = m ln 2 + log(l_safe),
// exactly -1e9 + log(l_safe) for a row that saw only masked keys (the
// uniform average); query rows beyond t are not written.
namespace hopper {

using namespace ::hopper;  // the building blocks, hopper.cuh

constexpr int ROW = HD * 2;  // bytes in a row: one 128-byte swizzle row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG2 = NEG * LOG2E;  // the -1e9 mask in log2 units

// The flash and packed kernels' tile. The kernel below takes its shape as
// template parameters (NWG consumer warpgroups, KEYS keys a K/V tile, RING
// stages): the splash kernel runs other shapes.
constexpr int WGS = 3;                   // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * WGS;             // query rows of a tile
constexpr int BK = 128;                  // keys of a K/V tile
constexpr int STAGES = 3;                // K/V tiles in the ring

// Consumer warpgroups and query rows of the head-dim-D tile: WGS and BQ at
// hd 64, two and 128 at hd 80 (registers; see above).
template <int D>
__host__ __device__ constexpr int wgs_of() {
  return D == HD ? WGS : 2;
}
template <int D>
__host__ __device__ constexpr int bq_of() {
  return 64 * wgs_of<D>();
}

// The tensor maps of the rows' 16-column tails at hd 80 (boxes of 16
// columns, 32-byte swizzle, read at column HD); none at hd 64.
template <int TAIL>
struct TailMaps {
  CUtensorMap q, k, v;
};
template <>
struct TailMaps<0> {};

// The tails' tiles, 32 bytes a row, every tile 1024-byte aligned, and their
// shared addresses (0 where there are none).
template <int NWG, int KEYS, int RING, int TAIL>
struct TailSmem {
  bf16 qt[2][64 * NWG * TAIL];
  bf16 kt[RING][KEYS * TAIL];
  bf16 vt[RING][KEYS * TAIL];
  __device__ uint32_t qt_at(int b) const { return smem_u32(qt[b]); }
  __device__ uint32_t kt_at(int st) const { return smem_u32(kt[st]); }
  __device__ uint32_t vt_at(int st) const { return smem_u32(vt[st]); }
};
template <int NWG, int KEYS, int RING>
struct TailSmem<NWG, KEYS, RING, 0> {  // an empty base: takes no bytes
  __device__ uint32_t qt_at(int) const { return 0; }
  __device__ uint32_t kt_at(int) const { return 0; }
  __device__ uint32_t vt_at(int) const { return 0; }
};

template <int NWG, int KEYS, int RING, int D = HD>
struct Smem : TailSmem<NWG, KEYS, RING, tail_cols<D>()> {
  bf16 q[2][64 * NWG * HD];  // every tile 1024-byte aligned: the swizzle atom
  bf16 k[RING][KEYS * HD];
  bf16 v[RING][KEYS * HD];
  uint64_t q_full[2], q_empty[2], kv_full[RING], kv_empty[RING];
};

// Where one head lives: tensor-map coordinates (outer index, column of q, k
// and v), its output rows, its lse row (null: not written) and its key
// bytes (null: all valid); T the output's element type.
template <class T>
struct HeadViewOf {
  int z, qcol, kcol, vcol;
  T* o;
  int ldo;
  float* lse;
  const uint8_t* valid;
};
typedef HeadViewOf<bf16> HeadView;

// Start S (this warpgroup's 64 rows x KEYS keys) = Q K^T on wgmma as one
// group; qb and kb are the shared addresses of the warpgroup's Q rows and of
// the K tile. K is [key][dim] (K-major: 16 dims = 32 bytes along the
// swizzled row) or, with K_T, [dim][key] in 64-key swizzled tiles 8 KB
// apart (MN-major through the transpose bit: 16 dims = 16 rows = 2048
// bytes, the next 64 keys at the leading offset). At hd 80 (D) the fifth k
// step reads the tails' tiles, qtb and ktb, K-major. The caller fences and
// waits.
template <int KEYS, bool K_T = false, int D = HD>
__device__ __forceinline__ void start_scores(float (&s)[KEYS / 8][4], uint32_t qb, uint32_t kb,
                                             uint32_t qtb = 0, uint32_t ktb = 0) {
  const uint64_t dq = desc_sw128(qb, 16), dk = desc_sw128(kb, K_T ? 64 * ROW : 16);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if constexpr (KEYS == 128)
      wgmma_ss_n128<K_T>(s, dq + 2 * kk, dk + (K_T ? 128 : 2) * kk, kk);
    else
      wgmma_ss_n64<K_T>(s, dq + 2 * kk, dk + (K_T ? 128 : 2) * kk, kk);
  }
  if constexpr (tail_cols<D>() > 0) {
    static_assert(KEYS == 128 && !K_T, "the hd-80 tile: 128-key tiles of [key][dim] K");
    wgmma_ss_n128<0>(s, desc_sw32(qtb), desc_sw32(ktb), 1);
  }
  wgmma_commit();
}

// Start O += P V on wgmma as one group: P from registers, V MN-major
// through the transpose bit. At hd 80 (D) the tail's 16 columns of V (vtb)
// go into O's last two 8-column groups by an n16 product.
template <int KEYS, int D = HD>
__device__ __forceinline__ void start_pv(float (&o)[D / 8][4], const uint32_t (&p)[KEYS / 16][4],
                                         uint32_t vb, uint32_t vtb = 0) {
  const uint64_t dv = desc_sw128(vb, 1024);
  float (&oh)[HD / 8][4] = *reinterpret_cast<float (*)[HD / 8][4]>(&o[0]);
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk)  // 16 keys = 2048 bytes
    wgmma_rs_n64_tb(oh, p[kk], dv + 128 * kk);
  if constexpr (tail_cols<D>() > 0) {
    float (&ot)[tail_cols<D>() / 8][4] =
        *reinterpret_cast<float (*)[tail_cols<D>() / 8][4]>(&o[HD / 8]);
    const uint64_t dvt = desc_sw32(vtb);
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)  // 16 keys = 512 bytes
      wgmma_rs_n16_tb(ot, p[kk], dvt + 32 * kk);
  }
  wgmma_commit();
}

// The mask of keys k0 .. k0 + BK - 1 on this thread's raw scores (columns
// 8j + 2tg + e%2 of the mma C layout, tg = lane % 4). Each warp reads the
// tile's valid bytes once, 4 a lane, and ballots them. A tile whose keys
// are all valid is left as it is and the softmax applies the scale
// (returns scale_log2); else every score is scaled here, -1e9 (log2 units)
// where the valid byte is 0 and -inf beyond t (returns 1).
__device__ __forceinline__ float mask_scores(float (&s)[BK / 8][4], const uint8_t* valid, int k0,
                                             int t, float scale_log2, int lane) {
  static_assert(BK == 128, "one ballot word per 32 x 4 keys");
  if (valid == nullptr && k0 + BK <= t) return scale_log2;
  const int tg = lane & 3;
  uint32_t w[4];
  bool all = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + lane * 4 + i;
    w[i] = __ballot_sync(0xffffffffu, key < t && (valid == nullptr || __ldg(valid + key) != 0));
    all = all && w[i] == 0xffffffffu;
  }
  if (all) return scale_log2;
  // key 8j + 2tg + e is bit 2j + (2tg + e) / 4 of word (2tg + e) % 4
  uint32_t sel[2];  // this thread's even / odd columns, bit 2j
#pragma unroll
  for (int e = 0; e < 2; ++e) sel[e] = ((tg & 1) ? w[2 + e] : w[e]) >> (tg >> 1);
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * j + 2 * tg + (e & 1);
      const bool ok = (sel[e & 1] >> (2 * j)) & 1u;
      s[j][e] = key >= t ? -INFINITY : (ok ? s[j][e] * scale_log2 : NEG2);
    }
  return 1.f;
}

// Online softmax of one tile of scores for this thread's two rows (g and
// g + 8 of its 16): in log2 units the scores are s * c (c = scale * log2(e),
// or 1 for a tile already scaled and masked). Updates the running max m and
// l (this thread's partial sum; the quad sums it at the end), returns alpha
// and leaves p = exp2(s c - m) in s.
template <int KEYS>
__device__ __forceinline__ void softmax_scores(float (&s)[KEYS / 8][4], float (&m)[2],
                                               float (&l)[2], float (&al)[2], float c) {
  float mx[2] = {s[0][0], s[0][2]};
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)  // the 4 lanes of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    mx[r] = fmaxf(m[r], mx[r] * c);  // c > 0: the max of the scaled scores
    al[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = ex2(fmaf(s[j][e], c, -mx[e / 2]));
      sum[e / 2] += s[j][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * al[r] + sum[r];
}

// O times alpha, and p rounded to bf16 as A fragments: the C layout of key
// groups 2kk and 2kk+1 is the A layout of the 16-key step kk.
template <int KEYS, int D = HD>
__device__ __forceinline__ void rescale_pack(float (&o)[D / 8][4], const float (&al)[2],
                                             const float (&s)[KEYS / 8][4],
                                             uint32_t (&p)[KEYS / 16][4]) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] *= al[e / 2];
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    p[kk][0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
    p[kk][1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
    p[kk][2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    p[kk][3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

template <int NWG>
__host__ __device__ constexpr int tile_threads() {
  return 128 * (NWG + 1);  // + the producer warpgroup
}

// The kernel: NWG consumer warpgroups (64 * NWG query rows a tile), K/V
// tiles of KEYS keys in a ring of RING stages; K_T: K is [dim][key] (the
// splash kernel's seq-minor K), loaded as 64-key boxes and read MN-major;
// MASKED: valid bytes and keys beyond t as described above, else every key
// of a tile is valid (t a multiple of KEYS). Layout maps a head index (0 ..
// n_tiles / tiles-a-head - 1) to its HeadView: the only difference between
// the flash, packed and splash kernels. map_q boxes 64 * NWG rows, map_v
// KEYS rows, map_k KEYS rows (or 64 dims of 64 keys with K_T), 64 columns
// each. D: the head dim, 64 or 80; at 80 `tails` holds the maps of the
// rows' last 16 columns, boxes of the same rows (last, so that the hd-64
// instances' parameters lie where they lay before hd 80).
template <class Layout, int NWG, int KEYS, int RING, bool K_T, bool MASKED, int D = HD>
__global__ void __launch_bounds__(tile_threads<NWG>(), 1)
fwd_bf16(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
         const __grid_constant__ CUtensorMap map_v, const Layout lay, int t, int n_tiles,
         float scale_log2, const __grid_constant__ TailMaps<tail_cols<D>()> tails) {
  constexpr int TQ = 64 * NWG;        // query rows of a tile
  constexpr int CONSUMERS = 4 * NWG;  // consumer warps
  // Registers a thread: R0 at launch (the launch bounds' share, in 8s),
  // CREGS for a consumer, 24 for the producer. setmaxnreg.inc draws only on
  // what the producer warpgroup gave back, and waits for it forever.
  // At hd 80 the consumers take all that the producer gives back (its 40
  // accumulators a thread more).
  constexpr int R0 = (65536 / tile_threads<NWG>()) & ~7;
  constexpr int CMAX = (R0 + (R0 - 24) / NWG) & ~7;
  constexpr int CREGS = D > HD ? CMAX : (R0 < 160 ? 160 : R0);
  static_assert(NWG * 128 * (CREGS - R0) <= 128 * (R0 - 24), "consumer registers");
  typedef Smem<NWG, KEYS, RING, D> Shared;
  extern __shared__ __align__(128) char smem_dyn[];
  Shared& s = *reinterpret_cast<Shared*>((reinterpret_cast<uintptr_t>(smem_dyn) + 1023) &
                                         ~uintptr_t(1023));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nq = (t + TQ - 1) / TQ, n_kt = (t + KEYS - 1) / KEYS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.q_full[i], 1);
      mbar_init(&s.q_empty[i], CONSUMERS);
    }
    for (int i = 0; i < RING; ++i) {
      mbar_init(&s.kv_full[i], 1);
      mbar_init(&s.kv_empty[i], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS) {  // ------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == CONSUMERS && lane == 0) {
      uint32_t it = 0;  // K/V tiles requested, over all of this CTA's tiles
      int i = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
        const HeadView hv = lay.head(tile / nq);
        const int qb = i & 1;
        mbar_wait(&s.q_empty[qb], ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(&s.q_full[qb], TQ * D * 2);
        tma_load_3d(s.q[qb], &map_q, &s.q_full[qb], hv.qcol, (tile % nq) * TQ, hv.z);
        if constexpr (tail_cols<D>() > 0)
          tma_load_3d(s.qt[qb], &tails.q, &s.q_full[qb], hv.qcol + HD, (tile % nq) * TQ, hv.z);
        for (int j = 0; j < n_kt; ++j, ++it) {
          const int st = it % RING;
          mbar_wait(&s.kv_empty[st], ((it / RING) & 1) ^ 1);
          mbar_expect_tx(&s.kv_full[st], 2 * KEYS * D * 2);
          if constexpr (K_T) {
#pragma unroll
            for (int h = 0; h < KEYS / 64; ++h)
              tma_load_3d(s.k[st] + h * 64 * HD, &map_k, &s.kv_full[st], j * KEYS + h * 64, 0,
                          hv.z);
          } else {
            tma_load_3d(s.k[st], &map_k, &s.kv_full[st], hv.kcol, j * KEYS, hv.z);
          }
          tma_load_3d(s.v[st], &map_v, &s.kv_full[st], hv.vcol, j * KEYS, hv.z);
          if constexpr (tail_cols<D>() > 0) {
            tma_load_3d(s.kt[st], &tails.k, &s.kv_full[st], hv.kcol + HD, j * KEYS, hv.z);
            tma_load_3d(s.vt[st], &tails.v, &s.kv_full[st], hv.vcol + HD, j * KEYS, hv.z);
          }
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    if constexpr (CREGS > R0) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CREGS));
    const int g = lane / 4, tg = lane % 4;
    const int wr = warp * 16;  // this warp's first row of the tile
    uint32_t it = 0;
    int i = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const HeadView hv = lay.head(tile / nq);
      const int q0 = (tile % nq) * TQ;
      const int qb = i & 1;
      mbar_wait(&s.q_full[qb], (i >> 1) & 1);

      float o[D / 8][4], m[2] = {NEG2, NEG2}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

      // S of key tile j starts with P V of tile j - 1, so the softmax of
      // one tile runs while the tensor cores multiply the last one.
      {
        const uint32_t qs = smem_u32(s.q[qb]) + (warp / 4) * 64 * ROW;
        const uint32_t qts = s.qt_at(qb) + (warp / 4) * 64 * 2 * tail_cols<D>();
        // the softmax's scale: the mask scales masked tiles itself
        auto scores_scale = [&](float (&sc)[KEYS / 8][4], int k0) {
          if constexpr (MASKED)
            return mask_scores(sc, hv.valid, k0, t, scale_log2, lane);
          else
            return scale_log2;
        };
        uint32_t p[KEYS / 16][4];
        float al[2];
        int prev = it % RING;  // the stage whose P V is next
        {
          mbar_wait(&s.kv_full[prev], (it / RING) & 1);
          float sc[KEYS / 8][4];
          wgmma_fence();
          start_scores<KEYS, K_T, D>(sc, qs, smem_u32(s.k[prev]), qts, s.kt_at(prev));
          wgmma_wait<0>();
          fence_regs(sc);
          if (n_kt == 1 && lane == 0) mbar_arrive(&s.q_empty[qb]);
          softmax_scores<KEYS>(sc, m, l, al, scores_scale(sc, 0));
          rescale_pack<KEYS, D>(o, al, sc, p);
          ++it;
        }
        for (int j = 1; j < n_kt; ++j, ++it) {
          const int st = it % RING;
          mbar_wait(&s.kv_full[st], (it / RING) & 1);
          float sc[KEYS / 8][4];
          fence_regs(o);
          wgmma_fence();
          start_scores<KEYS, K_T, D>(sc, qs, smem_u32(s.k[st]), qts, s.kt_at(st));
          start_pv<KEYS, D>(o, p, smem_u32(s.v[prev]), s.vt_at(prev));
          wgmma_wait<1>();  // S ready; P V may still run
          fence_regs(sc);
          if (j == n_kt - 1 && lane == 0) mbar_arrive(&s.q_empty[qb]);
          softmax_scores<KEYS>(sc, m, l, al, scores_scale(sc, j * KEYS));
          wgmma_wait<0>();
          fence_regs(o);
          if (lane == 0) mbar_arrive(&s.kv_empty[prev]);
          rescale_pack<KEYS, D>(o, al, sc, p);
          prev = st;
        }
        fence_regs(o);
        wgmma_fence();
        start_pv<KEYS, D>(o, p, smem_u32(s.v[prev]), s.vt_at(prev));
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(&s.kv_empty[prev]);
      }

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = fmaxf(l[r], 1e-20f);
        inv[r] = 1.f / l[r];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + wr + g + 8 * r;
        if (row >= t) continue;
        bf16* orow = hv.o + (size_t)row * hv.ldo + 2 * tg;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
          *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
              __floats2bfloat162_rn(o[dt][2 * r] * inv[r], o[dt][2 * r + 1] * inv[r]);
        if (hv.lse != nullptr && tg == 0)
          hv.lse[row] = (m[r] == NEG2 ? NEG : m[r] * LN2) + logf(l[r]);
      }
    }
  }
}

// ------------------------------------------------------------------ host

// Launch fwd_bf16<Layout, NWG, KEYS, RING, K_T, MASKED, D> over n_heads
// heads of t tokens: `maps` builds the three tensor maps (fn(map_q, map_k,
// map_v) -> error) with the boxes the kernel reads; at hd 80 `tails` holds
// the tails' maps. The kernel's shared-memory limit and the SM count are
// looked up once a device, not at every launch.
template <class Layout, int NWG, int KEYS, int RING, bool K_T, bool MASKED, int D = HD,
          class Maps>
int launch_tile(const Maps& maps, const Layout& lay, int n_heads, int t, float scale,
                cudaStream_t stream, const TailMaps<tail_cols<D>()>& tails = {}) {
  CUtensorMap mq, mk, mv;
  int err = maps(&mq, &mk, &mv);
  if (err != 0) return err;
  static LaunchSetup setup;
  const auto kernel = fwd_bf16<Layout, NWG, KEYS, RING, K_T, MASKED, D>;
  constexpr int smem = (int)sizeof(Smem<NWG, KEYS, RING, D>) + 1024;  // + the alignment slack
  static_assert(smem <= 232448, "bf16 tile shared memory");
  int sms = 0;
  err = setup.sms(kernel, smem, &sms);
  if (err != 0) return err;
  const int n_tiles = n_heads * ((t + 64 * NWG - 1) / (64 * NWG));
  kernel<<<n_tiles < sms ? n_tiles : sms, tile_threads<NWG>(), smem, stream>>>(
      mq, mk, mv, lay, t, n_tiles, scale * LOG2E, tails);
  return (int)cudaGetLastError();
}

// The flash and packed kernels' launch: the tile wgs_of<D>() x BK x
// STAGES, masked; Q in boxes of bq_of<D>() rows (BQ at hd 64), K and V of
// BK; head dim D.
template <class Layout, int D = HD, class Maps>
int launch_bf16(const Maps& maps, const Layout& lay, int n_heads, int t, float scale,
                cudaStream_t stream, const TailMaps<tail_cols<D>()>& tails = {}) {
  return launch_tile<Layout, wgs_of<D>(), BK, STAGES, false, true, D>(maps, lay, n_heads, t,
                                                                      scale, stream, tails);
}

// ------------------------------------------ f32 on TF32 wgmma: shared blocks
//
// The f32 forward below and the f32 flash backward (flash_attention_bwd.cu)
// run every product as three TF32 products (hopper.cuh: small.big +
// big.small + big.big into one f32 sum). TMA brings f32 tiles in two
// 32-column boxes (128-byte swizzled halves, f32_at); an operand read from
// shared memory is split into TF32 big and small copies by the consumers,
// one read as register A is split as it is loaded (load_a_f32, tf32_a_frag).
// wgmma reads TF32 K-major only, so an operand needed MN-major gets a
// transposed copy with its k rows in tf32_perm order.

constexpr int TF32_TERMS = 3;  // TF32 products an f32 product

// 32-column parts of an f32 row of D columns in shared memory (3 at hd 80:
// TMA zero-fills columns 80-95 of the last, which no product reads).
template <int D>
__host__ __device__ constexpr int f32_parts() {
  return (D + 31) / 32;
}

template <class Shared>
__device__ __forceinline__ Shared& aligned_smem(char* raw) {
  return *reinterpret_cast<Shared*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// One (ROWS x D) f32 box of `map` at column `col`, row `row`, outer index
// z into `dst`, as 32-column loads into its parts (f32_at; two at hd 64),
// completing on `bar`.
template <int ROWS, int D = HD>
__device__ __forceinline__ void tma_load_f32(float* dst, const CUtensorMap* map, uint64_t* bar,
                                             int col, int row, int z) {
#pragma unroll
  for (int p = 0; p < f32_parts<D>(); ++p)
    tma_load_3d(dst + p * ROWS * 32, map, bar, col + 32 * p, row, z);
}

__device__ __forceinline__ void split4(float4 x, float4& b, float4& s) {
  tf32_split(x.x, b.x, s.x);
  tf32_split(x.y, b.y, s.y);
  tf32_split(x.z, b.z, s.z);
  tf32_split(x.w, b.w, s.w);
}

// Rows r0 .. r0 + 63 of an f32 tile of ROWS rows, both halves: TF32 big in
// place, small into `small` at the same index. The 128 threads of one
// warpgroup (t128 its thread).
template <int ROWS>
__device__ __forceinline__ void split_rows(float* big, float* small, int r0, int t128) {
#pragma unroll 2
  for (int i = t128; i < 64 * HD / 4; i += 128) {
    const int at = (i >> 9) * ROWS * 32 + r0 * 32 + (i & 511) * 4;
    float4 b, s;
    split4(*reinterpret_cast<const float4*>(big + at), b, s);
    *reinterpret_cast<float4*>(big + at) = b;
    *reinterpret_cast<float4*>(small + at) = s;
  }
}

// A raw 32-row f32 stage (TMA's layout) into TF32 big and small copies in
// the same layout (unless b is null) and, unless tb is null, into a
// transposed [dim][row] tile of D dims with the rows in tf32_perm order, big
// and small: row `lane` and columns 8 warp .. 8 warp + 7 a thread, warp 0 ..
// D / 8 - 1 (a warp's 32 lanes reach 32 distinct banks in every store).
template <int D = HD>
__device__ __forceinline__ void split_stage(const float* raw, float* b, float* s, float* tb,
                                            float* ts, int warp, int lane) {
  const int col = tf32_perm(lane);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = 8 * warp + 4 * h, at = f32_at<32>(lane, c);
    float4 xb, xs;
    split4(*reinterpret_cast<const float4*>(raw + at), xb, xs);
    if (b != nullptr) {
      *reinterpret_cast<float4*>(b + at) = xb;
      *reinterpret_cast<float4*>(s + at) = xs;
    }
    if (tb != nullptr) {
      const float eb[4] = {xb.x, xb.y, xb.z, xb.w}, es[4] = {xs.x, xs.y, xs.z, xs.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tb[f32_at<D>(c + e, col)] = eb[e];
        ts[f32_at<D>(c + e, col)] = es[e];
      }
    }
  }
}

// Start D (64 x 32) = A B^T over the 64 dims, every k step as three TF32
// products: A the warpgroup's 64 rows (shared addresses ab, as of its first
// row, big and small) of a ROWS-row tile, B a 32-row tile (bb, bs), both
// K-major. One wgmma group, which the caller commits.
template <int ROWS>
__device__ __forceinline__ void product_ss(float (&d)[4][4], uint32_t ab, uint32_t as,
                                           uint32_t bb, uint32_t bs) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    wgmma_tf32_ss_n32(d, desc_f32<ROWS>(as, kk), desc_f32<32>(bb, kk), kk);
    wgmma_tf32_ss_n32(d, desc_f32<ROWS>(ab, kk), desc_f32<32>(bs, kk), 1);
    wgmma_tf32_ss_n32(d, desc_f32<ROWS>(ab, kk), desc_f32<32>(bb, kk), 1);
  }
}

// The order of a register-A product's TF32 products. The tensor cores add
// each product into the f32 accumulator at its magnitude, so every
// instruction after the sum has grown costs up to about an f32 ulp of it.
// BY_STEP (the backward's): small.big, big.small, big.big for each k step.
// SMALL_FIRST: the small products of every k step first, then the big ones,
// so one instruction in three adds at the sum's full magnitude.
enum Tf32Order { BY_STEP, SMALL_FIRST };

// Start D (64 x N) {=, +=} A B over 32 k, every k step as three TF32
// products: A from registers in tf32_a_frag's order (big ab, small as), B an
// [N][32] K-major tile with its k rows in tf32_perm order (bb, bs);
// scale_d = 0 overwrites D. N = 64, or 80 (hd 80: an n64 product on rows
// 0-63 of B and an n16 on rows 64-79, into D's last two 8-column groups).
// One group.
template <Tf32Order ORDER = BY_STEP, int N = HD>
__device__ __forceinline__ void product_rs(float (&d)[N / 8][4], const float (&ab)[4][4],
                                           const float (&as)[4][4], uint32_t bb, uint32_t bs,
                                           int scale_d = 1) {
  constexpr int TAIL = tail_cols<N>();
  constexpr uint32_t TAIL_AT = HD * 128;  // bytes to B's row 64
  float (&dh)[HD / 8][4] = *reinterpret_cast<float (*)[HD / 8][4]>(&d[0]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_tf32_rs_n64(dh, as[kk], desc_f32<64>(bb, kk), kk == 0 ? scale_d : 1);
    wgmma_tf32_rs_n64(dh, ab[kk], desc_f32<64>(bs, kk), 1);
    if constexpr (ORDER == BY_STEP) wgmma_tf32_rs_n64(dh, ab[kk], desc_f32<64>(bb, kk), 1);
    if constexpr (TAIL > 0) {
      float (&dt)[TAIL / 8][4] = *reinterpret_cast<float (*)[TAIL / 8][4]>(&d[HD / 8]);
      wgmma_tf32_rs_n16(dt, as[kk], desc_f32<64>(bb + TAIL_AT, kk), kk == 0 ? scale_d : 1);
      wgmma_tf32_rs_n16(dt, ab[kk], desc_f32<64>(bs + TAIL_AT, kk), 1);
      if constexpr (ORDER == BY_STEP)
        wgmma_tf32_rs_n16(dt, ab[kk], desc_f32<64>(bb + TAIL_AT, kk), 1);
    }
  }
  if constexpr (ORDER == SMALL_FIRST) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_tf32_rs_n64(dh, ab[kk], desc_f32<64>(bb, kk), 1);
      if constexpr (TAIL > 0) {
        float (&dt)[TAIL / 8][4] = *reinterpret_cast<float (*)[TAIL / 8][4]>(&d[HD / 8]);
        wgmma_tf32_rs_n16(dt, ab[kk], desc_f32<64>(bb + TAIL_AT, kk), 1);
      }
    }
  }
}

// Start D (64 x 32) = A B^T over the K dims (64, or 80 at hd 80), every k
// step as three TF32 products: A from registers (load_a_f32's: big ab,
// small as), B a 32-row K-major tile (bb, bs) in 32-column parts. One group.
template <Tf32Order ORDER = BY_STEP, int K = HD>
__device__ __forceinline__ void product_rs_n32(float (&d)[4][4], const float (&ab)[K / 8][4],
                                               const float (&as)[K / 8][4], uint32_t bb,
                                               uint32_t bs) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    wgmma_tf32_rs_n32(d, as[kk], desc_f32<32>(bb, kk), kk);
    wgmma_tf32_rs_n32(d, ab[kk], desc_f32<32>(bs, kk), 1);
    if constexpr (ORDER == BY_STEP) wgmma_tf32_rs_n32(d, ab[kk], desc_f32<32>(bb, kk), 1);
  }
  if constexpr (ORDER == SMALL_FIRST) {
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk) wgmma_tf32_rs_n32(d, ab[kk], desc_f32<32>(bb, kk), 1);
  }
}

// ---------------------------------------- f32 forward on TF32 wgmma, 3xTF32
//
// The f32 flash and packed kernels' tile, on the f32 backward's dq kernel
// structure without dP. A persistent grid walks (head, 128-query tile)
// pairs, head-major. Two consumer warpgroups own 64 query rows each and
// hold them as split register A fragments (64 registers a thread), so Q is
// free as soon as it is in registers and the next tile's Q is loaded under
// this one. The producer warpgroup loads Q and raw f32 K/V in 32-key
// stages by TMA (one thread) into a ring of F32_STAGES that only it reads,
// and its four warps split each stage: K into TF32 big and small [key][dim]
// (K-major for S = Q K^T as it stands), V into a transposed [dim][key]
// copy, big and small (O += P V needs V^T K-major: TF32 wgmma has no
// transpose bit), into one of f32_splits() buffers handed to the consumers by
// full/empty mbarriers. So the split runs beside the consumers' products
// and softmax, and the consumer warpgroups never wait for each other.
//
// Per stage j, a consumer warpgroup (the bf16 tile's order): start S_j = Q
// K_j^T (register A) and P_{j-1} V_{j-1} (register A, into its own
// accumulator) as two groups; wait for S_j; mask and online softmax in log2
// units (p = exp2(s scale log2e - m), -1e9 on invalid keys, -inf beyond t);
// wait for P V and free stage j - 1's buffer; O = (O + P V) alpha; P_j from
// its accumulator registers as split A fragments (tf32_a_frag). The
// products run SMALL_FIRST and P V into a fresh accumulator, so the tensor
// cores' adds at full magnitude are few (see Tf32Order). The end: l_safe =
// max(l, 1e-20), O / l_safe, lse = m ln 2 + log(l_safe) (exactly -1e9 +
// log(t) on a row that saw only masked keys); query rows beyond t are not
// written.
//
// Head dim 80 (D): rows of Q, K and the raw stages are three 32-column parts
// in shared memory, the last one's columns 80-95 zero from TMA and never
// read; S takes 10 k steps, P V an n64 and an n16 product on the 80-row V^T
// (product_rs). Shared memory holds two split stages at hd 80 (three at hd
// 64): 210 KB.

constexpr int F32_WGS = 2;            // consumer warpgroups, 64 query rows each
constexpr int F32_BQ = 64 * F32_WGS;  // query rows of a tile
constexpr int F32_BK = 32;            // keys of a K/V stage: one lane a key in the split
constexpr int F32_STAGES = 3;         // raw K/V stages in the producer's TMA ring
// split stages handed to the consumers: three, two at hd 80 (shared memory)
template <int D>
__host__ __device__ constexpr int f32_splits() {
  return D == HD ? 3 : 2;
}
constexpr int F32_CONSUMERS = 4 * F32_WGS;
constexpr int F32_THREADS = tile_threads<F32_WGS>();
constexpr int F32_SPLIT_BAR = 1;      // named barrier of the producer warpgroup
// Registers a thread: R0 at launch, CREGS for a consumer, PREGS for the
// producer warpgroup, which splits; setmaxnreg.inc draws only on what the
// producer gave back. 224 and 56 were the fastest of those timed (232 and
// 40 made ptxas spill in the split or made it slower).
constexpr int F32_R0 = (65536 / F32_THREADS) & ~7;
constexpr int F32_CREGS = 224;
constexpr int F32_PREGS = 56;
static_assert(F32_WGS * 128 * (F32_CREGS - F32_R0) <= 128 * (F32_R0 - F32_PREGS),
              "consumer registers");

// One split stage: K [key][dim] and V^T [dim][key in tf32_perm order],
// TF32 big and small, each 1024-byte aligned; D the head dim.
template <int D>
struct alignas(1024) F32Split {
  float kb[F32_BK * 32 * f32_parts<D>()], ks[F32_BK * 32 * f32_parts<D>()];
  float vtb[D * F32_BK], vts[D * F32_BK];
};

template <int D>
struct alignas(1024) F32Shared {
  static constexpr int SPLITS = f32_splits<D>(), COLS = 32 * f32_parts<D>();
  float q[F32_BQ * COLS];  // the tile's Q, until held as register A
  F32Split<D> split[SPLITS];
  float raw_k[F32_STAGES][F32_BK * COLS], raw_v[F32_STAGES][F32_BK * COLS];  // the TMA ring
  uint64_t q_full, q_empty, raw_full[F32_STAGES], split_full[SPLITS], split_empty[SPLITS];
};
template <int D>
constexpr int f32_smem() {
  return (int)sizeof(F32Shared<D>) + 1024;  // + the alignment slack
}
static_assert(f32_smem<HD>() <= 232448 && f32_smem<HD + 16>() <= 232448,
              "f32 tile shared memory");

// The mask of keys k0 .. k0 + 31 on this thread's raw scores of a stage
// (columns 8j + 2tg + e%2), as mask_scores does it for a bf16 tile: one
// ballot word a warp. A stage whose keys are all valid is left as it is
// (returns scale_log2); else every score is scaled here, -1e9 (log2 units)
// where the valid byte is 0 and -inf beyond t (returns 1).
__device__ __forceinline__ float mask_stage(float (&s)[F32_BK / 8][4], const uint8_t* valid,
                                            int k0, int t, float scale_log2, int lane) {
  if (valid == nullptr && k0 + F32_BK <= t) return scale_log2;
  const int key = k0 + lane;
  const uint32_t w =
      __ballot_sync(0xffffffffu, key < t && (valid == nullptr || __ldg(valid + key) != 0));
  if (w == 0xffffffffu) return scale_log2;
  const int tg = lane & 3;
#pragma unroll
  for (int j = 0; j < F32_BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * tg + (e & 1);
      s[j][e] = k0 + c >= t ? -INFINITY : ((w >> c) & 1u) ? s[j][e] * scale_log2 : NEG2;
    }
  return 1.f;
}

// O plus the last stage's P V (pv), times alpha, and p as split TF32 A
// fragments of this stage's P V (tf32_a_frag).
template <int D>
__device__ __forceinline__ void rescale_split_p(float (&o)[D / 8][4], const float (&pv)[D / 8][4],
                                                const float (&al)[2],
                                                const float (&sa)[F32_BK / 8][4],
                                                float (&pb)[F32_BK / 8][4],
                                                float (&ps)[F32_BK / 8][4]) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = (o[dt][e] + pv[dt][e]) * al[e / 2];
#pragma unroll
  for (int jj = 0; jj < F32_BK / 8; ++jj) tf32_a_frag(sa[jj], pb[jj], ps[jj]);
}

// The producer's load of Q for this CTA's n-th tile, `tile`, once the
// consumers hold the last one in registers.
template <class Layout, int D>
__device__ __forceinline__ void load_q_f32(F32Shared<D>& s, const CUtensorMap* map_q,
                                           const Layout& lay, int tile, int nq, int n) {
  const HeadViewOf<float> hv = lay.head(tile / nq);
  mbar_wait(&s.q_empty, (n & 1) ^ 1);
  mbar_expect_tx(&s.q_full, F32_BQ * F32Shared<D>::COLS * 4);
  tma_load_f32<F32_BQ, D>(s.q, map_q, &s.q_full, hv.qcol, (tile % nq) * F32_BQ, hv.z);
}

// Raw K/V of this CTA's stage n into its ring slot.
template <class Layout, int D>
__device__ __forceinline__ void load_stage_f32(F32Shared<D>& s, const CUtensorMap* map_k,
                                               const CUtensorMap* map_v, const Layout& lay,
                                               uint32_t n, int n_kt, int nq) {
  const int tile = blockIdx.x + (int)(n / n_kt) * gridDim.x, j = n % n_kt;
  const HeadViewOf<float> hv = lay.head(tile / nq);
  const int st = n % F32_STAGES;
  mbar_expect_tx(&s.raw_full[st], 2 * F32_BK * F32Shared<D>::COLS * 4);
  tma_load_f32<F32_BK, D>(s.raw_k[st], map_k, &s.raw_full[st], hv.kcol, j * F32_BK, hv.z);
  tma_load_f32<F32_BK, D>(s.raw_v[st], map_v, &s.raw_full[st], hv.vcol, j * F32_BK, hv.z);
}

// The kernel. Layout maps a head index to its HeadViewOf<float>; map_q
// boxes F32_BQ rows, map_k and map_v F32_BK rows, 32 columns each; D the
// head dim, 64 or 80.
template <class Layout, int D = HD>
__global__ void __launch_bounds__(F32_THREADS, 1)
fwd_f32(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
        const __grid_constant__ CUtensorMap map_v, const Layout lay, int t, int n_tiles,
        float scale_log2) {
  constexpr int SPLITS = F32Shared<D>::SPLITS;
  extern __shared__ __align__(128) char smem_dyn[];
  F32Shared<D>& s = aligned_smem<F32Shared<D>>(smem_dyn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nq = (t + F32_BQ - 1) / F32_BQ, n_kt = (t + F32_BK - 1) / F32_BK;
  const int cta_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const uint32_t total = (uint32_t)cta_tiles * n_kt;

  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
    mbar_init(&s.q_empty, F32_CONSUMERS);
    for (int i = 0; i < F32_STAGES; ++i) mbar_init(&s.raw_full[i], 1);
    for (int i = 0; i < SPLITS; ++i) {
      mbar_init(&s.split_full[i], 4);  // the producer warpgroup's warps
      mbar_init(&s.split_empty[i], F32_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= F32_CONSUMERS) {  // ------------- producer warpgroup: TMA and the split
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(F32_PREGS));
    const int pw = warp - F32_CONSUMERS, pt = threadIdx.x - 32 * F32_CONSUMERS;
    if (pt == 0) {  // Q of the first tile, the ring's first stages
      load_q_f32(s, &map_q, lay, blockIdx.x, nq, 0);
      for (uint32_t n = 0; n < F32_STAGES && n < total; ++n)
        load_stage_f32(s, &map_k, &map_v, lay, n, n_kt, nq);
    }
    for (uint32_t n = 0; n < total; ++n) {
      const int st = n % F32_STAGES;
      F32Split<D>& sp = s.split[n % SPLITS];
      if (pt == 0) {  // the next tile's Q as this tile's last stage is split
        const int ti = n / n_kt;
        if ((int)(n % n_kt) == n_kt - 1 && ti + 1 < cta_tiles)
          load_q_f32(s, &map_q, lay, blockIdx.x + (ti + 1) * gridDim.x, nq, ti + 1);
      }
      mbar_wait(&s.raw_full[st], (n / F32_STAGES) & 1);
      mbar_wait(&s.split_empty[n % SPLITS], ((n / SPLITS) & 1) ^ 1);
#pragma unroll
      for (int h = 0; h < (D / 8 + 3) / 4; ++h) {  // 8 dims a warp: twice, or 3 times at hd 80
        const int w = pw + 4 * h;
        if (D % 32 == 0 || w < D / 8) {
          split_stage<D>(s.raw_k[st], sp.kb, sp.ks, nullptr, nullptr, w, lane);
          split_stage<D>(s.raw_v[st], nullptr, nullptr, sp.vtb, sp.vts, w, lane);
        }
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.split_full[n % SPLITS]);
      bar_sync(F32_SPLIT_BAR, 128);  // the raw slot is read: refill it
      if (pt == 0 && n + F32_STAGES < total)
        load_stage_f32(s, &map_k, &map_v, lay, n + F32_STAGES, n_kt, nq);
    }
  } else {  // -------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(F32_CREGS));
    const int g = lane / 4, tg = lane % 4;
    uint32_t n = 0;
    int i = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const HeadViewOf<float> hv = lay.head(tile / nq);
      const int q0 = (tile % nq) * F32_BQ;
      // this warp's Q rows as register A, split; then Q is free
      mbar_wait(&s.q_full, i & 1);
      float qfb[D / 8][4], qfs[D / 8][4];
      load_a_f32<F32_BQ, D>(s.q, 16 * warp + g, tg, qfb, qfs);
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.q_empty);

      // O, and the last stage's P V in its own accumulator, added to O in
      // f32 (so the tensor cores add at a stage's magnitude, not O's)
      float o[D / 8][4], pv[D / 8][4], m[2] = {NEG2, NEG2}, l[2] = {0.f, 0.f};
      float pb[F32_BK / 8][4], ps[F32_BK / 8][4];  // P of the last stage, split
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] = pv[dt][e] = 0.f;
      {
        const F32Split<D>& cur = s.split[n % SPLITS];
        mbar_wait(&s.split_full[n % SPLITS], (n / SPLITS) & 1);
        float sa[F32_BK / 8][4], al[2];
        wgmma_fence();
        product_rs_n32<SMALL_FIRST, D>(sa, qfb, qfs, smem_u32(cur.kb), smem_u32(cur.ks));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sa);
        const float c = mask_stage(sa, hv.valid, 0, t, scale_log2, lane);
        softmax_scores<F32_BK>(sa, m, l, al, c);
        rescale_split_p<D>(o, pv, al, sa, pb, ps);
        ++n;
      }
      for (int j = 1; j < n_kt; ++j, ++n) {
        const F32Split<D>& cur = s.split[n % SPLITS];
        const F32Split<D>& prev = s.split[(n - 1) % SPLITS];
        mbar_wait(&s.split_full[n % SPLITS], (n / SPLITS) & 1);
        float sa[F32_BK / 8][4], al[2];
        fence_regs(pv);
        wgmma_fence();
        product_rs_n32<SMALL_FIRST, D>(sa, qfb, qfs, smem_u32(cur.kb), smem_u32(cur.ks));
        wgmma_commit();
        product_rs<SMALL_FIRST, D>(pv, pb, ps, smem_u32(prev.vtb), smem_u32(prev.vts), 0);
        wgmma_commit();
        wgmma_wait<1>();  // S ready; P V may still run
        fence_regs(sa);
        const float c = mask_stage(sa, hv.valid, j * F32_BK, t, scale_log2, lane);
        softmax_scores<F32_BK>(sa, m, l, al, c);
        wgmma_wait<0>();
        fence_regs(pv);
        fence_regs(pb);
        fence_regs(ps);
        __syncwarp();
        if (lane == 0) mbar_arrive(&s.split_empty[(n - 1) % SPLITS]);  // stage j - 1 read
        rescale_split_p<D>(o, pv, al, sa, pb, ps);
      }
      {
        const F32Split<D>& last = s.split[(n - 1) % SPLITS];
        fence_regs(pv);
        wgmma_fence();
        product_rs<SMALL_FIRST, D>(pv, pb, ps, smem_u32(last.vtb), smem_u32(last.vts), 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pv);
        fence_regs(qfb);
        fence_regs(qfs);
        __syncwarp();
        if (lane == 0) mbar_arrive(&s.split_empty[(n - 1) % SPLITS]);
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[dt][e] += pv[dt][e];
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = fmaxf(l[r], 1e-20f);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + 16 * warp + g + 8 * r;
        if (row >= t) continue;
        float* orow = hv.o + (size_t)row * hv.ldo + 2 * tg;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
          *reinterpret_cast<float2*>(orow + dt * 8) =
              make_float2(o[dt][2 * r] / l[r], o[dt][2 * r + 1] / l[r]);
        if (hv.lse != nullptr && tg == 0)
          hv.lse[row] = (m[r] == NEG2 ? NEG : m[r] * LN2) + logf(l[r]);
      }
    }
  }
}

// Launch fwd_f32<Layout, D> over n_heads heads of t tokens: `maps` builds
// the three f32 tensor maps (fn(map_q, map_k, map_v) -> error), Q in boxes of
// F32_BQ rows, K and V of F32_BK.
template <class Layout, int D = HD, class Maps>
int launch_f32(const Maps& maps, const Layout& lay, int n_heads, int t, float scale,
               cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = maps(&mq, &mk, &mv);
  if (err != 0) return err;
  static LaunchSetup setup;
  const auto kernel = fwd_f32<Layout, D>;
  int sms = 0;
  err = setup.sms(kernel, f32_smem<D>(), &sms);
  if (err != 0) return err;
  const int n_tiles = n_heads * ((t + F32_BQ - 1) / F32_BQ);
  kernel<<<n_tiles < sms ? n_tiles : sms, F32_THREADS, f32_smem<D>(), stream>>>(
      mq, mk, mv, lay, t, n_tiles, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace hopper

}  // namespace attn_tile
