// The blockwise attention forward tiles of the port's flash kernels:
// flash_attention_fwd.cu (head-major (B*H, T, 64)) and
// flash_attention_packed.cu (token-major packed qkv stripes), and of
// splash_attention.cu. A caller
// hands one head to a tile as base pointers and row strides (f32) or as
// tensor-map coordinates and output rows (bf16), so the layout lives only
// in the kernel that computes them.
//
// Both stream K/V tiles past a block of query rows and keep the running
// row max m and sum l in f32 registers (online softmax), so the (T, T)
// matrix never reaches device memory. Keys whose valid byte is 0 get -1e9
// on the f32 scores (the JAX kernels' mask: exp underflows to 0 once a
// valid key has been seen); keys beyond t are excluded, so a row whose keys
// are all invalid is the average of v over the t keys, as in JAX. Final:
// l_safe = max(l, 1e-20), O = acc / l_safe and, where an lse row is given,
// lse = m + log(l_safe).
//
//   f32 tile:  64 queries, 64-key tiles, 256 threads; a 16x16 thread grid,
//              each thread owns a 4x4 tile of S and a 4x16 strip of O; FMA
//              from padded shared memory (no TF32). q is multiplied by the
//              scale as it is loaded; keys beyond t read as zero rows and
//              get -inf.
//   bf16 tile: Hopper's TMA, mbarriers and wgmma (namespace hopper below,
//              on the building blocks of hopper.cuh), also the splash
//              kernel's (splash_attention.cu: no mask, other tile shapes,
//              K optionally seq-minor).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
  float fill[F32_BK];  // 0: keep the key's score; else the score it gets
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
      s.fill[tid] = gk >= t ? -INFINITY : (valid == nullptr || valid[gk]) ? 0.f : NEG;
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
        const float fill = s.fill[tx + 16 * i];
        if (fill != 0.f) sc[a][i] = fill;
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

template <int NWG, int KEYS, int RING>
struct Smem {
  bf16 q[2][64 * NWG * HD];  // every tile 1024-byte aligned: the swizzle atom
  bf16 k[RING][KEYS * HD];
  bf16 v[RING][KEYS * HD];
  uint64_t q_full[2], q_empty[2], kv_full[RING], kv_empty[RING];
};

// Where one head lives: tensor-map coordinates (outer index, column of q, k
// and v), its output rows, its lse row (null: not written) and its key
// bytes (null: all valid).
struct HeadView {
  int z, qcol, kcol, vcol;
  bf16* o;
  int ldo;
  float* lse;
  const uint8_t* valid;
};

// Start S (this warpgroup's 64 rows x KEYS keys) = Q K^T on wgmma as one
// group; qb and kb are the shared addresses of the warpgroup's Q rows and of
// the K tile. K is [key][dim] (K-major: 16 dims = 32 bytes along the
// swizzled row) or, with K_T, [dim][key] in 64-key swizzled tiles 8 KB
// apart (MN-major through the transpose bit: 16 dims = 16 rows = 2048
// bytes, the next 64 keys at the leading offset). The caller fences and
// waits.
template <int KEYS, bool K_T = false>
__device__ __forceinline__ void start_scores(float (&s)[KEYS / 8][4], uint32_t qb, uint32_t kb) {
  const uint64_t dq = desc_sw128(qb, 16), dk = desc_sw128(kb, K_T ? 64 * ROW : 16);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if constexpr (KEYS == 128)
      wgmma_ss_n128<K_T>(s, dq + 2 * kk, dk + (K_T ? 128 : 2) * kk, kk);
    else
      wgmma_ss_n64<K_T>(s, dq + 2 * kk, dk + (K_T ? 128 : 2) * kk, kk);
  }
  wgmma_commit();
}

// Start O += P V on wgmma as one group: P from registers, V MN-major
// through the transpose bit.
template <int KEYS>
__device__ __forceinline__ void start_pv(float (&o)[HD / 8][4], const uint32_t (&p)[KEYS / 16][4],
                                         uint32_t vb) {
  const uint64_t dv = desc_sw128(vb, 1024);
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk)  // 16 keys = 2048 bytes
    wgmma_rs_n64_tb(o, p[kk], dv + 128 * kk);
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
template <int KEYS>
__device__ __forceinline__ void rescale_pack(float (&o)[HD / 8][4], const float (&al)[2],
                                             const float (&s)[KEYS / 8][4],
                                             uint32_t (&p)[KEYS / 16][4]) {
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
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
// each.
template <class Layout, int NWG, int KEYS, int RING, bool K_T, bool MASKED>
__global__ void __launch_bounds__(tile_threads<NWG>(), 1)
fwd_bf16(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
         const __grid_constant__ CUtensorMap map_v, const Layout lay, int t, int n_tiles,
         float scale_log2) {
  constexpr int TQ = 64 * NWG;        // query rows of a tile
  constexpr int CONSUMERS = 4 * NWG;  // consumer warps
  // Registers a thread: R0 at launch (the launch bounds' share, in 8s),
  // CREGS for a consumer, 24 for the producer. setmaxnreg.inc draws only on
  // what the producer warpgroup gave back, and waits for it forever.
  constexpr int R0 = (65536 / tile_threads<NWG>()) & ~7;
  constexpr int CREGS = R0 < 160 ? 160 : R0;
  static_assert(NWG * 128 * (CREGS - R0) <= 128 * (R0 - 24), "consumer registers");
  typedef Smem<NWG, KEYS, RING> Shared;
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
        mbar_expect_tx(&s.q_full[qb], TQ * ROW);
        tma_load_3d(s.q[qb], &map_q, &s.q_full[qb], hv.qcol, (tile % nq) * TQ, hv.z);
        for (int j = 0; j < n_kt; ++j, ++it) {
          const int st = it % RING;
          mbar_wait(&s.kv_empty[st], ((it / RING) & 1) ^ 1);
          mbar_expect_tx(&s.kv_full[st], 2 * KEYS * ROW);
          if constexpr (K_T) {
#pragma unroll
            for (int h = 0; h < KEYS / 64; ++h)
              tma_load_3d(s.k[st] + h * 64 * HD, &map_k, &s.kv_full[st], j * KEYS + h * 64, 0,
                          hv.z);
          } else {
            tma_load_3d(s.k[st], &map_k, &s.kv_full[st], hv.kcol, j * KEYS, hv.z);
          }
          tma_load_3d(s.v[st], &map_v, &s.kv_full[st], hv.vcol, j * KEYS, hv.z);
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

      float o[HD / 8][4], m[2] = {NEG2, NEG2}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

      // S of key tile j starts with P V of tile j - 1, so the softmax of
      // one tile runs while the tensor cores multiply the last one.
      {
        const uint32_t qs = smem_u32(s.q[qb]) + (warp / 4) * 64 * ROW;
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
          start_scores<KEYS, K_T>(sc, qs, smem_u32(s.k[prev]));
          wgmma_wait<0>();
          fence_regs(sc);
          if (n_kt == 1 && lane == 0) mbar_arrive(&s.q_empty[qb]);
          softmax_scores<KEYS>(sc, m, l, al, scores_scale(sc, 0));
          rescale_pack<KEYS>(o, al, sc, p);
          ++it;
        }
        for (int j = 1; j < n_kt; ++j, ++it) {
          const int st = it % RING;
          mbar_wait(&s.kv_full[st], (it / RING) & 1);
          float sc[KEYS / 8][4];
          fence_regs(o);
          wgmma_fence();
          start_scores<KEYS, K_T>(sc, qs, smem_u32(s.k[st]));
          start_pv<KEYS>(o, p, smem_u32(s.v[prev]));
          wgmma_wait<1>();  // S ready; P V may still run
          fence_regs(sc);
          if (j == n_kt - 1 && lane == 0) mbar_arrive(&s.q_empty[qb]);
          softmax_scores<KEYS>(sc, m, l, al, scores_scale(sc, j * KEYS));
          wgmma_wait<0>();
          fence_regs(o);
          if (lane == 0) mbar_arrive(&s.kv_empty[prev]);
          rescale_pack<KEYS>(o, al, sc, p);
          prev = st;
        }
        fence_regs(o);
        wgmma_fence();
        start_pv<KEYS>(o, p, smem_u32(s.v[prev]));
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
        for (int dt = 0; dt < HD / 8; ++dt)
          *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
              __floats2bfloat162_rn(o[dt][2 * r] * inv[r], o[dt][2 * r + 1] * inv[r]);
        if (hv.lse != nullptr && tg == 0)
          hv.lse[row] = (m[r] == NEG2 ? NEG : m[r] * LN2) + logf(l[r]);
      }
    }
  }
}

// ------------------------------------------------------------------ host

// Launch fwd_bf16<Layout, NWG, KEYS, RING, K_T, MASKED> over n_heads heads
// of t tokens: `maps` builds the three tensor maps (fn(map_q, map_k, map_v)
// -> error) with the boxes the kernel reads. The kernel's shared-memory limit
// and the SM count are looked up once a device, not at every launch.
template <class Layout, int NWG, int KEYS, int RING, bool K_T, bool MASKED, class Maps>
int launch_tile(const Maps& maps, const Layout& lay, int n_heads, int t, float scale,
                cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = maps(&mq, &mk, &mv);
  if (err != 0) return err;
  static LaunchSetup setup;
  const auto kernel = fwd_bf16<Layout, NWG, KEYS, RING, K_T, MASKED>;
  constexpr int smem = (int)sizeof(Smem<NWG, KEYS, RING>) + 1024;  // + the alignment slack
  int sms = 0;
  err = setup.sms(kernel, smem, &sms);
  if (err != 0) return err;
  const int n_tiles = n_heads * ((t + 64 * NWG - 1) / (64 * NWG));
  kernel<<<n_tiles < sms ? n_tiles : sms, tile_threads<NWG>(), smem, stream>>>(
      mq, mk, mv, lay, t, n_tiles, scale * LOG2E);
  return (int)cudaGetLastError();
}

// The flash and packed kernels' launch: the tile WGS x BK x STAGES, masked;
// Q in boxes of BQ rows, K and V of BK.
template <class Layout, class Maps>
int launch_bf16(const Maps& maps, const Layout& lay, int n_heads, int t, float scale,
                cudaStream_t stream) {
  return launch_tile<Layout, WGS, BK, STAGES, false, true>(maps, lay, n_heads, t, scale, stream);
}

}  // namespace hopper

}  // namespace attn_tile
