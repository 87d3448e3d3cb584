// Fused LayerNorm -> fc1 -> tanh-GELU forward, bf16, for Hopper (sm_90a).
//
// Replaces the TPU kernel vipers/ops/fused_mlp.py::_kernel (driven by
// _fused_fwd_impl):  out = gelu_tanh(bf16(xhat) @ W_eff + b_eff), where
// xhat = (x - mean) * rsqrt(var + eps) with var = max(E[x^2] - mean^2, 0)
// in f32 and no affine. The LayerNorm affine is folded into W_eff / b_eff
// in f32 by the caller (vipers_torch/ops/fused_mlp.py), as the JAX wrapper
// does, so the normalized rows never exist in device memory.
//
// Bound on the card: at the ViT-S/16 LOST shape (M = 128*896, D = 384,
// F = 1536) the product is 135 GFLOP on 441 MB of I/O (352 MB of it the
// output): 0.137 ms of bf16 tensor-core time against 0.132 ms of bytes. The
// two bounds nearly coincide, so the product has to overlap the epilogue
// (bias, tanh-GELU on 176M elements) and the output's stores.
//
// Design: a persistent grid of at most one CTA per SM walks row tiles of
// ROWS = 64 * NW rows; for each it walks every column tile of BN = 128
// output columns (the column tile inner), so one row tile's xhat is made
// once and feeds all F / BN column tiles. Warpgroups:
//   * NW consumers, each owning a 64-row slab. A slab's x rows arrive by TMA
//     (128-byte swizzle) straight into the K-major layout that the wgmma
//     descriptor reads, D / 64 swizzle atoms of 64 columns; the warpgroup
//     computes each row's statistics in f32 from shared memory and
//     normalizes in place, rounding xhat to bf16 (the swizzle permutes
//     16-byte chunks within a row, which an elementwise pass does not see),
//     then fences the async proxy. Per column tile it runs wgmma
//     m64n128k16 over D in 64-deep chunks of W_eff^T, f32 accumulators in
//     registers, handing each chunk's stage back once its product is done
//     (the other consumer's products fill the tensor cores meanwhile), and
//     writes the tile to an f32 staging buffer (the 16-byte chunks of each
//     512-byte row XOR-swizzled by the row, so neither side conflicts on
//     banks).
//   * an epilogue warpgroup for each consumer (STAGED instances): per
//     staged tile it adds b_eff, applies tanh-GELU in f32 and writes bf16
//     with 16-byte stores, two full 256-byte rows a warp, while its
//     consumer multiplies the next column tile. So the epilogue overlaps
//     the tensor cores.
//   * one producer thread: the chunks of W_eff^T (F, D), K-major, 128 rows x
//     64 columns (16 KB) by TMA into a ring of stages with full / empty
//     mbarriers, the same pattern as the attention tiles' K ring. W_eff
//     (1.18 MB at ViT-S) stays resident in L2.
// Instances (the host picks by D, largest first that fits 227 KB):
// NW = 2 with 3-4 stages (D <= 448: the ViT-S main path); NW = 1 with 3-4
// stages (D <= 1152: vit_b, vit_l); NW = 1 without the staging and
// epilogue warpgroup, the consumer applying the epilogue from its
// registers, 1-4 stages (D <= 1664; vit_h's 1280 gets 4). At these widths
// the ring's depth counts for more than the epilogue's overlap: D = 1280
// ran 19% faster on 4 stages without the staging than on 2 with it.
// tanh is tanh.approx.f32 (its error against torch.tanh: PERF.md, with the
// times and what was tried).
// Any F (a slimmed ViT's MLP width need not be a multiple of 128): the last
// column tile reads rows F..ceil(F/128)*128 of W_eff^T past the (F, D)
// tensor map, which TMA fills with zeros; the transaction count of a box
// that lies partly out of bounds is still the whole box, so the ring's
// expected bytes stay W_ATOM_BYTES. Bias reads past F are masked, and the
// epilogues write no column >= F: a 16-byte (staged) or 4-byte (unstaged)
// store where the chunk lies below F and the row stride keeps it aligned
// (F % 8 == 0, resp. F even), element stores otherwise. At F % 128 == 0
// every chunk takes the wide store, as before.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BK = 64;                      // K of a swizzle atom: one 128-byte row of bf16
constexpr int BN = 128;                     // output columns of a tile
constexpr int SLAB = 64;                    // rows of one consumer warpgroup
constexpr int W_ATOM_BYTES = BN * BK * 2;   // 64 k of a W_eff^T column tile: 16 KB
constexpr int ATOM_BYTES = SLAB * BK * 2;   // 64 columns of a slab: 8 KB
constexpr int STAGE_ROW = BN * 4;           // bytes of a staged f32 row
constexpr int STAGING_BYTES = SLAB * STAGE_ROW;  // 32 KB a consumer
constexpr int MAX_STAGES = 4;
constexpr int MAX_SMEM = 232448;            // a block's dynamic shared-memory limit
constexpr int BAR_BYTES = 8 * (2 * MAX_STAGES + 3 * 2);

// Byte offsets in the 1024-aligned dynamic shared memory; `total` counts
// the alignment slack.
struct Layout {
  int ring, staging, bars, total;
};

__host__ __device__ inline Layout layout(int nw, bool staged, int d, int stages) {
  Layout l;
  l.ring = nw * SLAB * d * 2;  // the slabs come first
  l.staging = l.ring + stages * W_ATOM_BYTES;
  l.bars = l.staging + (staged ? nw * STAGING_BYTES : 0);
  l.total = l.bars + BAR_BYTES + 1024;
  return l;
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 0.5 y (1 + tanh(sqrt(2/pi) (y + 0.044715 y^3))), the inner sum as
// y (k + k 0.044715 y^2) and the outer as one FMA: 6 operations and the tanh
__device__ __forceinline__ float gelu_tanh(float y) {
  constexpr float k = 0.7978845608028654f;  // sqrt(2 / pi)
  const float inner = y * fmaf(y * y, k * 0.044715f, k);
  const float hy = 0.5f * y;
  return fmaf(hy, tanh_approx(inner), hy);
}

// bf16 gelu_tanh(staged + bias) of the 8 columns 8q..8q+7 of staged row r
// (its 16-byte chunks XOR-swizzled by the row: r % 8 == sub)
__device__ __forceinline__ uint4 staged_gelu(const char* sb, int r, int q, int sub, float4 b0,
                                             float4 b1) {
  const float4 v0 = *reinterpret_cast<const float4*>(sb + r * STAGE_ROW + (((2 * q) ^ sub) << 4));
  const float4 v1 =
      *reinterpret_cast<const float4*>(sb + r * STAGE_ROW + (((2 * q + 1) ^ sub) << 4));
  uint4 o;
  o.x = pack_bf16x2(gelu_tanh(v0.x + b0.x), gelu_tanh(v0.y + b0.y));
  o.y = pack_bf16x2(gelu_tanh(v0.z + b0.z), gelu_tanh(v0.w + b0.w));
  o.z = pack_bf16x2(gelu_tanh(v1.x + b1.x), gelu_tanh(v1.y + b1.y));
  o.w = pack_bf16x2(gelu_tanh(v1.z + b1.z), gelu_tanh(v1.w + b1.w));
  return o;
}

// LayerNorm without affine, in place on one 64-row slab of bf16 (D / 64
// atoms of 64 rows x 128 bytes), by the 128 threads of a warpgroup: 8
// threads a row, thread t takes the 16-byte unit t % 8 of each atom (order
// does not matter to the sums), so a warp reads 4 whole rows at a time.
__device__ __forceinline__ void layer_norm_slab(char* slab, int d, float eps, int t) {
  const int n_atoms = d / BK;
  const float inv_d = 1.f / (float)d;
#pragma unroll 1
  for (int i = 0; i < SLAB / 16; ++i) {
    char* unit = slab + (t / 8 + 16 * i) * (BK * 2) + (t % 8) * 16;
    float sum = 0.f, sq = 0.f;
    for (int a = 0; a < n_atoms; ++a) {
      const uint4 u = *reinterpret_cast<const uint4*>(unit + a * ATOM_BYTES);
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 v = __bfloat1622float2(e[j]);
        sum += v.x + v.y;
        sq += v.x * v.x + v.y * v.y;
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {  // the 8 lanes of a row
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    const float mu = sum * inv_d;
    const float rs = rsqrtf(fmaxf(sq * inv_d - mu * mu, 0.f) + eps);
    for (int a = 0; a < n_atoms; ++a) {
      uint4 u = *reinterpret_cast<const uint4*>(unit + a * ATOM_BYTES);
      uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        w[j] = pack_bf16x2((v.x - mu) * rs, (v.y - mu) * rs);
      }
      *reinterpret_cast<uint4*>(unit + a * ATOM_BYTES) = u;
    }
  }
}

// consumers, an epilogue warpgroup for each (STAGED), the producer's
template <int NW, bool STAGED>
__host__ __device__ constexpr int threads() {
  return 128 * ((STAGED ? 2 * NW : NW) + 1);
}

template <int NW, bool STAGED>
__global__ void __launch_bounds__(threads<NW, STAGED>(), 1)
fused_ln_dense_gelu_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_w,
                           const float* __restrict__ b,  // (F,)
                           bf16* __restrict__ out,       // (M, F)
                           int m, int d, int f, float eps, int stages) {
  constexpr int THREADS = threads<NW, STAGED>();
  constexpr int ROWS = SLAB * NW;
  constexpr int PRODUCER = STAGED ? 2 * NW : NW;  // the producer's warpgroup
  // Registers a thread: R0 at launch (the launch bounds' share, in 8s), for
  // the epilogue too; CREGS for a consumer, 24 for the producer.
  // setmaxnreg.inc draws only on what the producer warpgroup gave back, and
  // waits for it forever.
  constexpr int R0 = (65536 / THREADS) & ~7;
  constexpr int SHARE = (R0 + (R0 - 24) / NW) & ~7;  // the producer's registers shared out
  constexpr int CREGS = SHARE < 240 ? SHARE : 240;
  static_assert(CREGS <= R0 || NW * 128 * (CREGS - R0) <= 128 * (R0 - 24), "consumer registers");

  extern __shared__ __align__(128) char smem_dyn[];
  char* base = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_dyn) + 1023) &
                                       ~uintptr_t(1023));
  const Layout lay = layout(NW, STAGED, d, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.bars);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* x_full = empty + MAX_STAGES;  // [NW]: a slab's x rows arrived
  uint64_t* st_full = x_full + 2;         // [NW]: a staged tile is ready
  uint64_t* st_empty = st_full + 2;       // [NW]: a staging buffer is free
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
  const int n_atoms = d / BK, n_col = (f + BN - 1) / BN;
  const int n_rows = (m + ROWS - 1) / ROWS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * NW);  // every consumer warp
    }
    for (int w = 0; w < NW; ++w) {
      mbar_init(&x_full[w], 1);
      mbar_init(&st_full[w], 128);
      mbar_init(&st_empty[w], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == PRODUCER) {  // ------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == 4 * PRODUCER && lane == 0) {
      int st = 0;
      uint32_t ph = 0;
      for (int rt = blockIdx.x; rt < n_rows; rt += gridDim.x)
        for (int nt = 0; nt < n_col; ++nt)
          for (int a = 0; a < n_atoms; ++a) {
            mbar_wait(&empty[st], ph ^ 1);
            mbar_expect_tx(&full[st], W_ATOM_BYTES);
            tma_load_3d(base + lay.ring + st * W_ATOM_BYTES, &map_w, &full[st], a * BK, nt * BN, 0);
            if (++st == stages) {
              st = 0;
              ph ^= 1;
            }
          }
    }
  } else if (wg >= NW) {  // ---------- epilogue of consumer w (STAGED only)
    // Thread t: 8-column group q of every row sub + 8i of a staged tile; a
    // warp stores two whole 256-byte rows at a time.
    const int w = wg - NW, t = threadIdx.x - 128 * wg;
    const int q = t % 16, sub = t / 16;
    uint32_t tile = 0;
    for (int rt = blockIdx.x; rt < n_rows; rt += gridDim.x)
      for (int nt = 0; nt < n_col; ++nt, ++tile) {
        const int c0 = nt * BN + 8 * q;
        const bool inside = c0 + 8 <= f;     // all 8 columns below F
        const bool wide = inside && f % 8 == 0;  // and 16-byte aligned in every row
        float4 b0, b1;
        if (inside) {
          b0 = __ldg(reinterpret_cast<const float4*>(b + c0));
          b1 = __ldg(reinterpret_cast<const float4*>(b + c0 + 4));
        } else {
          float bt[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) bt[j] = c0 + j < f ? __ldg(b + c0 + j) : 0.f;
          b0 = make_float4(bt[0], bt[1], bt[2], bt[3]);
          b1 = make_float4(bt[4], bt[5], bt[6], bt[7]);
        }
        mbar_wait(&st_full[w], tile & 1);
        const char* sb = base + lay.staging + w * STAGING_BYTES;
        const long long row0 = (long long)rt * ROWS + w * SLAB;
        if (wide) {
#pragma unroll 2
          for (int i = 0; i < SLAB / 8; ++i) {
            const int r = sub + 8 * i;  // r % 8 == sub
            const uint4 o = staged_gelu(sb, r, q, sub, b0, b1);
            if (row0 + r < m) *reinterpret_cast<uint4*>(out + (row0 + r) * f + c0) = o;
          }
        } else {  // the tail tile, or F % 8 != 0: element stores below F
          for (int i = 0; i < SLAB / 8; ++i) {
            const int r = sub + 8 * i;
            const uint4 o = staged_gelu(sb, r, q, sub, b0, b1);
            const uint32_t word[4] = {o.x, o.y, o.z, o.w};
            unsigned short* dst = reinterpret_cast<unsigned short*>(out + (row0 + r) * f + c0);
            if (row0 + r < m) {
#pragma unroll
              for (int j = 0; j < 8; ++j)
                if (c0 + j < f) dst[j] = (unsigned short)(word[j / 2] >> (16 * (j % 2)));
            }
          }
        }
        mbar_arrive(&st_empty[w]);
      }
  } else {  // ------------------------------------------------ consumers
    if constexpr (CREGS > R0) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CREGS));
    const int t = threadIdx.x - 128 * wg;
    const int g = lane / 4, tg = lane % 4;
    const int r0 = (warp % 4) * 16 + g;  // this thread's rows r0, r0 + 8 of the slab
    char* slab = base + wg * SLAB * d * 2;
    const uint32_t slab_u = smem_u32(slab), ring_u = smem_u32(base + lay.ring);
    char* staging = base + lay.staging + wg * STAGING_BYTES;
    float acc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    // a ring stage goes back to the producer
    auto release = [&](int stage) {
      if (lane == 0) mbar_arrive(&empty[stage]);
    };
    int st = 0;
    uint32_t ph = 0, tile = 0, n_slabs = 0;
    for (int rt = blockIdx.x; rt < n_rows; rt += gridDim.x, ++n_slabs) {
      // x rows of this slab by TMA, rows beyond m as zeros (xhat 0 there);
      // the barrier: this warpgroup's products on the last slab are done
      bar_sync(1 + wg, 128);
      if (t == 0) {
        mbar_expect_tx(&x_full[wg], SLAB * d * 2);
        for (int a = 0; a < n_atoms; ++a)
          tma_load_3d(slab + a * ATOM_BYTES, &map_x, &x_full[wg], a * BK, rt * ROWS + wg * SLAB,
                      0);
      }
      mbar_wait(&x_full[wg], n_slabs & 1);
      layer_norm_slab(slab, d, eps, t);
      fence_proxy_async();  // the generic writes, before wgmma reads them
      bar_sync(1 + wg, 128);

      for (int nt = 0; nt < n_col; ++nt, ++tile) {
        // acc = xhat . W_eff^T a 64-deep atom at a time; the stage goes back
        // to the producer as soon as the product reading it is done (the
        // other consumer's products keep the tensor cores busy meanwhile)
        for (int a = 0; a < n_atoms; ++a) {
          mbar_wait(&full[st], ph);
          const uint64_t da = desc_sw128(slab_u + a * ATOM_BYTES, 16);
          const uint64_t db = desc_sw128(ring_u + st * W_ATOM_BYTES, 16);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)  // 16 k = 32 bytes along the swizzled row
            wgmma_ss_n128(acc, da + 2 * kk, db + 2 * kk, a > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          release(st);
          if (++st == stages) {
            st = 0;
            ph ^= 1;
          }
        }
        fence_regs(acc);

        if constexpr (STAGED) {
          // f32 to the staging: columns 8j + 2tg (+1) are half of 16-byte
          // chunk 2j + tg / 2, stored at chunk ^ (row % 8) (row % 8 == g)
          mbar_wait(&st_empty[wg], (tile & 1) ^ 1);
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int off = (((2 * j + (tg >> 1)) ^ g) << 4) + (tg & 1) * 8;
            *reinterpret_cast<float2*>(staging + r0 * STAGE_ROW + off) =
                make_float2(acc[j][0], acc[j][1]);
            *reinterpret_cast<float2*>(staging + (r0 + 8) * STAGE_ROW + off) =
                make_float2(acc[j][2], acc[j][3]);
          }
          mbar_arrive(&st_full[wg]);
        } else {
          const long long row = (long long)rt * ROWS + wg * SLAB + r0;
          if (nt * BN + BN <= f && f % 2 == 0) {  // every pair below F, 4-byte aligned
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int c = nt * BN + 8 * j + 2 * tg;
              const float2 bb = __ldg(reinterpret_cast<const float2*>(b + c));
              if (row < m)
                *reinterpret_cast<uint32_t*>(out + row * f + c) = pack_bf16x2(
                    gelu_tanh(acc[j][0] + bb.x), gelu_tanh(acc[j][1] + bb.y));
              if (row + 8 < m)
                *reinterpret_cast<uint32_t*>(out + (row + 8) * f + c) = pack_bf16x2(
                    gelu_tanh(acc[j][2] + bb.x), gelu_tanh(acc[j][3] + bb.y));
            }
          } else {  // the tail tile, or an odd F: element stores below F
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = nt * BN + 8 * j + 2 * tg + e;
                if (c >= f) continue;
                const float bc = __ldg(b + c);
                if (row < m) out[row * f + c] = __float2bfloat16(gelu_tanh(acc[j][e] + bc));
                if (row + 8 < m)
                  out[(row + 8) * f + c] = __float2bfloat16(gelu_tanh(acc[j][2 + e] + bc));
              }
            }
          }
          fence_regs(acc);  // the next tile's products overwrite acc after these reads
        }
      }
    }
  }
}

// The instance for width d: consumer warpgroups, staged epilogue, ring
// stages. The first candidate that fits with at least its least number of
// stages, with as many stages as fit (up to MAX_STAGES). Returns false
// where none fits (d beyond 1664).
struct Design {
  int nw, staged, stages;
};

bool pick(int d, Design* out) {
  const Design cands[3] = {{2, 1, 3}, {1, 1, 3}, {1, 0, 1}};
  for (const Design& c : cands) {
    int s = MAX_STAGES;
    while (s >= c.stages && layout(c.nw, c.staged, d, s).total > MAX_SMEM) --s;
    if (s >= c.stages) {
      *out = {c.nw, c.staged, s};
      return true;
    }
  }
  return false;
}

template <int NW, bool STAGED>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, const float* b, bf16* out, int m, int d,
           int f, float eps, const Design& ds, cudaStream_t stream) {
  static LaunchSetup setup;
  auto kernel = fused_ln_dense_gelu_kernel<NW, STAGED>;
  int sms = 0;
  int err = setup.sms(kernel, MAX_SMEM, &sms);
  if (err != 0) return err;
  const int n_rows = (m + SLAB * NW - 1) / (SLAB * NW);
  kernel<<<n_rows < sms ? n_rows : sms, threads<NW, STAGED>(),
           layout(NW, STAGED, d, ds.stages).total, stream>>>(mx, mw, b, out, m, d, f, eps,
                                                             ds.stages);
  return (int)cudaGetLastError();
}

int launch_design(const Design& ds, const CUtensorMap& mx, const CUtensorMap& mw, const float* b,
                  bf16* out, int m, int d, int f, float eps, cudaStream_t stream) {
  if (ds.nw == 2) return launch<2, true>(mx, mw, b, out, m, d, f, eps, ds, stream);
  if (ds.staged) return launch<1, true>(mx, mw, b, out, m, d, f, eps, ds, stream);
  return launch<1, false>(mx, mw, b, out, m, d, f, eps, ds, stream);
}

}  // namespace

// x: (m, d) bf16, w_t: (f, d) bf16 = W_eff transposed, b: (f,) f32,
// out: (m, f) bf16; all contiguous and 16-byte aligned. d % 64 == 0,
// d <= 1664, any f >= 1.
// Returns a cudaError_t (0 = launched).
extern "C" int vipers_fused_ln_dense_gelu(const void* x, const void* w_t, const float* b,
                                          void* out, int m, int d, int f, float eps,
                                          void* stream) {
  Design ds;
  if (m <= 0 || d <= 0 || d % BK || f <= 0 || !pick(d, &ds))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  int err = encode_map(&mx, x, d, m, 1, d, (long long)m * d, SLAB);
  if (err == 0) err = encode_map(&mw, w_t, d, f, 1, d, (long long)f * d, BN);
  if (err != 0) return err;
  return launch_design(ds, mx, mw, b, static_cast<bf16*>(out), m, d, f, eps,
                       static_cast<cudaStream_t>(stream));
}

// The instance that width d runs: rows a CTA owns, output columns a tile,
// W_eff ring stages (64 k each), and whether an epilogue warpgroup takes
// the staged tiles (rows 0: no instance fits d).
extern "C" void vipers_fused_mlp_design(int d, int* rows, int* block_n, int* stages,
                                        int* staged) {
  Design ds{0, 0, 0};
  pick(d, &ds);
  *rows = SLAB * ds.nw;
  *block_n = BN;
  *stages = ds.stages;
  *staged = ds.staged;
}
