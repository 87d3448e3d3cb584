// Masked blockwise (flash) attention backward for Hopper (sm_90a).
//
// Replaces the two library Pallas kernels that differentiating
// flash_attention_official (vipers/ops/flash_attention.py:200) runs on the
// TPU: _flash_attention_bwd_dkv (jax/experimental/pallas/ops/tpu/
// flash_attention.py:941, pallas_call :1121) and _flash_attention_bwd_dq
// (:1287, pallas_call :1456). Given q, k, v (B*H, T, 64), the (B, T) key
// mask, the forward's out and f32 lse (B*H, T) and the cotangent dO, it
// writes dq, dk and dv in the input dtype with the arithmetic of the plain
// version (flash_attention_bwd_plain), bf16 rounding P and dS before the
// products that take them:
//   s = (q * scale) . k^T in f32, -1e9 on invalid keys, keys beyond t
//   excluded; p = exp(s - lse); D = rowsum(dO * out);
//   dv = p^T dO, dp = dO v^T, ds = p (dp - D), dq = ds k scale,
//   dk = ds^T q scale.
//
// Bound on the card: at the ViT-S/16 train shape at 384x384 (B*H = 128*6,
// T = 577 padded to 640, hd 64) the function is five T x T x 64 products,
// 201.3 GFLOP, on 505 MB of I/O in bf16 (q, k, v, out, dO read; dq, dk, dv
// written; lse, mask) and 1009 MB in f32. bf16 is bound by operations
// (0.204 ms at 989 TFLOP/s against 0.151 ms of bytes), f32 by the 67
// TFLOP/s of its FMA pipes (3.0 ms). Both instances split the work as the
// library does, so each block owns its outputs and nothing is summed
// across blocks (no atomics, no scratch, dq deterministic); S and dP are
// computed twice, seven products in place of five (bf16: 281.8 GFLOP,
// 0.285 ms at the tensor cores' peak).
//
// bf16: a row pass and two kernels on TMA, mbarriers and wgmma.
//   flash_bwd_rows: lse in log2 units and D = rowsum(f32(dO) * f32(out)) of
//     every query row, once (XLA computes D outside the library's kernels,
//     flash_attention.py:273), into a (2, B*H, Tp) f32 workspace, Tp = T
//     rounded up to 128, zero on the rows t .. Tp - 1; out is read here only.
//   flash_bwd_dkv (_flash_attention_bwd_dkv): a persistent grid over (b*h,
//     128-key tile). Two consumer warpgroups own 64 keys each; their K and V
//     rows are loaded once into registers as wgmma A fragments (ldmatrix),
//     and dK and dV accumulate in registers. Q, dO and the stage's lse and D
//     stream past in 64-query stages through a TMA ring. Per stage: S^T =
//     K Q^T and dP^T = V dO^T (register A, Q and dO K-major), then P^T =
//     exp2(S^T scale log2e - lse) while dP^T runs, dV += bf16(P^T) dO, dS^T
//     = P^T (dP^T - D) while dV runs, dK += bf16(dS^T) Q (register A, dO
//     and Q MN-major); the next stage's S^T and dP^T start before this
//     stage's dK is done.
//   flash_bwd_dq (_flash_attention_bwd_dq): a persistent grid over (b*h,
//     128-query tile), the forward tile's structure with one more product.
//     Two consumer warpgroups own 64 queries each, Q and dO resident (the
//     next tile's loaded under this one), lse and D of their rows in
//     registers; K and V stream in 128-key tiles through a TMA ring. Per
//     tile: S = Q K^T and dP = dO V^T (both K-major), P = exp2(S scale
//     log2e - lse) while dP runs (no online softmax: lse is known), dS =
//     P (dP - D), dQ += bf16(dS) K (register A, K MN-major through the
//     transpose bit, as the forward reads V); dq is written once, times the
//     scale.
// Any t >= 1: rows beyond t read as TMA's zeros (lse, D 0), add nothing and
// are not written; keys beyond t get -inf.
//
// f32: two kernels on plain FMA (no TF32), the parity anchor:
// flash_bwd_dkv_f32, one block per (b*h, 64-key tile) streaming 64-query
// tiles past its keys (S^T, dP^T, then dV += P^T dO and dK += dS^T qs from
// shared memory), and flash_bwd_dq_f32, one block per (b*h, 64-query tile)
// streaming key tiles (S, dP, then dQ += dS K). 256 threads a block, a
// 16 x 16 grid of 4 x 4 tiles each, rows padded to 65 floats; each computes
// its rows' D from out itself.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using attn_tile::HD;
using attn_tile::NEG;

// ------------------------------------------------------------ f32 / FMA
constexpr int F32_B = 64;  // queries of a query tile, keys of a key tile
constexpr int F32_THREADS = 256;
constexpr int F32_LD = HD + 1;  // padded row: conflict-free column reads
constexpr int F32_MAX_TILES = 65535;  // gridDim.y

typedef float Tile[F32_B][F32_LD];

struct DkvSmem {
  Tile k, v;    // the block's keys
  Tile q, g;    // the query tile: q * scale, dO
  Tile pt, dst;  // P^T and dS^T, [key][query]
  float lse[F32_B], dsum[F32_B], fill[F32_B];
};

struct DqSmem {
  Tile q, g;  // the block's queries: q * scale, dO
  Tile k, v;  // the key tile
  Tile ds;    // dS, [query][key]
  float lse[F32_B], dsum[F32_B], fill[F32_B];
};

// Rows row0 .. row0 + 63 of one head's (t, 64) operand times `mul` into a
// padded tile; rows beyond t are zeros.
__device__ __forceinline__ void load_rows(Tile& dst, const float* __restrict__ src, int row0,
                                          int t, float mul) {
  for (int idx = threadIdx.x; idx < F32_B * HD; idx += F32_THREADS) {
    const int r = idx / HD, c = idx % HD, gr = row0 + r;
    dst[r][c] = gr < t ? src[(size_t)gr * HD + c] * mul : 0.f;
  }
}

// lse and D = rowsum(dO * out) of query rows q0 .. q0 + 63 (four threads a
// row); rows beyond t get lse 0 and D 0 (their q and dO are zeros, so they
// add nothing).
__device__ __forceinline__ void row_stats(float* s_lse, float* s_dsum, const float* __restrict__ lse,
                                          const float* __restrict__ o,
                                          const float* __restrict__ g, int q0, int t) {
  const int r = threadIdx.x / 4, part = threadIdx.x % 4, gr = q0 + r;
  float d = 0.f;
  if (gr < t)
    for (int c = part * 16; c < part * 16 + 16; ++c)
      d = fmaf(g[(size_t)gr * HD + c], o[(size_t)gr * HD + c], d);
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  if (part == 0) {
    s_dsum[r] = d;
    s_lse[r] = gr < t ? lse[gr] : 0.f;
  }
}

// What key `key` does to its score: 0 keeps it, -1e9 masks it (the JAX
// kernel's mask), -inf excludes a key beyond t.
__device__ __forceinline__ float key_fill(const uint8_t* vrow, int key, int t) {
  return key >= t ? -INFINITY : (vrow == nullptr || vrow[key]) ? 0.f : NEG;
}

__device__ __forceinline__ float prob(float s, float fill, float lse) {
  return expf((fill == 0.f ? s : fill) - lse);
}

__global__ void __launch_bounds__(F32_THREADS)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ lse, const float* __restrict__ g,
                  const uint8_t* __restrict__ valid, float* __restrict__ dk,
                  float* __restrict__ dv, int heads, int t, float scale) {
  extern __shared__ __align__(16) char smem_raw[];
  DkvSmem& s = *reinterpret_cast<DkvSmem*>(smem_raw);
  const int bh = blockIdx.x, k0 = blockIdx.y * F32_B, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // keys ty*4 + a; queries or dims tx + 16 i
  const size_t base = (size_t)bh * t * HD;
  const uint8_t* vrow = valid ? valid + (size_t)(bh / heads) * t : nullptr;

  load_rows(s.k, k + base, k0, t, 1.f);
  load_rows(s.v, v + base, k0, t, 1.f);
  if (tid < F32_B) s.fill[tid] = key_fill(vrow, k0 + tid, t);
  float dka[4][4], dva[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[a][i] = dva[a][i] = 0.f;

  for (int q0 = 0; q0 < t; q0 += F32_B) {
    __syncthreads();  // the last tile's readers are done
    load_rows(s.q, q + base, q0, t, scale);
    load_rows(s.g, g + base, q0, t, 1.f);
    row_stats(s.lse, s.dsum, lse + (size_t)bh * t, o + base, g + base, q0, t);
    __syncthreads();

    float st[4][4], dpt[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[a][i] = dpt[a][i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float ka[4], va[4], qb[4], gb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ka[a] = s.k[ty * 4 + a][d];
        va[a] = s.v[ty * 4 + a][d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qb[i] = s.q[tx + 16 * i][d];
        gb[i] = s.g[tx + 16 * i][d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          st[a][i] = fmaf(ka[a], qb[i], st[a][i]);
          dpt[a][i] = fmaf(va[a], gb[i], dpt[a][i]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int key = ty * 4 + a;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = tx + 16 * i;
        const float p = prob(st[a][i], s.fill[key], s.lse[qi]);
        s.pt[key][qi] = p;
        s.dst[key][qi] = p * (dpt[a][i] - s.dsum[qi]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < F32_B; ++qq) {
      float pa[4], da[4], gb[4], qb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pa[a] = s.pt[ty * 4 + a][qq];
        da[a] = s.dst[ty * 4 + a][qq];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gb[i] = s.g[qq][tx + 16 * i];
        qb[i] = s.q[qq][tx + 16 * i];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dva[a][i] = fmaf(pa[a], gb[i], dva[a][i]);
          dka[a][i] = fmaf(da[a], qb[i], dka[a][i]);
        }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty * 4 + a;
    if (key >= t) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t at = base + (size_t)key * HD + tx + 16 * i;
      dk[at] = dka[a][i];
      dv[at] = dva[a][i];
    }
  }
}

__global__ void __launch_bounds__(F32_THREADS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ lse, const float* __restrict__ g,
                 const uint8_t* __restrict__ valid, float* __restrict__ dq, int heads, int t,
                 float scale) {
  extern __shared__ __align__(16) char smem_raw[];
  DqSmem& s = *reinterpret_cast<DqSmem*>(smem_raw);
  const int bh = blockIdx.x, q0 = blockIdx.y * F32_B, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // queries ty*4 + a; keys or dims tx + 16 i
  const size_t base = (size_t)bh * t * HD;
  const uint8_t* vrow = valid ? valid + (size_t)(bh / heads) * t : nullptr;

  load_rows(s.q, q + base, q0, t, scale);
  load_rows(s.g, g + base, q0, t, 1.f);
  row_stats(s.lse, s.dsum, lse + (size_t)bh * t, o + base, g + base, q0, t);
  float dqa[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) dqa[a][i] = 0.f;

  for (int k0 = 0; k0 < t; k0 += F32_B) {
    __syncthreads();  // the last tile's readers are done
    load_rows(s.k, k + base, k0, t, 1.f);
    load_rows(s.v, v + base, k0, t, 1.f);
    if (tid < F32_B) s.fill[tid] = key_fill(vrow, k0 + tid, t);
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[a][i] = dp[a][i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[4], ga[4], kb[4], vb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qa[a] = s.q[ty * 4 + a][d];
        ga[a] = s.g[ty * 4 + a][d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kb[i] = s.k[tx + 16 * i][d];
        vb[i] = s.v[tx + 16 * i][d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[a][i] = fmaf(qa[a], kb[i], sc[a][i]);
          dp[a][i] = fmaf(ga[a], vb[i], dp[a][i]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qi = ty * 4 + a;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = tx + 16 * i;
        s.ds[qi][key] = prob(sc[a][i], s.fill[key], s.lse[qi]) * (dp[a][i] - s.dsum[qi]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < F32_B; ++kk) {
      float da[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = s.ds[ty * 4 + a][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i) kb[i] = s.k[kk][tx + 16 * i];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) dqa[a][i] = fmaf(da[a], kb[i], dqa[a][i]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty * 4 + a;
    if (row >= t) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[base + (size_t)row * HD + tx + 16 * i] = dqa[a][i] * scale;
  }
}

int launch_f32(const float* q, const float* k, const float* v, const float* o, const float* lse,
               const float* dout, const uint8_t* valid, float* dq, float* dk, float* dv, int bh,
               int heads, int t, float scale, cudaStream_t st) {
  const int tiles = (t + F32_B - 1) / F32_B;
  if (tiles > F32_MAX_TILES) return (int)cudaErrorInvalidValue;
  const int dkv_smem = (int)sizeof(DkvSmem), dq_smem = (int)sizeof(DqSmem);
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_f32<<<dim3(bh, tiles), F32_THREADS, dkv_smem, st>>>(q, k, v, o, lse, dout, valid,
                                                                    dk, dv, heads, t, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_f32<<<dim3(bh, tiles), F32_THREADS, dq_smem, st>>>(q, k, v, o, lse, dout, valid,
                                                                  dq, heads, t, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- bf16 / Hopper
using namespace attn_tile::hopper;  // ROW, LOG2E, NEG2, mask_scores, start_scores,
                                    // start_pv, tile_threads; hopper.cuh's blocks
typedef __nv_bfloat16 bf16;

constexpr int KV_KEYS = 128;    // keys of a dk/dv tile: 64 a consumer warpgroup
constexpr int KV_BQ = 64;       // queries of a dk/dv stage
constexpr int KV_STAGES = 4;    // query stages in the dk/dv ring
constexpr int DQ_ROWS = 128;    // queries of a dq tile: 64 a consumer warpgroup
constexpr int DQ_KEYS = BK;     // keys of a dq K/V stage (mask_scores' tile)
constexpr int DQ_STAGES = 3;    // K/V stages in the dq ring
constexpr int ROW_PAD = 128;    // the workspace's rows a head, t rounded up
constexpr int BWD_WGS = 2;      // consumer warpgroups of both kernels
constexpr int BWD_CONSUMERS = 4 * BWD_WGS;
constexpr int BWD_THREADS = tile_threads<BWD_WGS>();
// Registers a thread: R0 at launch, CREGS for a consumer, 24 for the
// producer; setmaxnreg.inc draws only on what the producer gave back.
constexpr int BWD_R0 = (65536 / BWD_THREADS) & ~7;
constexpr int BWD_CREGS = 240;
static_assert(BWD_WGS * 128 * (BWD_CREGS - BWD_R0) <= 128 * (BWD_R0 - 24), "consumer registers");
static_assert(DQ_ROWS == 64 * BWD_WGS && KV_KEYS == 64 * BWD_WGS, "64 rows a warpgroup");

// Four 8x8 bf16 matrices from shared memory into the mma fragment layout;
// lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The wgmma A fragments of this warp's 16 rows, row0 .. row0 + 15 (row0 a
// multiple of 8), of a [row][64] bf16 tile in the 128-byte swizzle, for the
// four 16-column k steps: step kk's matrices are rows 0-7 and 8-15 of
// 16-byte chunks 2kk and 2kk + 1.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[HD / 16][4], uint32_t tile, int row0,
                                             int lane) {
  const int mat = lane / 8, rw = lane % 8;
  const uint32_t row = row0 + (mat & 1) * 8 + rw;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t chunk = 2 * kk + (mat >> 1);
    ldmatrix_x4(tile + row * ROW + ((chunk ^ rw) << 4), a[kk]);
  }
}

// D (64 x 64, f32) {=, +=} A (64 x 16, bf16 in registers) . B (16 x 64,
// bf16 in shared memory, K-major (TB = 0) or MN-major through the
// transpose bit (TB = 1)); scale_d = 0 overwrites D.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// Pack f32 C fragments (N / 8 column groups) into bf16 A fragments of the
// next product, whose k is this one's n: the C layout of column groups 2kk
// and 2kk + 1 is the A layout of k step kk.
template <int N>
__device__ __forceinline__ void pack_a(const float (&c)[N / 8][4], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16x2(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16x2(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// A 3-D map over one (bh, t, 64) bf16 operand in boxes of `rows` rows; rows
// beyond t read as zeros.
inline int head_map(CUtensorMap* map, const void* base, int bh, int t, int rows) {
  return encode_map(map, base, HD, t, bh, HD, (long long)t * HD, rows);
}

// lse in log2 units and D = rowsum(f32(dO) * f32(out)) of each of the
// bh * tp workspace rows (row r of head h at h * tp + r), zero where r >= t:
// 8 threads a row, 16 bytes of out and dO each.
__global__ void __launch_bounds__(256)
flash_bwd_rows(const bf16* __restrict__ o, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ lse2,
               float* __restrict__ dsum, int n_rows, int t, int tp) {
  const int idx = blockIdx.x * 256 + threadIdx.x;
  const int row = idx / 8, part = idx % 8;
  const int bh = row / tp, r = row % tp;
  const bool in = row < n_rows && r < t;
  float d = 0.f;
  if (in) {
    const size_t at = ((size_t)bh * t + r) * HD + part * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + at);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + at);
    const __nv_bfloat162* ea = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* eb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fa = __bfloat1622float2(ea[e]), fb = __bfloat1622float2(eb[e]);
      d = fmaf(fa.x, fb.x, fmaf(fa.y, fb.y, d));
    }
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
  if (row < n_rows && part == 0) {
    dsum[row] = d;
    lse2[row] = in ? lse[(size_t)bh * t + r] * LOG2E : 0.f;
  }
}

struct alignas(1024) DkvStage {
  bf16 q[KV_BQ * HD];
  bf16 dout[KV_BQ * HD];
  float lse[KV_BQ];  // log2 units
  float dsum[KV_BQ];
};

struct DkvShared {
  bf16 k[KV_KEYS * HD];  // the tile's keys, [key][dim], until the consumers hold them
  bf16 v[KV_KEYS * HD];
  DkvStage st[KV_STAGES];
  uint64_t full[KV_STAGES], empty[KV_STAGES], kv_full, kv_empty;
};
constexpr int KV_SMEM = (int)sizeof(DkvShared) + 1024;  // + the alignment slack
constexpr int KV_STAGE_TX = 2 * KV_BQ * ROW + 2 * KV_BQ * 4;

// dk, dv of 128-key tiles (tile = bh * n_kt + key tile: the tiles of one
// head run side by side and share its Q and dO in L2).
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dkv(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
              const float* __restrict__ lse2, const float* __restrict__ dsum,
              const uint8_t* __restrict__ valid, bf16* __restrict__ dk, bf16* __restrict__ dv,
              int heads, int t, int tp, int n_tiles, float scale) {
  extern __shared__ __align__(128) char smem_dyn[];
  DkvShared& s = *reinterpret_cast<DkvShared*>((reinterpret_cast<uintptr_t>(smem_dyn) + 1023) &
                                         ~uintptr_t(1023));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_kt = (t + KV_KEYS - 1) / KV_KEYS, n_qs = (t + KV_BQ - 1) / KV_BQ;

  if (threadIdx.x == 0) {
    for (int i = 0; i < KV_STAGES; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], BWD_CONSUMERS);
    }
    mbar_init(&s.kv_full, 1);
    mbar_init(&s.kv_empty, BWD_CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= BWD_CONSUMERS) {  // --------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == BWD_CONSUMERS && lane == 0) {
      uint32_t it = 0;  // query stages requested
      int i = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
        const int bh = tile / n_kt, kt = tile % n_kt;
        mbar_wait(&s.kv_empty, (i & 1) ^ 1);
        mbar_expect_tx(&s.kv_full, 2 * KV_KEYS * ROW);
        tma_load_3d(s.k, &map_k, &s.kv_full, 0, kt * KV_KEYS, bh);
        tma_load_3d(s.v, &map_v, &s.kv_full, 0, kt * KV_KEYS, bh);
        const float* rl = lse2 + (size_t)bh * tp;
        const float* rd = dsum + (size_t)bh * tp;
        for (int qs = 0; qs < n_qs; ++qs, ++it) {
          const int st = it % KV_STAGES;
          mbar_wait(&s.empty[st], ((it / KV_STAGES) & 1) ^ 1);
          DkvStage& sb = s.st[st];
          mbar_expect_tx(&s.full[st], KV_STAGE_TX);
          tma_load_3d(sb.q, &map_q, &s.full[st], 0, qs * KV_BQ, bh);
          tma_load_3d(sb.dout, &map_do, &s.full[st], 0, qs * KV_BQ, bh);
          bulk_load(sb.lse, rl + qs * KV_BQ, KV_BQ * 4, &s.full[st]);
          bulk_load(sb.dsum, rd + qs * KV_BQ, KV_BQ * 4, &s.full[st]);
        }
      }
    }
  } else {  // -------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(BWD_CREGS));
    const int wg = warp / 4, w = warp % 4, g = lane / 4, tg = lane % 4;
    const float s2 = scale * LOG2E;  // score to log2 units
    uint32_t it = 0;
    int i = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const int bh = tile / n_kt, kt = tile % n_kt;
      const uint8_t* vrow = valid ? valid + (size_t)(bh / heads) * t : nullptr;
      // this thread's keys (rows of S^T): k0 + 16w + g + 8rr; in log2 units a
      // score becomes s * kmul + kadd: s * scale log2e, -1e9 log2e where the
      // key is masked, -inf beyond t
      const int k0 = kt * KV_KEYS + 64 * wg;
      float kmul[2], kadd[2];
      bool all_valid = true;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int key = k0 + 16 * w + g + 8 * rr;
        const bool in = key < t, ok = in && (vrow == nullptr || __ldg(vrow + key) != 0);
        kmul[rr] = ok ? s2 : 0.f;
        kadd[rr] = ok ? 0.f : (in ? NEG2 : -INFINITY);
        all_valid = all_valid && ok;
      }
      all_valid = __all_sync(0xffffffffu, all_valid);

      // K and V rows of this warpgroup as A fragments, then the buffer goes back
      uint32_t kf[HD / 16][4], vf[HD / 16][4];
      mbar_wait(&s.kv_full, i & 1);
      load_a_frags(kf, smem_u32(s.k), 64 * wg + 16 * w, lane);
      load_a_frags(vf, smem_u32(s.v), 64 * wg + 16 * w, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.kv_empty);

      float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;
      uint32_t pa[KV_BQ / 16][4] = {}, dsa[KV_BQ / 16][4] = {};
      int prev = 0;  // the stage whose dV and dK were issued last
      for (int qs = 0; qs < n_qs; ++qs, ++it) {
        const int st = it % KV_STAGES;
        DkvStage& sb = s.st[st];
        const uint32_t qa = smem_u32(sb.q), da = smem_u32(sb.dout);
        mbar_wait(&s.full[st], (it / KV_STAGES) & 1);
        // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries), two groups
        float sa[KV_BQ / 8][4], dpa[KV_BQ / 8][4];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_rs_n64<0>(sa, kf[kk], desc_sw128(qa, 16) + 2 * kk, kk);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_rs_n64<0>(dpa, vf[kk], desc_sw128(da, 16) + 2 * kk, kk);
        wgmma_commit();
        wgmma_wait<1>();  // S^T, and the last stage's dV and dK
        fence_regs(sa);
        fence_regs(dka);
        fence_regs(dva);
        fence_regs(pa);
        fence_regs(dsa);
        if (qs > 0 && lane == 0) mbar_arrive(&s.empty[prev]);
        // P^T = exp2(S^T s2 - lse) (columns 8j + 2tg + e%2 are queries)
#pragma unroll
        for (int j = 0; j < KV_BQ / 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(&sb.lse[8 * j + 2 * tg]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float le = (e & 1) ? l.y : l.x;
            const float x = all_valid ? fmaf(sa[j][e], s2, -le)
                                      : fmaf(sa[j][e], kmul[e / 2], kadd[e / 2]) - le;
            sa[j][e] = ex2(x);
          }
        }
        pack_a<KV_BQ>(sa, pa);
        // dV += bf16(P^T) dO (16 queries = 2048 bytes a step)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KV_BQ / 16; ++kk)
          wgmma_rs_n64<1>(dva, pa[kk], desc_sw128(da, 1024) + 128 * kk, 1);
        wgmma_commit();
        wgmma_wait<1>();  // dP^T
        fence_regs(dpa);
        // dS^T = P^T (dP^T - D)
#pragma unroll
        for (int j = 0; j < KV_BQ / 8; ++j) {
          const float2 dd = *reinterpret_cast<const float2*>(&sb.dsum[8 * j + 2 * tg]);
#pragma unroll
          for (int e = 0; e < 4; ++e) dpa[j][e] = sa[j][e] * (dpa[j][e] - ((e & 1) ? dd.y : dd.x));
        }
        pack_a<KV_BQ>(dpa, dsa);
        // dK += bf16(dS^T) Q
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KV_BQ / 16; ++kk)
          wgmma_rs_n64<1>(dka, dsa[kk], desc_sw128(qa, 1024) + 128 * kk, 1);
        wgmma_commit();
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
      fence_regs(pa);
      fence_regs(dsa);
      if (lane == 0) mbar_arrive(&s.empty[prev]);

      const size_t base = (size_t)bh * t * HD;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int key = k0 + 16 * w + g + 8 * rr;
        if (key >= t) continue;
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
          const size_t at = base + (size_t)key * HD + dt * 8 + 2 * tg;
          *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
              dka[dt][2 * rr] * scale, dka[dt][2 * rr + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + at) =
              __floats2bfloat162_rn(dva[dt][2 * rr], dva[dt][2 * rr + 1]);
        }
      }
    }
  }
}

struct DqShared {
  bf16 q[2][DQ_ROWS * HD];  // the tile's queries, and the next tile's
  bf16 dout[2][DQ_ROWS * HD];
  bf16 k[DQ_STAGES][DQ_KEYS * HD];
  bf16 v[DQ_STAGES][DQ_KEYS * HD];
  uint64_t q_full[2], q_empty[2], kv_full[DQ_STAGES], kv_empty[DQ_STAGES];
};
constexpr int DQ_SMEM = (int)sizeof(DqShared) + 1024;

// dq of 128-query tiles (tile = bh * n_qt + query tile: the tiles of one
// head run side by side and share its K and V in L2).
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dq(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
             const float* __restrict__ lse2, const float* __restrict__ dsum,
             const uint8_t* __restrict__ valid, bf16* __restrict__ dq, int heads, int t, int tp,
             int n_tiles, float scale) {
  extern __shared__ __align__(128) char smem_dyn[];
  DqShared& s = *reinterpret_cast<DqShared*>((reinterpret_cast<uintptr_t>(smem_dyn) + 1023) &
                                             ~uintptr_t(1023));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_qt = (t + DQ_ROWS - 1) / DQ_ROWS, n_kt = (t + DQ_KEYS - 1) / DQ_KEYS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.q_full[i], 1);
      mbar_init(&s.q_empty[i], BWD_CONSUMERS);
    }
    for (int i = 0; i < DQ_STAGES; ++i) {
      mbar_init(&s.kv_full[i], 1);
      mbar_init(&s.kv_empty[i], BWD_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= BWD_CONSUMERS) {  // --------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == BWD_CONSUMERS && lane == 0) {
      uint32_t it = 0;  // K/V tiles requested
      int i = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
        const int bh = tile / n_qt, q0 = (tile % n_qt) * DQ_ROWS, qb = i & 1;
        mbar_wait(&s.q_empty[qb], ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(&s.q_full[qb], 2 * DQ_ROWS * ROW);
        tma_load_3d(s.q[qb], &map_q, &s.q_full[qb], 0, q0, bh);
        tma_load_3d(s.dout[qb], &map_do, &s.q_full[qb], 0, q0, bh);
        for (int j = 0; j < n_kt; ++j, ++it) {
          const int st = it % DQ_STAGES;
          mbar_wait(&s.kv_empty[st], ((it / DQ_STAGES) & 1) ^ 1);
          mbar_expect_tx(&s.kv_full[st], 2 * DQ_KEYS * ROW);
          tma_load_3d(s.k[st], &map_k, &s.kv_full[st], 0, j * DQ_KEYS, bh);
          tma_load_3d(s.v[st], &map_v, &s.kv_full[st], 0, j * DQ_KEYS, bh);
        }
      }
    }
  } else {  // -------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(BWD_CREGS));
    const int wg = warp / 4, g = lane / 4, tg = lane % 4;
    const float s2 = scale * LOG2E;
    uint32_t it = 0;
    int i = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const int bh = tile / n_qt, q0 = (tile % n_qt) * DQ_ROWS, qb = i & 1;
      const uint8_t* vrow = valid ? valid + (size_t)(bh / heads) * t : nullptr;
      // this thread's rows q0 + 16 warp + g + 8rr: lse (log2 units) and D
      float lr[2], dr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const size_t at = (size_t)bh * tp + q0 + 16 * warp + g + 8 * rr;
        lr[rr] = __ldg(lse2 + at);
        dr[rr] = __ldg(dsum + at);
      }
      float dqa[HD / 8][4];
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[dt][e] = 0.f;
      uint32_t dsa[DQ_KEYS / 16][4] = {};
      mbar_wait(&s.q_full[qb], (i >> 1) & 1);
      const uint32_t qs = smem_u32(s.q[qb]) + wg * 64 * ROW;
      const uint32_t ds = smem_u32(s.dout[qb]) + wg * 64 * ROW;
      int prev = 0;  // the stage whose dQ product was issued last
      for (int j = 0; j < n_kt; ++j, ++it) {
        const int st = it % DQ_STAGES;
        mbar_wait(&s.kv_full[st], (it / DQ_STAGES) & 1);
        // S = Q K^T and dP = dO V^T (64 queries x 128 keys), two groups
        float sa[DQ_KEYS / 8][4], dpa[DQ_KEYS / 8][4];
        wgmma_fence();
        start_scores<DQ_KEYS>(sa, qs, smem_u32(s.k[st]));
        start_scores<DQ_KEYS>(dpa, ds, smem_u32(s.v[st]));
        wgmma_wait<1>();  // S, and the last tile's dQ
        fence_regs(sa);
        fence_regs(dqa);
        fence_regs(dsa);
        if (j > 0 && lane == 0) mbar_arrive(&s.kv_empty[prev]);
        // P = exp2(S s2 - lse); mask_scores scales and masks a tile with an
        // invalid key or one beyond t itself (c = 1)
        const float c = mask_scores(sa, vrow, j * DQ_KEYS, t, s2, lane);
#pragma unroll
        for (int jj = 0; jj < DQ_KEYS / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) sa[jj][e] = ex2(fmaf(sa[jj][e], c, -lr[e / 2]));
        wgmma_wait<0>();  // dP
        fence_regs(dpa);
        // dS = P (dP - D)
#pragma unroll
        for (int jj = 0; jj < DQ_KEYS / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) dpa[jj][e] = sa[jj][e] * (dpa[jj][e] - dr[e / 2]);
        pack_a<DQ_KEYS>(dpa, dsa);
        // dQ += bf16(dS) K, K MN-major through the transpose bit
        wgmma_fence();
        start_pv<DQ_KEYS>(dqa, dsa, smem_u32(s.k[st]));
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(dqa);
      fence_regs(dsa);
      if (lane == 0) {
        mbar_arrive(&s.kv_empty[prev]);
        mbar_arrive(&s.q_empty[qb]);
      }

      const size_t base = (size_t)bh * t * HD;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = q0 + 16 * warp + g + 8 * rr;
        if (row >= t) continue;
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt)
          *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row * HD + dt * 8 + 2 * tg) =
              __floats2bfloat162_rn(dqa[dt][2 * rr] * scale, dqa[dt][2 * rr + 1] * scale);
      }
    }
  }
}

// rows: the (2, bh, round_up(t, 128)) f32 workspace (lse in log2 units,
// then D).
int launch_bwd_bf16(const void* q, const void* k, const void* v, const void* o, const float* lse,
                const void* dout, const uint8_t* valid, void* dq, void* dk, void* dv, float* rows,
                int bh, int heads, int t, float scale, cudaStream_t st) {
  const int tp = (t + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  float* lse2 = rows;
  float* dsum = rows + (size_t)bh * tp;
  const long long threads = (long long)bh * tp * 8;  // 8 a workspace row
  if (threads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap mq64, mdo64, mq128, mdo128, mk, mv;
  int err = head_map(&mq64, q, bh, t, KV_BQ);
  if (err == 0) err = head_map(&mdo64, dout, bh, t, KV_BQ);
  if (err == 0) err = head_map(&mq128, q, bh, t, DQ_ROWS);
  if (err == 0) err = head_map(&mdo128, dout, bh, t, DQ_ROWS);
  if (err == 0) err = head_map(&mk, k, bh, t, KV_KEYS);
  if (err == 0) err = head_map(&mv, v, bh, t, KV_KEYS);
  if (err != 0) return err;
  static LaunchSetup kv_setup, dq_setup;
  int sms = 0;
  err = kv_setup.sms(flash_bwd_dkv, KV_SMEM, &sms);
  if (err == 0) err = dq_setup.sms(flash_bwd_dq, DQ_SMEM, &sms);
  if (err != 0) return err;

  flash_bwd_rows<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, lse2, dsum, bh * tp, t,
      tp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int kv_tiles = bh * ((t + KV_KEYS - 1) / KV_KEYS);
  flash_bwd_dkv<<<kv_tiles < sms ? kv_tiles : sms, BWD_THREADS, KV_SMEM, st>>>(
      mq64, mk, mv, mdo64, lse2, dsum, valid, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      heads, t, tp, kv_tiles, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int dq_tiles = bh * ((t + DQ_ROWS - 1) / DQ_ROWS);
  flash_bwd_dq<<<dq_tiles < sms ? dq_tiles : sms, BWD_THREADS, DQ_SMEM, st>>>(
      mq128, mk, mv, mdo128, lse2, dsum, valid, static_cast<bf16*>(dq), heads, t, tp, dq_tiles,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (bh, t, 64) contiguous each, 16-byte
// aligned, all float32 (dtype 0) or all bfloat16 (dtype 1); lse: (bh, t)
// float32; valid: (bh / heads, t) bytes, nonzero = attend, or null (all
// valid). rows: for bf16 a (2, bh, round_up(t, 128)) float32 workspace
// that needs no initialisation (unused for float32, may be null).
// device: the tensors' CUDA device, made current on this thread (the
// backward runs on autograd's worker thread, where cuTensorMapEncodeTiled
// refuses every address without a current context). Returns a cudaError_t
// (0 = launched).
extern "C" int vipers_flash_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const float* lse, const void* dout,
                                          const uint8_t* valid, void* dq, void* dk, void* dv,
                                          float* rows, int bh, int heads, int t, int head_dim,
                                          float scale, int dtype, int device, void* stream) {
  if (head_dim != HD || bh <= 0 || heads <= 0 || bh % heads || t <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<const float*>(o), lse,
                      static_cast<const float*>(dout), valid, static_cast<float*>(dq),
                      static_cast<float*>(dk), static_cast<float*>(dv), bh, heads, t, scale, st);
  if (dtype != 1 || rows == nullptr) return (int)cudaErrorInvalidValue;
  return launch_bwd_bf16(q, k, v, o, lse, dout, valid, dq, dk, dv, rows, bh, heads, t, scale, st);
}

// The bf16 design as compiled, for the kernel's report line: the dk/dv
// kernel's keys a tile, queries a stage and stages; the dq kernel's queries
// a tile, keys a stage and stages; the workspace's row padding; the number
// of main kernels (after the row pass).
extern "C" void vipers_flash_attention_bwd_design(int* dkv_keys, int* dkv_queries,
                                                  int* dkv_stages, int* dq_queries, int* dq_keys,
                                                  int* dq_stages, int* row_pad, int* kernels) {
  *dkv_keys = KV_KEYS;
  *dkv_queries = KV_BQ;
  *dkv_stages = KV_STAGES;
  *dq_queries = DQ_ROWS;
  *dq_keys = DQ_KEYS;
  *dq_stages = DQ_STAGES;
  *row_pad = ROW_PAD;
  *kernels = 2;
}
