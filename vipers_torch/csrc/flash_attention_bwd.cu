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
// (0.204 ms at 989 TFLOP/s against 0.151 ms of bytes). f32 runs every
// product as three TF32 products (below), so its operations bound it at 3 x
// 201.3 GFLOP over the TF32 tensor cores' 494.7 TFLOP/s, 1.221 ms (bytes:
// 0.301 ms); on the 67 TFLOP/s FMA pipes the same 201.3 GFLOP would take
// 3.005 ms. Both instances split the work as the library does, so each
// block owns its outputs and nothing is summed across blocks (no atomics,
// no scratch, dq deterministic); S and dP are computed twice, seven products
// in place of five (281.8 GFLOP: bf16 0.285 ms at the tensor cores' peak,
// f32 1.710 ms as 3xTF32, 4.207 ms on FMA).
//
// Both instances: a row pass and two kernels on TMA, mbarriers and wgmma.
//   flash_bwd_rows: lse in log2 units and D = rowsum(f32(dO) * f32(out)) of
//     every query row, once (XLA computes D outside the library's kernels,
//     flash_attention.py:273), into a (2, B*H, Tp) f32 workspace, Tp = T
//     rounded up to 128, zero on the rows t .. Tp - 1; out is read here only.
// bf16:
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
// f32 (the parity anchor, within 1e-4 of each gradient's scale of the exact
// plain version): the same split and structure on TF32 wgmma, every product
// as three TF32 products into one f32 sum (hopper.cuh: small.big + big.small
// + big.big, CUTLASS's OpMultiplyAddFastF32, which SDPA's f32 kernels run
// too). Exponentials, D and dS stay in f32. TMA brings f32 tiles in two
// 32-column boxes (128-byte swizzled halves); each operand is split into
// TF32 big and small, in registers where it is a register A, else once in
// shared memory by the consumers (the loads, splits and 3xTF32 products are
// attention_tile.cuh's, shared with the f32 forward).
//   flash_bwd_dkv_f32: a persistent grid over (b*h, 128-key tile), two
//     consumer warpgroups of 64 keys; once a tile K is loaded into
//     registers as split A fragments and V split in place (shared A). Q,
//     dO, lse and D stream past in 32-query stages through a 2-stage TMA
//     ring of raw f32; per stage both warpgroups split it (a thread a query
//     row and 8 dims) into Q and dO, big and small, [query][dim], plus the
//     K-major copies [dim][query] that dV += P^T dO and dK += dS^T Q read
//     as B (wgmma has no transpose bit for TF32), then free the raw stage.
//     S^T = K Q^T (register A) and dP^T = V dO^T (shared A), P^T from S^T
//     while dP^T runs, dV from P^T in registers while dP^T finishes, dS^T,
//     dK.
//   flash_bwd_dq_f32: a persistent grid over (b*h, 128-query tile), two
//     consumer warpgroups of 64 queries; once a tile Q is loaded into
//     registers as split A fragments and dO split in place (shared A). K
//     and V stream in 32-key stages through a 3-stage ring; per stage K and
//     V are split, with a K-major copy of K [dim][key] for dQ += dS K. S =
//     Q K^T (register A), dP = dO V^T, P while dP runs, dS, dQ; dq is
//     written once, times the scale.
//   Accumulator into A: a TF32 A fragment of an 8-deep k step holds columns
//   tg and tg + 4 of its rows, the accumulator columns 2tg and 2tg + 1, so
//   P^T, dS^T and dS enter as A unchanged, their k permuted within each
//   8-group (tf32_a_frag), and the transposed B copies store their k rows in
//   the same order (tf32_perm); only the order of the sum changes.
//   Cost of the split: a stage's split copies are written by the consumers
//   between two barriers of both warpgroups, so no product overlaps them;
//   Q, dO and K are written three times over (big, small, transposed big
//   and small), V twice. Shared memory: dk/dv 194 KB (K 32 KB until it is
//   in registers, V big and small 64 KB, the split stage 64 KB, the ring 32
//   KB), dq 194 KB (Q 32 KB, dO big and small 64 KB, the split stage 48 KB,
//   the ring 48 KB), one CTA an SM. Registers a consumer thread, of the 240
//   it gets: dk/dv the K fragments 64, dK and dV 64, S^T and dP^T 32, the
//   P^T and dS^T fragments 64; dq the Q fragments 64, dQ 32, S and dP 32,
//   the dS fragments 32. ptxas -v: no spills, no serialized wgmma. Tried
//   and dropped: leaving dQ running under the next stage's split (two K^T
//   buffers) made ptxas serialize the dq kernel's wgmma (C7515).
// Any t >= 1: rows beyond t read as TMA's zeros (lse, D 0), add nothing and
// are not written; keys beyond t get -inf.
//
// Head dim 80 (vit_h_14's 16 heads of 80): every kernel above has an hd-80
// instance (the wrappers reject any other head dim). bf16: each row of Q, K,
// V and dO is two TMA boxes, its first 64 columns with the 128-byte swizzle
// and a 16-column tail with the 32-byte swizzle in tiles of their own
// (attention_tile.cuh's design for the forward): S^T and dP^T (S and dP)
// take a fifth k16 step from the tails, the K and V fragments of the dk/dv
// kernel a fifth from ldmatrix on the tails, and dV, dK (dQ) are an n64
// product into their first eight 8-column groups and an n16 product on the
// tail tile into the last two; shared memory 126 KB (dk/dv) and 202 KB
// (dq). f32: rows of three 32-column parts, TMA zero-filling columns 80-95,
// which no product reads; 10 k steps of k8, the n80 products an n64 and an
// n16. Laid out as at hd 64, the f32 kernels would need 280 KB (dk/dv) and
// 284 KB (dq) of shared memory, so at hd 80 the tile's K (dk/dv) or Q (dq),
// which the consumers hold as register A once it is loaded, shares its
// buffer with the stage's split copies, which are written only after both
// warpgroups hold it; and the raw ring keeps one stage (dk/dv: the split
// copies are the second) or two (dq): 210 and 214 KB. The f32 dk/dv kernel
// computes P^T and dS^T before it splits either (the dV product no longer
// overlaps dP^T), so K's 80 registers, dK and dV's 80 and both split
// fragments fit in a consumer's 240 with no spill; ptxas serializes the
// wgmma of both hd-80 dk/dv kernels (C7512), bf16 and f32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using attn_tile::HD;
using attn_tile::NEG;
using attn_tile::tail_cols;

// --------------------------------------- Hopper: what both share, then bf16
using namespace attn_tile::hopper;  // ROW, LOG2E, NEG2, mask_scores, start_scores,
                                    // start_pv, tile_threads; the f32 blocks shared
                                    // with the f32 forward (tma_load_f32, split_rows,
                                    // split_stage, product_*); hopper.cuh's blocks
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
template <int D = HD>
inline int head_map(CUtensorMap* map, const void* base, int bh, int t, int rows) {
  return encode_map(map, base, D, t, bh, D, (long long)t * D, rows);
}

// The same over the rows' last 16 columns at hd 80 (32-byte swizzle).
template <int D>
inline int tail_map(CUtensorMap* map, const void* base, int bh, int t, int rows) {
  return encode_map_tail(map, base, D, t, bh, D, (long long)t * D, rows);
}

// The A fragments of k step 4 at hd 80: this warp's 16 rows of a [row][16]
// tail tile in the 32-byte swizzle (the 16-byte chunk c of row r at chunk c
// ^ ((r / 4) & 1)).
__device__ __forceinline__ void load_a_tail(uint32_t (&a)[4], uint32_t tile, int row0, int lane) {
  const int mat = lane / 8, rw = lane % 8;
  const uint32_t row = row0 + (mat & 1) * 8 + rw;
  const uint32_t chunk = mat >> 1;
  ldmatrix_x4(tile + row * 32 + ((chunk ^ ((row >> 2) & 1)) << 4), a);
}

// The maps of the rows' 16-column tails at hd 80; none at hd 64.
template <int TAIL>
struct BwdTails {
  CUtensorMap q, k, v, dout;
};
template <>
struct BwdTails<0> {};

// rowsum(f32(a) * f32(b)) over 8 elements at a and b (16-byte aligned).
__device__ __forceinline__ float dot8(const bf16* a, const bf16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a), y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* ex = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ey = reinterpret_cast<const __nv_bfloat162*>(&y);
  float d = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 fa = __bfloat1622float2(ex[e]), fb = __bfloat1622float2(ey[e]);
    d = fmaf(fa.x, fb.x, fmaf(fa.y, fb.y, d));
  }
  return d;
}

__device__ __forceinline__ float dot8(const float* a, const float* b) {
  float d = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 x = reinterpret_cast<const float4*>(a)[h], y = reinterpret_cast<const float4*>(b)[h];
    d = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, d))));
  }
  return d;
}

// Threads a workspace row in the row pass: 8 at hd 64; 16 at hd 80, of
// which 10 hold 8 elements each.
template <int D>
__host__ __device__ constexpr int row_threads() {
  return D == HD ? 8 : 16;
}

// lse in log2 units and D = rowsum(f32(dO) * f32(out)) of each of the
// bh * tp workspace rows (row r of head h at h * tp + r), zero where r >= t:
// row_threads<D>() threads a row, 8 elements of out and dO each.
template <class T, int D = HD>
__global__ void __launch_bounds__(256)
flash_bwd_rows(const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ lse2, float* __restrict__ dsum, int n_rows, int t, int tp) {
  constexpr int TPR = row_threads<D>();
  const int idx = blockIdx.x * 256 + threadIdx.x;
  const int row = idx / TPR, part = idx % TPR;
  const int bh = row / tp, r = row % tp;
  const bool in = row < n_rows && r < t && (TPR * 8 == D || part < D / 8);
  float d = 0.f;
  if (in) {
    const size_t at = ((size_t)bh * t + r) * D + part * 8;
    d = dot8(o + at, dout + at);
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
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

// The tails' tiles at hd 80 (32 bytes a row, each 256-byte aligned, the
// whole a multiple of 1024 bytes); an empty base at hd 64.
template <int TAIL>
struct alignas(1024) DkvTails {
  bf16 kt[KV_KEYS * TAIL], vt[KV_KEYS * TAIL];
  bf16 qt[KV_STAGES][KV_BQ * TAIL], dt[KV_STAGES][KV_BQ * TAIL];
  __device__ uint32_t kt_at() const { return smem_u32(kt); }
  __device__ uint32_t vt_at() const { return smem_u32(vt); }
  __device__ uint32_t qt_at(int st) const { return smem_u32(qt[st]); }
  __device__ uint32_t dt_at(int st) const { return smem_u32(dt[st]); }
};
template <>
struct DkvTails<0> {
  __device__ uint32_t kt_at() const { return 0; }
  __device__ uint32_t vt_at() const { return 0; }
  __device__ uint32_t qt_at(int) const { return 0; }
  __device__ uint32_t dt_at(int) const { return 0; }
};

template <int D = HD>
struct DkvShared : DkvTails<tail_cols<D>()> {
  bf16 k[KV_KEYS * HD];  // the tile's keys, [key][dim], until the consumers hold them
  bf16 v[KV_KEYS * HD];
  DkvStage st[KV_STAGES];
  uint64_t full[KV_STAGES], empty[KV_STAGES], kv_full, kv_empty;
};
template <int D>
__host__ __device__ constexpr int kv_smem() {
  return (int)sizeof(DkvShared<D>) + 1024;  // + the alignment slack
}
template <int D>
__host__ __device__ constexpr int kv_stage_tx() {
  return 2 * KV_BQ * D * 2 + 2 * KV_BQ * 4;
}

// Start D (64 x N) += A (64 x 16K, bf16 fragments a[k] in registers) . B
// (16K x N), N = D (64 or 80) columns of B MN-major through the transpose
// bit: b its first 64 columns in the 128-byte swizzle (16 rows of k = 2048
// bytes a step), bt at hd 80 its 16-column tail in the 32-byte swizzle (512
// bytes a step) into D's last two 8-column groups. The caller fences and
// commits.
template <int D, int K>
__device__ __forceinline__ void product_tb(float (&d)[D / 8][4], const uint32_t (&a)[K][4],
                                           uint32_t b, uint32_t bt) {
  float (&dh)[HD / 8][4] = *reinterpret_cast<float (*)[HD / 8][4]>(&d[0]);
#pragma unroll
  for (int kk = 0; kk < K; ++kk) wgmma_rs_n64<1>(dh, a[kk], desc_sw128(b, 1024) + 128 * kk, 1);
  if constexpr (D > HD) {
    float (&dt)[(D - HD) / 8][4] = *reinterpret_cast<float (*)[(D - HD) / 8][4]>(&d[HD / 8]);
#pragma unroll
    for (int kk = 0; kk < K; ++kk) wgmma_rs_n16_tb(dt, a[kk], desc_sw32(bt) + 32 * kk);
  }
}

// dk, dv of 128-key tiles (tile = bh * n_kt + key tile: the tiles of one
// head run side by side and share its Q and dO in L2). D: the head dim; at
// 80 `tails` holds the maps of the rows' last 16 columns (last, so that the
// hd-64 instance's parameters lie where they lay before).
template <int D = HD>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dkv(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
              const float* __restrict__ lse2, const float* __restrict__ dsum,
              const uint8_t* __restrict__ valid, bf16* __restrict__ dk, bf16* __restrict__ dv,
              int heads, int t, int tp, int n_tiles, float scale,
              const __grid_constant__ BwdTails<tail_cols<D>()> tails) {
  constexpr int TAIL = tail_cols<D>(), KS = D / 16;  // k steps over the head dim
  extern __shared__ __align__(128) char smem_dyn[];
  DkvShared<D>& s = *reinterpret_cast<DkvShared<D>*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
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
        mbar_expect_tx(&s.kv_full, 2 * KV_KEYS * D * 2);
        tma_load_3d(s.k, &map_k, &s.kv_full, 0, kt * KV_KEYS, bh);
        tma_load_3d(s.v, &map_v, &s.kv_full, 0, kt * KV_KEYS, bh);
        if constexpr (TAIL > 0) {
          tma_load_3d(s.kt, &tails.k, &s.kv_full, HD, kt * KV_KEYS, bh);
          tma_load_3d(s.vt, &tails.v, &s.kv_full, HD, kt * KV_KEYS, bh);
        }
        const float* rl = lse2 + (size_t)bh * tp;
        const float* rd = dsum + (size_t)bh * tp;
        for (int qs = 0; qs < n_qs; ++qs, ++it) {
          const int st = it % KV_STAGES;
          mbar_wait(&s.empty[st], ((it / KV_STAGES) & 1) ^ 1);
          DkvStage& sb = s.st[st];
          mbar_expect_tx(&s.full[st], kv_stage_tx<D>());
          tma_load_3d(sb.q, &map_q, &s.full[st], 0, qs * KV_BQ, bh);
          tma_load_3d(sb.dout, &map_do, &s.full[st], 0, qs * KV_BQ, bh);
          if constexpr (TAIL > 0) {
            tma_load_3d(s.qt[st], &tails.q, &s.full[st], HD, qs * KV_BQ, bh);
            tma_load_3d(s.dt[st], &tails.dout, &s.full[st], HD, qs * KV_BQ, bh);
          }
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
      uint32_t kf[KS][4], vf[KS][4];
      mbar_wait(&s.kv_full, i & 1);
      load_a_frags(*reinterpret_cast<uint32_t (*)[HD / 16][4]>(&kf[0]), smem_u32(s.k),
                   64 * wg + 16 * w, lane);
      load_a_frags(*reinterpret_cast<uint32_t (*)[HD / 16][4]>(&vf[0]), smem_u32(s.v),
                   64 * wg + 16 * w, lane);
      if constexpr (TAIL > 0) {
        load_a_tail(kf[HD / 16], s.kt_at(), 64 * wg + 16 * w, lane);
        load_a_tail(vf[HD / 16], s.vt_at(), 64 * wg + 16 * w, lane);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.kv_empty);

      float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;
      uint32_t pa[KV_BQ / 16][4] = {}, dsa[KV_BQ / 16][4] = {};
      int prev = 0;  // the stage whose dV and dK were issued last
      for (int qs = 0; qs < n_qs; ++qs, ++it) {
        const int st = it % KV_STAGES;
        DkvStage& sb = s.st[st];
        const uint32_t qa = smem_u32(sb.q), da = smem_u32(sb.dout);
        const uint32_t qta = s.qt_at(st), dta = s.dt_at(st);  // the tails (hd 80)
        mbar_wait(&s.full[st], (it / KV_STAGES) & 1);
        // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries), two groups
        float sa[KV_BQ / 8][4], dpa[KV_BQ / 8][4];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_rs_n64<0>(sa, kf[kk], desc_sw128(qa, 16) + 2 * kk, kk);
        if constexpr (TAIL > 0) wgmma_rs_n64<0>(sa, kf[HD / 16], desc_sw32(qta), 1);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_rs_n64<0>(dpa, vf[kk], desc_sw128(da, 16) + 2 * kk, kk);
        if constexpr (TAIL > 0) wgmma_rs_n64<0>(dpa, vf[HD / 16], desc_sw32(dta), 1);
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
        // dV += bf16(P^T) dO (16 queries = 2048 bytes a step, 512 of the tail)
        wgmma_fence();
        product_tb<D>(dva, pa, da, dta);
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
        product_tb<D>(dka, dsa, qa, qta);
        wgmma_commit();
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
      fence_regs(pa);
      fence_regs(dsa);
      if (lane == 0) mbar_arrive(&s.empty[prev]);

      const size_t base = (size_t)bh * t * D;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int key = k0 + 16 * w + g + 8 * rr;
        if (key >= t) continue;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          const size_t at = base + (size_t)key * D + dt * 8 + 2 * tg;
          *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
              dka[dt][2 * rr] * scale, dka[dt][2 * rr + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + at) =
              __floats2bfloat162_rn(dva[dt][2 * rr], dva[dt][2 * rr + 1]);
        }
      }
    }
  }
}

// The tails' tiles at hd 80; an empty base at hd 64.
template <int TAIL>
struct alignas(1024) DqTails {
  bf16 qt[2][DQ_ROWS * TAIL], dt[2][DQ_ROWS * TAIL];
  bf16 kt[DQ_STAGES][DQ_KEYS * TAIL], vt[DQ_STAGES][DQ_KEYS * TAIL];
  __device__ uint32_t qt_at(int b) const { return smem_u32(qt[b]); }
  __device__ uint32_t dt_at(int b) const { return smem_u32(dt[b]); }
  __device__ uint32_t kt_at(int st) const { return smem_u32(kt[st]); }
  __device__ uint32_t vt_at(int st) const { return smem_u32(vt[st]); }
};
template <>
struct DqTails<0> {
  __device__ uint32_t qt_at(int) const { return 0; }
  __device__ uint32_t dt_at(int) const { return 0; }
  __device__ uint32_t kt_at(int) const { return 0; }
  __device__ uint32_t vt_at(int) const { return 0; }
};

template <int D = HD>
struct DqShared : DqTails<tail_cols<D>()> {
  bf16 q[2][DQ_ROWS * HD];  // the tile's queries, and the next tile's
  bf16 dout[2][DQ_ROWS * HD];
  bf16 k[DQ_STAGES][DQ_KEYS * HD];
  bf16 v[DQ_STAGES][DQ_KEYS * HD];
  uint64_t q_full[2], q_empty[2], kv_full[DQ_STAGES], kv_empty[DQ_STAGES];
};
template <int D>
__host__ __device__ constexpr int dq_smem() {
  return (int)sizeof(DqShared<D>) + 1024;
}

// dq of 128-query tiles (tile = bh * n_qt + query tile: the tiles of one
// head run side by side and share its K and V in L2). D: the head dim, its
// tails' maps last at 80.
template <int D = HD>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dq(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
             const float* __restrict__ lse2, const float* __restrict__ dsum,
             const uint8_t* __restrict__ valid, bf16* __restrict__ dq, int heads, int t, int tp,
             int n_tiles, float scale, const __grid_constant__ BwdTails<tail_cols<D>()> tails) {
  constexpr int TAIL = tail_cols<D>();
  extern __shared__ __align__(128) char smem_dyn[];
  DqShared<D>& s = *reinterpret_cast<DqShared<D>*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
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
        mbar_expect_tx(&s.q_full[qb], 2 * DQ_ROWS * D * 2);
        tma_load_3d(s.q[qb], &map_q, &s.q_full[qb], 0, q0, bh);
        tma_load_3d(s.dout[qb], &map_do, &s.q_full[qb], 0, q0, bh);
        if constexpr (TAIL > 0) {
          tma_load_3d(s.qt[qb], &tails.q, &s.q_full[qb], HD, q0, bh);
          tma_load_3d(s.dt[qb], &tails.dout, &s.q_full[qb], HD, q0, bh);
        }
        for (int j = 0; j < n_kt; ++j, ++it) {
          const int st = it % DQ_STAGES;
          mbar_wait(&s.kv_empty[st], ((it / DQ_STAGES) & 1) ^ 1);
          mbar_expect_tx(&s.kv_full[st], 2 * DQ_KEYS * D * 2);
          tma_load_3d(s.k[st], &map_k, &s.kv_full[st], 0, j * DQ_KEYS, bh);
          tma_load_3d(s.v[st], &map_v, &s.kv_full[st], 0, j * DQ_KEYS, bh);
          if constexpr (TAIL > 0) {
            tma_load_3d(s.kt[st], &tails.k, &s.kv_full[st], HD, j * DQ_KEYS, bh);
            tma_load_3d(s.vt[st], &tails.v, &s.kv_full[st], HD, j * DQ_KEYS, bh);
          }
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
      float dqa[D / 8][4];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[dt][e] = 0.f;
      uint32_t dsa[DQ_KEYS / 16][4] = {};
      mbar_wait(&s.q_full[qb], (i >> 1) & 1);
      const uint32_t qs = smem_u32(s.q[qb]) + wg * 64 * ROW;
      const uint32_t ds = smem_u32(s.dout[qb]) + wg * 64 * ROW;
      const uint32_t qts = s.qt_at(qb) + wg * 64 * 2 * TAIL;  // the tails (hd 80)
      const uint32_t dts = s.dt_at(qb) + wg * 64 * 2 * TAIL;
      int prev = 0;  // the stage whose dQ product was issued last
      for (int j = 0; j < n_kt; ++j, ++it) {
        const int st = it % DQ_STAGES;
        mbar_wait(&s.kv_full[st], (it / DQ_STAGES) & 1);
        // S = Q K^T and dP = dO V^T (64 queries x 128 keys), two groups
        float sa[DQ_KEYS / 8][4], dpa[DQ_KEYS / 8][4];
        wgmma_fence();
        start_scores<DQ_KEYS, false, D>(sa, qs, smem_u32(s.k[st]), qts, s.kt_at(st));
        start_scores<DQ_KEYS, false, D>(dpa, ds, smem_u32(s.v[st]), dts, s.vt_at(st));
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
        start_pv<DQ_KEYS, D>(dqa, dsa, smem_u32(s.k[st]), s.kt_at(st));
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(dqa);
      fence_regs(dsa);
      if (lane == 0) {
        mbar_arrive(&s.kv_empty[prev]);
        mbar_arrive(&s.q_empty[qb]);
      }

      const size_t base = (size_t)bh * t * D;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = q0 + 16 * warp + g + 8 * rr;
        if (row >= t) continue;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
          *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row * D + dt * 8 + 2 * tg) =
              __floats2bfloat162_rn(dqa[dt][2 * rr] * scale, dqa[dt][2 * rr + 1] * scale);
      }
    }
  }
}

// rows: the (2, bh, round_up(t, 128)) f32 workspace (lse in log2 units,
// then D).
template <int D>
int launch_bwd_bf16(const void* q, const void* k, const void* v, const void* o, const float* lse,
                const void* dout, const uint8_t* valid, void* dq, void* dk, void* dv, float* rows,
                int bh, int heads, int t, float scale, cudaStream_t st) {
  const int tp = (t + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  float* lse2 = rows;
  float* dsum = rows + (size_t)bh * tp;
  const long long threads = (long long)bh * tp * row_threads<D>();
  if (threads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap mq64, mdo64, mq128, mdo128, mk, mv;
  int err = head_map<D>(&mq64, q, bh, t, KV_BQ);
  if (err == 0) err = head_map<D>(&mdo64, dout, bh, t, KV_BQ);
  if (err == 0) err = head_map<D>(&mq128, q, bh, t, DQ_ROWS);
  if (err == 0) err = head_map<D>(&mdo128, dout, bh, t, DQ_ROWS);
  if (err == 0) err = head_map<D>(&mk, k, bh, t, KV_KEYS);
  if (err == 0) err = head_map<D>(&mv, v, bh, t, KV_KEYS);
  static_assert(KV_KEYS == DQ_KEYS, "one K and one V map for both kernels");
  BwdTails<tail_cols<D>()> kv_tails, dq_tails;
  if constexpr (tail_cols<D>() > 0) {  // the rows' last 16 columns
    if (err == 0) err = tail_map<D>(&kv_tails.q, q, bh, t, KV_BQ);
    if (err == 0) err = tail_map<D>(&kv_tails.dout, dout, bh, t, KV_BQ);
    if (err == 0) err = tail_map<D>(&kv_tails.k, k, bh, t, KV_KEYS);
    if (err == 0) err = tail_map<D>(&kv_tails.v, v, bh, t, KV_KEYS);
    if (err == 0) err = tail_map<D>(&dq_tails.q, q, bh, t, DQ_ROWS);
    if (err == 0) err = tail_map<D>(&dq_tails.dout, dout, bh, t, DQ_ROWS);
    dq_tails.k = kv_tails.k;
    dq_tails.v = kv_tails.v;
  }
  if (err != 0) return err;
  static_assert(kv_smem<D>() <= 232448 && dq_smem<D>() <= 232448, "bf16 backward shared memory");
  static LaunchSetup kv_setup, dq_setup;
  int sms = 0;
  err = kv_setup.sms(flash_bwd_dkv<D>, kv_smem<D>(), &sms);
  if (err == 0) err = dq_setup.sms(flash_bwd_dq<D>, dq_smem<D>(), &sms);
  if (err != 0) return err;

  flash_bwd_rows<bf16, D><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, lse2, dsum, bh * tp, t,
      tp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int kv_tiles = bh * ((t + KV_KEYS - 1) / KV_KEYS);
  flash_bwd_dkv<D><<<kv_tiles < sms ? kv_tiles : sms, BWD_THREADS, kv_smem<D>(), st>>>(
      mq64, mk, mv, mdo64, lse2, dsum, valid, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      heads, t, tp, kv_tiles, scale, kv_tails);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int dq_tiles = bh * ((t + DQ_ROWS - 1) / DQ_ROWS);
  flash_bwd_dq<D><<<dq_tiles < sms ? dq_tiles : sms, BWD_THREADS, dq_smem<D>(), st>>>(
      mq128, mk, mv, mdo128, lse2, dsum, valid, static_cast<bf16*>(dq), heads, t, tp, dq_tiles,
      scale, dq_tails);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ f32 / Hopper, 3xTF32
constexpr int FK_KEYS = 128;   // keys of an f32 dk/dv tile: 64 a consumer warpgroup
constexpr int FK_BQ = 32;      // queries of an f32 dk/dv stage
constexpr int FK_STAGES = 2;   // raw Q/dO stages in the dk/dv ring (hd 64)
constexpr int FQ_ROWS = 128;   // queries of an f32 dq tile: 64 a consumer warpgroup
constexpr int FQ_BK = 32;      // keys of an f32 dq stage
constexpr int FQ_STAGES = 3;   // raw K/V stages in the dq ring (hd 64)
constexpr int PAIR_BAR = 1;    // named barrier of both consumer warpgroups (2 + wg: one's own)
constexpr int SMEM_MAX = 232448;
static_assert(FK_KEYS == 64 * BWD_WGS && FQ_ROWS == 64 * BWD_WGS, "64 rows a warpgroup");
static_assert(FK_BQ == 32 && FQ_BK == 32, "a stage is one 32-row tile: one lane a row");

// Raw ring stages of the f32 kernels by head dim (hd 80: shared memory).
template <int D>
__host__ __device__ constexpr int fk_stages() {
  return D == HD ? FK_STAGES : 1;
}
template <int D>
__host__ __device__ constexpr int fq_stages() {
  return D == HD ? FQ_STAGES : 2;
}

// A stage's split Q and dO, [query][dim] in 32-column parts, TF32 big and
// small (COLS: 32 a part).
template <int COLS>
struct F32Rows {
  float qb[FK_BQ * COLS], qs[FK_BQ * COLS];
  float gb[FK_BQ * COLS], gs[FK_BQ * COLS];
};

// Shared memory of the f32 dk/dv kernel at head dim D. hd 64 keeps K and
// the stage's split copies apart; hd 80 (below) lays them over each other.
template <int D>
struct alignas(1024) F32DkvShared {
  static constexpr int COLS = 32 * f32_parts<D>(), STAGES = fk_stages<D>();
  float k[FK_KEYS * COLS];                       // the tile's K, until held as register A
  float vb[FK_KEYS * COLS], vs[FK_KEYS * COLS];  // its V: TF32 big (over TMA's f32), small
  F32Rows<COLS> sp;                              // the stage's Q and dO
  float qtb[D * FK_BQ], qts[D * FK_BQ];    // Q^T, [dim][query in tf32_perm order]
  float gtb[D * FK_BQ], gts[D * FK_BQ];    // dO^T
  float raw_q[STAGES][FK_BQ * COLS], raw_g[STAGES][FK_BQ * COLS];  // the TMA ring
  float lse[STAGES][FK_BQ], dsum[STAGES][FK_BQ];
  uint64_t full[STAGES], empty[STAGES], kv_full, kv_empty;
};
// hd 80: K is free once both warpgroups hold it in registers, before the
// first stage is split, so the stage's copies take its buffer (both 48 KB).
template <>
struct alignas(1024) F32DkvShared<HD + 16> {
  static constexpr int D = HD + 16, COLS = 32 * f32_parts<D>(), STAGES = fk_stages<D>();
  union {
    float k[FK_KEYS * COLS];
    F32Rows<COLS> sp;
  };
  float vb[FK_KEYS * COLS], vs[FK_KEYS * COLS];
  float qtb[D * FK_BQ], qts[D * FK_BQ];
  float gtb[D * FK_BQ], gts[D * FK_BQ];
  float raw_q[STAGES][FK_BQ * COLS], raw_g[STAGES][FK_BQ * COLS];
  float lse[STAGES][FK_BQ], dsum[STAGES][FK_BQ];
  uint64_t full[STAGES], empty[STAGES], kv_full, kv_empty;
};
static_assert(sizeof(F32Rows<96>) == FK_KEYS * 96 * 4, "hd 80: the split stage fills K's buffer");
template <int D>
__host__ __device__ constexpr int fk_smem() {
  return (int)sizeof(F32DkvShared<D>) + 1024;  // + the alignment slack
}

// A stage's split K and V, [key][dim] in 32-column parts, big and small.
template <int COLS>
struct F32Keys {
  float kb[FQ_BK * COLS], ks[FQ_BK * COLS];
  float vb[FQ_BK * COLS], vs[FQ_BK * COLS];
};

// Shared memory of the f32 dq kernel; at hd 80 the tile's Q and the
// stage's split K and V lie over each other, as K and Q, dO do in dk/dv.
template <int D>
struct alignas(1024) F32DqShared {
  static constexpr int COLS = 32 * f32_parts<D>(), STAGES = fq_stages<D>();
  float q[FQ_ROWS * COLS];                       // the tile's Q, until held as register A
  float gb[FQ_ROWS * COLS], gs[FQ_ROWS * COLS];  // its dO: TF32 big (over TMA's f32), small
  F32Keys<COLS> sp;                              // the stage's K and V
  float ktb[D * FQ_BK], kts[D * FQ_BK];    // K^T, [dim][key in tf32_perm order]
  float raw_k[STAGES][FQ_BK * COLS], raw_v[STAGES][FQ_BK * COLS];  // the TMA ring
  uint64_t q_full, q_empty, full[STAGES], empty[STAGES];
};
template <>
struct alignas(1024) F32DqShared<HD + 16> {
  static constexpr int D = HD + 16, COLS = 32 * f32_parts<D>(), STAGES = fq_stages<D>();
  union {
    float q[FQ_ROWS * COLS];
    F32Keys<COLS> sp;
  };
  float gb[FQ_ROWS * COLS], gs[FQ_ROWS * COLS];
  float ktb[D * FQ_BK], kts[D * FQ_BK];
  float raw_k[STAGES][FQ_BK * COLS], raw_v[STAGES][FQ_BK * COLS];
  uint64_t q_full, q_empty, full[STAGES], empty[STAGES];
};
static_assert(sizeof(F32Keys<96>) == FQ_ROWS * 96 * 4, "hd 80: the split stage fills Q's buffer");
template <int D>
__host__ __device__ constexpr int fq_smem() {
  return (int)sizeof(F32DqShared<D>) + 1024;
}
static_assert(fk_smem<HD>() <= SMEM_MAX && fk_smem<HD + 16>() <= SMEM_MAX,
              "f32 dk/dv shared memory");
static_assert(fq_smem<HD>() <= SMEM_MAX && fq_smem<HD + 16>() <= SMEM_MAX,
              "f32 dq shared memory");

// One raw 32-row stage split by the consumer warps (8 dims a warp; at hd 80
// warps 0 and 1 take dims 64-79 too): [row][dim] big and small, and the
// transposed [dim][row] copies.
template <int D>
__device__ __forceinline__ void split_stage_wide(const float* raw, float* b, float* s, float* tb,
                                                 float* ts, int warp, int lane) {
  split_stage<D>(raw, b, s, tb, ts, warp, lane);
  if constexpr (D > 8 * BWD_CONSUMERS)
    if (warp < D / 8 - BWD_CONSUMERS) split_stage<D>(raw, b, s, tb, ts, warp + BWD_CONSUMERS, lane);
}

// dk, dv of 128-key tiles in f32 (tile = bh * n_kt + key tile); D the head
// dim.
template <int D = HD>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dkv_f32(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse2,
                  const float* __restrict__ dsum, const uint8_t* __restrict__ valid,
                  float* __restrict__ dk, float* __restrict__ dv, int heads, int t, int tp,
                  int n_tiles, float scale) {
  typedef F32DkvShared<D> Shared;
  constexpr int STAGES = Shared::STAGES, COLS = Shared::COLS;
  extern __shared__ __align__(128) char smem_dyn[];
  Shared& s = aligned_smem<Shared>(smem_dyn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_kt = (t + FK_KEYS - 1) / FK_KEYS, n_qs = (t + FK_BQ - 1) / FK_BQ;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
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
        mbar_expect_tx(&s.kv_full, 2 * FK_KEYS * COLS * 4);
        tma_load_f32<FK_KEYS, D>(s.k, &map_k, &s.kv_full, 0, kt * FK_KEYS, bh);
        tma_load_f32<FK_KEYS, D>(s.vb, &map_v, &s.kv_full, 0, kt * FK_KEYS, bh);
        const float* rl = lse2 + (size_t)bh * tp;
        const float* rd = dsum + (size_t)bh * tp;
        for (int qs = 0; qs < n_qs; ++qs, ++it) {
          const int st = it % STAGES;
          mbar_wait(&s.empty[st], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&s.full[st], 2 * FK_BQ * COLS * 4 + 2 * FK_BQ * 4);
          tma_load_f32<FK_BQ, D>(s.raw_q[st], &map_q, &s.full[st], 0, qs * FK_BQ, bh);
          tma_load_f32<FK_BQ, D>(s.raw_g[st], &map_do, &s.full[st], 0, qs * FK_BQ, bh);
          bulk_load(s.lse[st], rl + qs * FK_BQ, FK_BQ * 4, &s.full[st]);
          bulk_load(s.dsum[st], rd + qs * FK_BQ, FK_BQ * 4, &s.full[st]);
        }
      }
    }
  } else {  // -------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(BWD_CREGS));
    const int wg = warp / 4, w = warp % 4, g = lane / 4, tg = lane % 4;
    const int t128 = threadIdx.x % 128;
    const float s2 = scale * LOG2E;  // score to log2 units
    // this warpgroup's 64 key rows of V (64 rows of 128 bytes a half)
    const uint32_t vb = smem_u32(s.vb) + wg * 64 * 128, vs = smem_u32(s.vs) + wg * 64 * 128;
    uint32_t it = 0;
    int i = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const int bh = tile / n_kt, kt = tile % n_kt;
      const uint8_t* vrow = valid ? valid + (size_t)(bh / heads) * t : nullptr;
      // this thread's keys (rows of S^T) k0 + 16w + g + 8rr: a valid key's
      // score scales to log2 units, a masked one is -1e9, one beyond t -inf
      const int k0 = kt * FK_KEYS + 64 * wg;
      bool ok[2];
      float kfill[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int key = k0 + 16 * w + g + 8 * rr;
        const bool in = key < t;
        ok[rr] = in && (vrow == nullptr || __ldg(vrow + key) != 0);
        kfill[rr] = in ? NEG2 : -INFINITY;
      }

      // K rows of this warp as register A, split; V rows of this
      // warpgroup split in place (at hd 80 the first stage's split then
      // takes K's buffer: after the pair barrier below, both hold K)
      mbar_wait(&s.kv_full, i & 1);
      float kfb[D / 8][4], kfs[D / 8][4];
      load_a_f32<FK_KEYS, D>(s.k, 16 * warp + g, tg, kfb, kfs);
      split_rows<FK_KEYS, D>(s.vb, s.vs, 64 * wg, t128);
      fence_proxy_async();
      bar_sync(2 + wg, 128);

      float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;
      for (int qs = 0; qs < n_qs; ++qs, ++it) {
        const int st = it % STAGES;
        mbar_wait(&s.full[st], (it / STAGES) & 1);
        bar_sync(PAIR_BAR, 128 * BWD_WGS);  // both warpgroups' last products are done
        split_stage_wide<D>(s.raw_q[st], s.sp.qb, s.sp.qs, s.qtb, s.qts, warp, lane);
        split_stage_wide<D>(s.raw_g[st], s.sp.gb, s.sp.gs, s.gtb, s.gts, warp, lane);
        float2 lr[FK_BQ / 8], dd[FK_BQ / 8];  // columns 8j + 2tg + e%2 are queries
#pragma unroll
        for (int j = 0; j < FK_BQ / 8; ++j) {
          lr[j] = *reinterpret_cast<const float2*>(&s.lse[st][8 * j + 2 * tg]);
          dd[j] = *reinterpret_cast<const float2*>(&s.dsum[st][8 * j + 2 * tg]);
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&s.empty[st]);
        bar_sync(PAIR_BAR, 128 * BWD_WGS);  // the split stage is written

        // S^T = K Q^T and dP^T = V dO^T (64 keys x 32 queries), two groups
        float sa[FK_BQ / 8][4], dpa[FK_BQ / 8][4];
        wgmma_fence();
        product_rs_n32<BY_STEP, D>(sa, kfb, kfs, smem_u32(s.sp.qb), smem_u32(s.sp.qs));
        wgmma_commit();
        product_ss<FK_KEYS, D>(dpa, vb, vs, smem_u32(s.sp.gb), smem_u32(s.sp.gs));
        wgmma_commit();
        float pb[FK_BQ / 8][4], ps[FK_BQ / 8][4], db[FK_BQ / 8][4], ds[FK_BQ / 8][4];
        if constexpr (D == HD) {
          wgmma_wait<1>();  // S^T
          fence_regs(sa);
          // P^T = exp2(S^T s2 - lse), in f32
#pragma unroll
          for (int j = 0; j < FK_BQ / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float le = (e & 1) ? lr[j].y : lr[j].x;
              sa[j][e] = ex2(ok[e / 2] ? fmaf(sa[j][e], s2, -le) : kfill[e / 2] - le);
            }
            tf32_a_frag(sa[j], pb[j], ps[j]);
          }
          // dV += P^T dO while dP^T finishes
          wgmma_fence();
          product_rs(dva, pb, ps, smem_u32(s.gtb), smem_u32(s.gts));
          wgmma_commit();
          wgmma_wait<1>();  // dP^T
          fence_regs(dpa);
          // dS^T = P^T (dP^T - D)
#pragma unroll
          for (int j = 0; j < FK_BQ / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpa[j][e] = sa[j][e] * (dpa[j][e] - ((e & 1) ? dd[j].y : dd[j].x));
            tf32_a_frag(dpa[j], db[j], ds[j]);
          }
        } else {
          // registers: P^T and dS^T in place, then each split as its
          // product starts, so P^T in f32 is dead before dS^T is split
          wgmma_wait<0>();  // S^T and dP^T
          fence_regs(sa);
          fence_regs(dpa);
#pragma unroll
          for (int j = 0; j < FK_BQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float le = (e & 1) ? lr[j].y : lr[j].x;
              sa[j][e] = ex2(ok[e / 2] ? fmaf(sa[j][e], s2, -le) : kfill[e / 2] - le);
              dpa[j][e] = sa[j][e] * (dpa[j][e] - ((e & 1) ? dd[j].y : dd[j].x));
            }
#pragma unroll
          for (int j = 0; j < FK_BQ / 8; ++j) tf32_a_frag(sa[j], pb[j], ps[j]);
          // dV += P^T dO
          wgmma_fence();
          product_rs<BY_STEP, D>(dva, pb, ps, smem_u32(s.gtb), smem_u32(s.gts));
#pragma unroll
          for (int j = 0; j < FK_BQ / 8; ++j) tf32_a_frag(dpa[j], db[j], ds[j]);
        }
        // dK += dS^T Q
        wgmma_fence();
        product_rs<BY_STEP, D>(dka, db, ds, smem_u32(s.qtb), smem_u32(s.qts));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dka);
        fence_regs(dva);
        fence_regs(pb);
        fence_regs(ps);
        fence_regs(db);
        fence_regs(ds);
      }
      fence_regs(kfb);
      fence_regs(kfs);
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.kv_empty);

      const size_t base = (size_t)bh * t * D;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int key = k0 + 16 * w + g + 8 * rr;
        if (key >= t) continue;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          const size_t at = base + (size_t)key * D + dt * 8 + 2 * tg;
          *reinterpret_cast<float2*>(dk + at) =
              make_float2(dka[dt][2 * rr] * scale, dka[dt][2 * rr + 1] * scale);
          *reinterpret_cast<float2*>(dv + at) = make_float2(dva[dt][2 * rr], dva[dt][2 * rr + 1]);
        }
      }
    }
  }
}

// dq of 128-query tiles in f32 (tile = bh * n_qt + query tile); D the head
// dim.
template <int D = HD>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dq_f32(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse2,
                 const float* __restrict__ dsum, const uint8_t* __restrict__ valid,
                 float* __restrict__ dq, int heads, int t, int tp, int n_tiles, float scale) {
  typedef F32DqShared<D> Shared;
  constexpr int STAGES = Shared::STAGES, COLS = Shared::COLS;
  extern __shared__ __align__(128) char smem_dyn[];
  Shared& s = aligned_smem<Shared>(smem_dyn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_qt = (t + FQ_ROWS - 1) / FQ_ROWS, n_kt = (t + FQ_BK - 1) / FQ_BK;

  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
    mbar_init(&s.q_empty, BWD_CONSUMERS);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], BWD_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= BWD_CONSUMERS) {  // --------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == BWD_CONSUMERS && lane == 0) {
      uint32_t it = 0;  // K/V stages requested
      int i = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
        const int bh = tile / n_qt, q0 = (tile % n_qt) * FQ_ROWS;
        mbar_wait(&s.q_empty, (i & 1) ^ 1);
        mbar_expect_tx(&s.q_full, 2 * FQ_ROWS * COLS * 4);
        tma_load_f32<FQ_ROWS, D>(s.q, &map_q, &s.q_full, 0, q0, bh);
        tma_load_f32<FQ_ROWS, D>(s.gb, &map_do, &s.q_full, 0, q0, bh);
        for (int j = 0; j < n_kt; ++j, ++it) {
          const int st = it % STAGES;
          mbar_wait(&s.empty[st], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&s.full[st], 2 * FQ_BK * COLS * 4);
          tma_load_f32<FQ_BK, D>(s.raw_k[st], &map_k, &s.full[st], 0, j * FQ_BK, bh);
          tma_load_f32<FQ_BK, D>(s.raw_v[st], &map_v, &s.full[st], 0, j * FQ_BK, bh);
        }
      }
    }
  } else {  // -------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(BWD_CREGS));
    const int wg = warp / 4, g = lane / 4, tg = lane % 4;
    const int t128 = threadIdx.x % 128;
    const float s2 = scale * LOG2E;
    const uint32_t gb = smem_u32(s.gb) + wg * 64 * 128, gs = smem_u32(s.gs) + wg * 64 * 128;
    uint32_t it = 0;
    int i = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const int bh = tile / n_qt, q0 = (tile % n_qt) * FQ_ROWS;
      const uint8_t* vrow = valid ? valid + (size_t)(bh / heads) * t : nullptr;
      // this thread's rows q0 + 16 warp + g + 8rr: lse (log2 units) and D
      float lr[2], dr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const size_t at = (size_t)bh * tp + q0 + 16 * warp + g + 8 * rr;
        lr[rr] = __ldg(lse2 + at);
        dr[rr] = __ldg(dsum + at);
      }
      // Q rows of this warp as register A, split; dO rows of this
      // warpgroup split in place (at hd 80 the first stage's split then
      // takes Q's buffer: after the pair barrier below, both hold Q)
      mbar_wait(&s.q_full, i & 1);
      float qfb[D / 8][4], qfs[D / 8][4];
      load_a_f32<FQ_ROWS, D>(s.q, 16 * warp + g, tg, qfb, qfs);
      split_rows<FQ_ROWS, D>(s.gb, s.gs, 64 * wg, t128);
      fence_proxy_async();
      bar_sync(2 + wg, 128);

      float dqa[D / 8][4];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[dt][e] = 0.f;
      for (int j = 0; j < n_kt; ++j, ++it) {
        const int st = it % STAGES;
        mbar_wait(&s.full[st], (it / STAGES) & 1);
        bar_sync(PAIR_BAR, 128 * BWD_WGS);  // both warpgroups' last products are done
        split_stage_wide<D>(s.raw_k[st], s.sp.kb, s.sp.ks, s.ktb, s.kts, warp, lane);
        split_stage_wide<D>(s.raw_v[st], s.sp.vb, s.sp.vs, nullptr, nullptr, warp, lane);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&s.empty[st]);
        bar_sync(PAIR_BAR, 128 * BWD_WGS);  // the split stage is written

        // S = Q K^T and dP = dO V^T (64 queries x 32 keys), two groups
        float sa[FQ_BK / 8][4], dpa[FQ_BK / 8][4];
        wgmma_fence();
        product_rs_n32<BY_STEP, D>(sa, qfb, qfs, smem_u32(s.sp.kb), smem_u32(s.sp.ks));
        wgmma_commit();
        product_ss<FQ_ROWS, D>(dpa, gb, gs, smem_u32(s.sp.vb), smem_u32(s.sp.vs));
        wgmma_commit();
        wgmma_wait<1>();  // S
        fence_regs(sa);
        // P = exp2(S s2 - lse): keys 8jj + 2tg + e%2 of the stage; a valid
        // key's score scales, a masked one is -1e9, one beyond t -inf
        const int kb0 = j * FQ_BK;
        const bool all_in = vrow == nullptr && kb0 + FQ_BK <= t;
#pragma unroll
        for (int jj = 0; jj < FQ_BK / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float l = lr[e / 2];
            float x = fmaf(sa[jj][e], s2, -l);
            if (!all_in) {
              const int key = kb0 + 8 * jj + 2 * tg + (e & 1);
              const bool in = key < t;
              if (!(in && (vrow == nullptr || __ldg(vrow + key) != 0)))
                x = (in ? NEG2 : -INFINITY) - l;
            }
            sa[jj][e] = ex2(x);
          }
        wgmma_wait<0>();  // dP
        fence_regs(dpa);
        // dS = P (dP - D)
        float db[FQ_BK / 8][4], ds[FQ_BK / 8][4];
#pragma unroll
        for (int jj = 0; jj < FQ_BK / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dpa[jj][e] = sa[jj][e] * (dpa[jj][e] - dr[e / 2]);
          tf32_a_frag(dpa[jj], db[jj], ds[jj]);
        }
        // dQ += dS K
        wgmma_fence();
        product_rs<BY_STEP, D>(dqa, db, ds, smem_u32(s.ktb), smem_u32(s.kts));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqa);
        fence_regs(db);
        fence_regs(ds);
      }
      fence_regs(qfb);
      fence_regs(qfs);
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.q_empty);

      const size_t base = (size_t)bh * t * D;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = q0 + 16 * warp + g + 8 * rr;
        if (row >= t) continue;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
          *reinterpret_cast<float2*>(dq + base + (size_t)row * D + dt * 8 + 2 * tg) =
              make_float2(dqa[dt][2 * rr] * scale, dqa[dt][2 * rr + 1] * scale);
      }
    }
  }
}

// A 3-D map over one (bh, t, D) f32 operand in boxes of `rows` rows x 32
// columns; rows beyond t, and columns beyond D, read as zeros.
template <int D>
inline int head_map_f32(CUtensorMap* map, const void* base, int bh, int t, int rows) {
  return encode_map_f32(map, base, D, t, bh, D, (long long)t * D, rows);
}

template <int D>
int launch_bwd_f32(const float* q, const float* k, const float* v, const float* o,
                   const float* lse, const float* dout, const uint8_t* valid, float* dq, float* dk,
                   float* dv, float* rows, int bh, int heads, int t, float scale, cudaStream_t st) {
  const int tp = (t + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  float* lse2 = rows;
  float* dsum = rows + (size_t)bh * tp;
  const long long threads = (long long)bh * tp * row_threads<D>();
  if (threads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap kv_q, kv_do, kv_k, kv_v, dq_q, dq_do, dq_k, dq_v;
  int err = head_map_f32<D>(&kv_q, q, bh, t, FK_BQ);
  if (err == 0) err = head_map_f32<D>(&kv_do, dout, bh, t, FK_BQ);
  if (err == 0) err = head_map_f32<D>(&kv_k, k, bh, t, FK_KEYS);
  if (err == 0) err = head_map_f32<D>(&kv_v, v, bh, t, FK_KEYS);
  if (err == 0) err = head_map_f32<D>(&dq_q, q, bh, t, FQ_ROWS);
  if (err == 0) err = head_map_f32<D>(&dq_do, dout, bh, t, FQ_ROWS);
  if (err == 0) err = head_map_f32<D>(&dq_k, k, bh, t, FQ_BK);
  if (err == 0) err = head_map_f32<D>(&dq_v, v, bh, t, FQ_BK);
  if (err != 0) return err;
  static LaunchSetup kv_setup, dq_setup;
  int sms = 0;
  err = kv_setup.sms(flash_bwd_dkv_f32<D>, fk_smem<D>(), &sms);
  if (err == 0) err = dq_setup.sms(flash_bwd_dq_f32<D>, fq_smem<D>(), &sms);
  if (err != 0) return err;

  flash_bwd_rows<float, D><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      o, dout, lse, lse2, dsum, bh * tp, t, tp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int kv_tiles = bh * ((t + FK_KEYS - 1) / FK_KEYS);
  flash_bwd_dkv_f32<D><<<kv_tiles < sms ? kv_tiles : sms, BWD_THREADS, fk_smem<D>(), st>>>(
      kv_q, kv_k, kv_v, kv_do, lse2, dsum, valid, dk, dv, heads, t, tp, kv_tiles, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int dq_tiles = bh * ((t + FQ_ROWS - 1) / FQ_ROWS);
  flash_bwd_dq_f32<D><<<dq_tiles < sms ? dq_tiles : sms, BWD_THREADS, fq_smem<D>(), st>>>(
      dq_q, dq_k, dq_v, dq_do, lse2, dsum, valid, dq, heads, t, tp, dq_tiles, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (bh, t, head_dim) contiguous each, head_dim
// 64 or 80, 16-byte aligned, all float32 (dtype 0) or all bfloat16 (dtype
// 1); lse: (bh, t)
// float32; valid: (bh / heads, t) bytes, nonzero = attend, or null (all
// valid). rows: a (2, bh, round_up(t, 128)) float32 workspace that needs no
// initialisation. device: the tensors' CUDA device, made current on this
// thread (the backward runs on autograd's worker thread, where
// cuTensorMapEncodeTiled refuses every address without a current context).
// Returns a cudaError_t (0 = launched).
extern "C" int vipers_flash_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const float* lse, const void* dout,
                                          const uint8_t* valid, void* dq, void* dk, void* dv,
                                          float* rows, int bh, int heads, int t, int head_dim,
                                          float scale, int dtype, int device, void* stream) {
  const bool hd80 = head_dim == HD + 16;
  if ((head_dim != HD && !hd80) || bh <= 0 || heads <= 0 || bh % heads || t <= 0 ||
      rows == nullptr || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v), *fo = static_cast<const float*>(o),
                *fdo = static_cast<const float*>(dout);
    float *gq = static_cast<float*>(dq), *gk = static_cast<float*>(dk),
          *gv = static_cast<float*>(dv);
    return hd80 ? launch_bwd_f32<HD + 16>(fq, fk, fv, fo, lse, fdo, valid, gq, gk, gv, rows, bh,
                                          heads, t, scale, st)
                : launch_bwd_f32<HD>(fq, fk, fv, fo, lse, fdo, valid, gq, gk, gv, rows, bh,
                                     heads, t, scale, st);
  }
  return hd80 ? launch_bwd_bf16<HD + 16>(q, k, v, o, lse, dout, valid, dq, dk, dv, rows, bh,
                                         heads, t, scale, st)
              : launch_bwd_bf16<HD>(q, k, v, o, lse, dout, valid, dq, dk, dv, rows, bh, heads, t,
                                    scale, st);
}

// The design of one instance (dtype 0 f32, 1 bf16; head_dim 64 or 80) as
// compiled, for the kernel's report line, into out[9]: the dk/dv kernel's
// keys a tile, queries a stage and stages; the dq kernel's queries a tile,
// keys a stage and stages; the workspace's row padding; the number of main
// kernels (after the row pass); TF32 products an f32 product (0: bf16
// products).
extern "C" void vipers_flash_attention_bwd_design(int dtype, int head_dim, int* out) {
  const bool hd80 = head_dim == HD + 16;
  const int f32[9] = {FK_KEYS, FK_BQ, hd80 ? fk_stages<HD + 16>() : fk_stages<HD>(),
                      FQ_ROWS, FQ_BK, hd80 ? fq_stages<HD + 16>() : fq_stages<HD>(),
                      ROW_PAD, 2, TF32_TERMS};
  const int b16[9] = {KV_KEYS, KV_BQ, KV_STAGES, DQ_ROWS, DQ_KEYS, DQ_STAGES, ROW_PAD, 2, 0};
  for (int i = 0; i < 9; ++i) out[i] = dtype == 0 ? f32[i] : b16[i];
}
