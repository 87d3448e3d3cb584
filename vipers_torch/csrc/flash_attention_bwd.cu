// Masked blockwise (flash) attention backward for Hopper (sm_90a).
//
// Replaces the two library Pallas kernels that differentiating
// flash_attention_official (vipers/ops/flash_attention.py:200) runs on the
// TPU: _flash_attention_bwd_dkv (jax/experimental/pallas/ops/tpu/
// flash_attention.py:941, pallas_call :1121) and _flash_attention_bwd_dq
// (:1287, pallas_call :1456). Given q, k, v (B*H, T, 64), the (B, T) key
// mask, the forward's out and f32 lse (B*H, T) and the cotangent dO, it
// writes dq, dk and dv in the input dtype with the arithmetic of the plain
// version (flash_attention_bwd_plain):
//   s = (q * scale) . k^T in f32, -1e9 on invalid keys, keys beyond t
//   excluded; p = exp(s - lse); D = rowsum(dO * out);
//   dv = p^T dO, dp = dO v^T, ds = p (dp - D), dq = ds k scale,
//   dk = ds^T q scale.
// Any t >= 1: both instances mask the ragged edge themselves (rows beyond t
// read as zeros and are not written). dq is deterministic in both: no
// float atomics.
//
// Bound on the card: at the ViT-S/16 train shape at 384x384 (B*H = 128*6,
// T = 577 padded to 640, hd 64) the work is five T x T x 64 products, 201.3
// GFLOP, on 505 MB of I/O in bf16 (q, k, v, out, dO read; dq, dk, dv
// written; lse, mask) and 1009 MB in f32. bf16 is bound by operations
// (0.204 ms at 989 TFLOP/s against 0.151 ms of bytes), f32 by the 67
// TFLOP/s of its FMA pipes (3.0 ms).
//
// bf16: one kernel, attention_bwd.cuh's one-pass backward with flash's
// contract (FLASH = true), shared with the training kernels: a persistent
// CTA per (b, h) holds a round of 256 keys as K and V while Q, dO and O
// stream past by TMA; S^T and dP^T are K-major wgmma, dK and dV accumulate
// in registers, dS^T goes to shared memory by stmatrix and one warpgroup
// computes dQ from it. Keys go in rounds of 256 where T > 256, dQ summed
// in an f32 scratch (bh, t, 64) by the same threads each round, so it is
// deterministic. At T = 640 that is three rounds, the last half full.
//
// f32: two kernels on plain FMA (no TF32), the library's split, the parity
// anchor: flash_bwd_dkv_f32, one block per (b*h, 64-key tile) streaming
// 64-query tiles past its keys (S^T, dP^T, then dV += P^T dO and dK += dS^T
// qs from shared memory), and flash_bwd_dq_f32, one block per (b*h,
// 64-query tile) streaming key tiles (S, dP, then dQ += dS K). Each
// recomputes S and dP (seven products in place of five) and owns its
// outputs, so nothing is summed across blocks. 256 threads a block, a
// 16 x 16 grid of 4 x 4 tiles each, rows padded to 65 floats.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd.cuh"

namespace {

using attn_bwd::CHUNK;
using attn_bwd::HD;
using attn_bwd::NEG;

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

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (bh, t, 64) contiguous each, 16-byte
// aligned, all float32 (dtype 0) or all bfloat16 (dtype 1); lse: (bh, t)
// float32; valid: (bh / heads, t) bytes, nonzero = attend, or null (all
// valid). dq_acc: an f32 (bh, t, 64) scratch that needs no
// initialisation, for bf16 where t > 256 (else unused, may be null).
// device: the tensors' CUDA device, made current on this thread (the
// backward runs on autograd's worker thread, where cuTensorMapEncodeTiled
// refuses every address without a current context). Returns a cudaError_t
// (0 = launched).
extern "C" int vipers_flash_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const float* lse, const void* dout,
                                          const uint8_t* valid, void* dq, void* dk, void* dv,
                                          float* dq_acc, int bh, int heads, int t, int head_dim,
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
  if (dtype != 1 || (t > CHUNK && dq_acc == nullptr)) return (int)cudaErrorInvalidValue;
  return attn_bwd::launch_bwd<attn_bwd::BWD_F32, true>(q, k, v, o, lse, dout, valid, dq, dk, dv,
                                                       dq_acc, bh, heads, t, scale, st);
}
