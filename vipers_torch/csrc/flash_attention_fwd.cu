// Masked blockwise (flash) attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels vipers/ops/flash_attention.py::_fwd_kernel
// (driven by _flash_fwd) and the library Pallas kernel behind
// flash_attention_official: O = softmax(scale * Q K^T, keys masked) V over
// (B*H, T, 64), plus the f32 logsumexp that a backward pass needs.
//
// Work layout: one block per (b*h, 64-query tile). K/V stream through
// shared memory in 64-key tiles; the running row max m and sum l stay in
// f32 registers (online softmax), so the (T, T) matrix never reaches device
// memory. Pad keys (valid == 0) get -1e9 on the f32 scores, exactly the
// JAX kernel's mask: exp underflows to 0 once a valid key has been seen.
// Keys beyond T read as zero rows and are masked the same way, which is the
// JAX wrapper's internal padding. Query rows beyond T are not written.
// Final: l_safe = max(l, 1e-20), O = acc / l_safe, lse = m + log(l_safe).
//
// Bound on the card: at the ViT-S/16 LOST shape (B*H = 768, T = 896) the
// bf16 instance does 158 GFLOP on 352 MB of I/O, so operations bound it
// (0.16 ms at 989 TFLOP/s against 0.11 ms of bytes). The f32 instance runs
// on plain FMA (no TF32, it is the bit-parity anchor), bound by the
// 67 TFLOP/s of the f32 pipes.
//
// Instances (template on the element type):
//   float:  256 threads; a 16x16 thread grid, each thread owns a 4x4 tile
//           of S and a 4x16 strip of O; FMA from padded shared memory.
//   bf16:   128 threads = 4 warps, each owns 16 query rows; S = Q K^T and
//           O += P V on mma.sync m16n8k16 with f32 accumulation; P goes from
//           the S accumulators to A fragments in registers (no smem trip).
// This first version is simple and right; it does not use TMA or wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int HD = 64;    // head dim (the wrapper rejects any other)
constexpr int BQ = 64;    // queries per block
constexpr int BK = 64;    // keys per streamed tile
constexpr float NEG = -1e9f;

// ------------------------------------------------------------ f32 / FMA
constexpr int F32_THREADS = 256;
constexpr int F32_LD = HD + 1;  // padded row: conflict-free column reads

struct F32Smem {
  float q[BQ][F32_LD];
  float k[BK][F32_LD];
  float v[BK][F32_LD];
  float p[BQ][F32_LD];
  float ok[BK];
};

__device__ void fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const uint8_t* __restrict__ valid,
                        float* __restrict__ o, float* __restrict__ lse,
                        int heads, int t, float scale, char* smem_raw) {
  F32Smem& s = *reinterpret_cast<F32Smem*>(smem_raw);
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty*4+a, cols tx+16*i
  const size_t base = (size_t)bh * t * HD;
  const uint8_t* vrow = valid ? valid + (size_t)(bh / heads) * t : nullptr;

  for (int idx = tid; idx < BQ * HD; idx += F32_THREADS) {
    const int r = idx / HD, c = idx % HD;
    const int gq = q0 + r;
    s.q[r][c] = gq < t ? q[base + (size_t)gq * HD + c] * scale : 0.f;
  }

  float acc[4][4], m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG;
    l[a] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[a][i] = 0.f;
  }

  const int n_kt = (t + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's readers are done
    for (int idx = tid; idx < BK * HD; idx += F32_THREADS) {
      const int r = idx / HD, c = idx % HD;
      const int gk = k0 + r;
      const bool in = gk < t;
      s.k[r][c] = in ? k[base + (size_t)gk * HD + c] : 0.f;
      s.v[r][c] = in ? v[base + (size_t)gk * HD + c] : 0.f;
    }
    if (tid < BK) {
      const int gk = k0 + tid;
      s.ok[tid] = (gk < t && (vrow == nullptr || vrow[gk])) ? 1.f : 0.f;
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
        if (s.ok[tx + 16 * i] == 0.f) sc[a][i] = NEG;
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
    for (int j = 0; j < BK; ++j) {
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
      o[base + (size_t)gq * HD + tx + 16 * i] = acc[a][i] / l_safe;
    if (tx == 0) lse[(size_t)bh * t + gq] = m[a] + logf(l_safe);
  }
}

// ------------------------------------------------------ bf16 / mma.sync
constexpr int BF16_THREADS = 128;
constexpr int BF16_LD = HD + 8;  // 144-byte rows: conflict-free fragments

struct Bf16Smem {
  __nv_bfloat16 q[BQ][BF16_LD];
  __nv_bfloat16 k[BK][BF16_LD];
  __nv_bfloat16 vt[HD][BF16_LD];  // V transposed: [dim][key]
  float ok[BK];
};

// Copy a 64x64 bf16 tile (rows r0.., zero beyond t) into smem rows.
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16 (*dst)[BF16_LD], const __nv_bfloat16* __restrict__ src,
    int r0, int t, int tid) {
  for (int idx = tid; idx < 64 * (HD / 8); idx += BF16_THREADS) {
    const int r = idx / (HD / 8), ch = idx % (HD / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * HD + ch * 8);
    *reinterpret_cast<uint4*>(&dst[r][ch * 8]) = val;
  }
}

__device__ void fwd_bf16(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const uint8_t* __restrict__ valid,
                         __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                         int heads, int t, float scale, char* smem_raw) {
  Bf16Smem& s = *reinterpret_cast<Bf16Smem*>(smem_raw);
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int wr = warp * 16;  // this warp's first query row in the tile
  const size_t base = (size_t)bh * t * HD;
  const uint8_t* vrow = valid ? valid + (size_t)(bh / heads) * t : nullptr;

  load_tile_bf16(s.q, q + base, q0, t, tid);
  __syncthreads();
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + tg * 2;
    qa[kk][0] = ld_bf16x2(&s.q[wr + g][c]);
    qa[kk][1] = ld_bf16x2(&s.q[wr + g + 8][c]);
    qa[kk][2] = ld_bf16x2(&s.q[wr + g][c + 8]);
    qa[kk][3] = ld_bf16x2(&s.q[wr + g + 8][c + 8]);
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // rows g and g+8

  const int n_kt = (t + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's readers are done
    load_tile_bf16(s.k, k + base, k0, t, tid);
    for (int idx = tid; idx < BK * (HD / 8); idx += BF16_THREADS) {
      const int r = idx / (HD / 8), ch = idx % (HD / 8);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < t)
        val = *reinterpret_cast<const uint4*>(v + base + (size_t)(k0 + r) * HD + ch * 8);
      const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e) s.vt[ch * 8 + e][r] = e8[e];
    }
    if (tid < BK) {
      const int gk = k0 + tid;
      s.ok[tid] = (gk < t && (vrow == nullptr || vrow[gk])) ? 1.f : 0.f;
    }
    __syncthreads();

    float sc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 + tg * 2;
        mma_bf16_16816(sc[nt], qa[kk], ld_bf16x2(&s.k[nt * 8 + g][c]),
                       ld_bf16x2(&s.k[nt * 8 + g][c + 8]));
      }
    }

    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = s.ok[nt * 8 + tg * 2 + e] != 0.f;
        sc[nt][e] = ok ? sc[nt][e] * scale : NEG;
        sc[nt][e + 2] = ok ? sc[nt][e + 2] * scale : NEG;
        mx0 = fmaxf(mx0, sc[nt][e]);
        mx1 = fmaxf(mx1, sc[nt][e + 2]);
      }
    }
    // the 4 lanes of a quad share a row
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[nt][e] = expf(sc[nt][e] - mn0);
        sc[nt][e + 2] = expf(sc[nt][e + 2] - mn1);
        sum0 += sc[nt][e];
        sum1 += sc[nt][e + 2];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      acc[dt][0] *= al0;
      acc[dt][1] *= al0;
      acc[dt][2] *= al1;
      acc[dt][3] *= al1;
    }

    // P (16 x 64 per warp) as A fragments: the C layout of n-tiles 2kk and
    // 2kk+1 is exactly the A layout of the 16-key step kk.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const int c = kk * 16 + tg * 2;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
        mma_bf16_16816(acc[dt], pa, ld_bf16x2(&s.vt[dt * 8 + g][c]),
                       ld_bf16x2(&s.vt[dt * 8 + g][c + 8]));
    }
  }

  const float ls0 = fmaxf(l0, 1e-20f), ls1 = fmaxf(l1, 1e-20f);
  const int r0 = q0 + wr + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int c = dt * 8 + tg * 2;
    if (r0 < t)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)r0 * HD + c) =
          __floats2bfloat162_rn(acc[dt][0] / ls0, acc[dt][1] / ls0);
    if (r1 < t)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)r1 * HD + c) =
          __floats2bfloat162_rn(acc[dt][2] / ls1, acc[dt][3] / ls1);
  }
  if (tg == 0) {
    if (r0 < t) lse[(size_t)bh * t + r0] = m0 + logf(ls0);
    if (r1 < t) lse[(size_t)bh * t + r1] = m1 + logf(ls1);
  }
}

template <typename T>
__global__ void __launch_bounds__(std::is_same<T, float>::value ? F32_THREADS
                                                                 : BF16_THREADS)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const uint8_t* __restrict__ valid, T* __restrict__ o,
                           float* __restrict__ lse, int heads, int t,
                           float scale) {
  extern __shared__ __align__(16) char smem[];
  if constexpr (std::is_same<T, float>::value)
    fwd_f32(q, k, v, valid, o, lse, heads, t, scale, smem);
  else
    fwd_bf16(q, k, v, valid, o, lse, heads, t, scale, smem);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid,
           void* o, float* lse, int bh, int heads, int t, float scale,
           cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  const int threads = f32 ? F32_THREADS : BF16_THREADS;
  const int smem = f32 ? (int)sizeof(F32Smem) : (int)sizeof(Bf16Smem);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (t + BQ - 1) / BQ);
  flash_attention_fwd_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, static_cast<T*>(o), lse, heads, t,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (bh, t, 64) contiguous, dtype 0 = float32, 1 = bfloat16.
// valid: (bh / heads, t) bytes, nonzero = attend; may be null (all valid).
// lse: (bh, t) float32. Returns a cudaError_t (0 = launched).
extern "C" int vipers_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, const uint8_t* valid,
                                          void* o, float* lse, int bh,
                                          int heads, int t, int head_dim,
                                          float scale, int dtype,
                                          void* stream) {
  if (head_dim != HD || bh <= 0 || heads <= 0 || bh % heads || t <= 0 ||
      (t + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, valid, o, lse, bh, heads, t, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, valid, o, lse, bh, heads, t, scale, st);
  return (int)cudaErrorInvalidValue;
}
