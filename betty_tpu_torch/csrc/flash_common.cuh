// Device code shared by the flash-attention kernels (flash_single.cu,
// flash_multi.cu): tile geometry, bfloat16 conversions, tile loads, the
// cp.async copies, the 16-lane reductions, the forward of one 64-row q tile
// (the body of float32 B1) and the s = q k^T, dp = do v^T products of the
// float32 single-tile backward (B2).
//
// Layout: q, k, v, o, do of shape (B, H, S, D), row-major and contiguous;
// lse and di of shape (B, H, S) in float32; the kv mask (B, Skv) bytes,
// nonzero = attend, or null. Blocks are 256 threads, 16 x 16: thread
// (ty, tx) owns rows ty*4 + i (i < 4) of a 64-row tile and, of a 64-wide
// score tile, columns tx + 16 j (j < 4); of a D-wide row, columns tx + 16 jj
// (jj < D / 16). Tiles in shared memory are float32 with rows padded to an
// odd stride (D + 1, 65), so row and column walks are free of bank
// conflicts.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // q rows per tile
constexpr int BK = 64;    // k/v rows per chunk
constexpr int NT = 256;   // threads per block: 16 x 16, 4 rows per thread
constexpr int LP = BK + 1;
// -0.7 * max float32, as betty_tpu's MASK_VALUE: exp of it underflows to 0
// without the NaN traps of -inf
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the input type and back (the .astype(input dtype) of the
// TPU kernels)
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f<T>(from_f<T>(x));
}

// rows [0, 64) x D of a row-major (rows, D) source into shared memory with
// row stride D + 1; rows at or past `valid` are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int valid, int tid) {
  for (int idx = tid; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx - r * D;
    dst[r * (D + 1) + c] = r < valid ? to_f<T>(src[(size_t)r * D + c]) : 0.f;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zero-filled when
// !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, as cp_async16
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until this thread's copies of every committed group have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// state of one k/v column of an N-column chunk: 0 = past the sequence,
// 1 = masked by kv_mask, 2 = attended
template <int N = BK>
__device__ __forceinline__ void load_col_state(int* ms, const uint8_t* __restrict__ mask,
                                               int k0, int nk, int tid) {
  if (tid < N) {
    int st = 0;
    if (tid < nk) st = (mask == nullptr || mask[k0 + tid] != 0) ? 2 : 1;
    ms[tid] = st;
  }
}

// per-row float32 statistics (lse, di) of rows [0, 64) of a tile; rows at or
// past `valid` are zero
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int valid, int tid) {
  if (tid < BQ) dst[tid] = tid < valid ? src[tid] : 0.f;
}

// 2^x on the SFU (ex2.approx.ftz: about 2^-22 relative error, results
// below 2^-126 flushed to 0, 2^-inf = 0), with no branch for denormal
// results as exp2f has
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float reduce16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float reduce16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// s = Q K^T and dp = dO V^T over the tiles in shared memory, for rows
// ty*4 + i and columns tx + 16 j
template <int D>
__device__ __forceinline__ void scores_and_dp(const float* Qs, const float* dOs, const float* Ks,
                                              const float* Vs, int tx, int ty, float (&s)[4][4],
                                              float (&dp)[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], g[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = Qs[(ty * 4 + i) * LD + d];
      g[i] = dOs[(ty * 4 + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = Ks[(tx + 16 * j) * LD + d];
      vb[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(g[i], vb[j], dp[i][j]);
      }
  }
}

// Forward of the 64-row q tile blockIdx.x of head (blockIdx.z, blockIdx.y)
// (float32 B1): walks 64-row k/v chunks with an online softmax (running max
// m, sum l, float32 accumulator) and writes o and lse for the tile's rows.
// Needs (BQ + 2 BK) (D + 1) + BQ LP floats of dynamic shared memory.
template <typename T, int D>
__device__ __forceinline__ void fwd_q_tile(const T* __restrict__ q, const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           const uint8_t* __restrict__ mask,
                                           T* __restrict__ o, float* __restrict__ lse, int H,
                                           int Sq, int Skv, int causal, float scale) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  __shared__ int ms[BK];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const uint8_t* mb = mask ? mask + (size_t)b * Skv : nullptr;

  load_tile<T, D>(Qs, q + (bh * Sq + q0) * D, min(BQ, Sq - q0), tid);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  // causal: chunks wholly above the tile's last row contribute nothing
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous chunk's reads of Ks, Vs, Ps are done
    const int nk = min(BK, Skv - k0);
    load_tile<T, D>(Ks, k + (bh * Skv + k0) * D, nk, tid);
    load_tile<T, D>(Vs, v + (bh * Skv + k0) * D, nk, tid);
    load_col_state(ms, mb, k0, nk, tid);
    __syncthreads();

    // the chunk's masked scaled scores of rows ty*4 + i, columns tx + 16 j:
    // MASK_VALUE where masked, -inf past the sequence
    float s[4][4];
    bool allowed[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, st = ms[c];
        allowed[i][j] = st == 2 && (!causal || k0 + c <= q0 + ty * 4 + i);
        s[i][j] = st == 0 ? -INFINITY : (allowed[i][j] ? s[i][j] * scale : MASK_VALUE);
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rowmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) rowmax = fmaxf(rowmax, s[i][j]);
      const float m_new = fmaxf(m[i], reduce16_max(rowmax));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = allowed[i][j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        Ps[(ty * 4 + i) * LP + tx + 16 * j] = round_t<T>(p);
      }
      psum = reduce16_sum(psum);
      l[i] = alpha * l[i] + psum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ps[(ty * 4 + i) * LP + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) bb[jj] = Vs[kk * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(a[i], bb[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (bh * Sq + row) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) orow[tx + 16 * jj] = from_f<T>(acc[i][jj] / l_safe);
    if (tx == 0) lse[bh * Sq + row] = l[i] == 0.f ? 0.f : m[i] + logf(l_safe);
  }
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  return (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * LP) * sizeof(float);
}

}  // namespace

#define DISPATCH_D(T, LAUNCH, ...)                                   \
  switch (D) {                                                       \
    case 16: return (int)LAUNCH<T, 16>(__VA_ARGS__);                 \
    case 32: return (int)LAUNCH<T, 32>(__VA_ARGS__);                 \
    case 64: return (int)LAUNCH<T, 64>(__VA_ARGS__);                 \
    case 128: return (int)LAUNCH<T, 128>(__VA_ARGS__);               \
    default: return (int)cudaErrorInvalidValue;                      \
  }
