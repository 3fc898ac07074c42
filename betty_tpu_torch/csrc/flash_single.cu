// Single-tile flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of the single-tile path in
// betty_tpu/ops/flash_attention.py:
//   flash_single_fwd  <- _fwd_single_kernel (B1, launched by _fwd_single)
//   flash_single_bwd  <- _bwd_single_kernel (B2, launched by _bwd_single)
// and computes what they compute, for q, k, v of shape (B, H, S, D) with
// S <= 512 (the Python wrapper enforces the limit):
//   forward:  o = softmax(q k^T * scale, masked) v, lse = m + log l per row;
//             a fully masked row gives o = 0 and lse = 0.
//   backward: di = rowsum(o * do) in the kernel, p = exp(s - lse),
//             dv = p^T do, ds = p (dp - di) scale rounded to the input type,
//             dq = ds k, dk = ds^T q.
// Products take operands in the input type (float or bfloat16) and
// accumulate in float32; p is rounded to the input type before the p v and
// p^T do products and ds before the ds k and ds^T q products, as the TPU
// kernels round them.
//
// Design. The TPU kernel holds a whole (heads, S, S) score block in 16 MiB
// of VMEM. A Hopper block has at most 227 KB of shared memory, so here:
//   forward:  one block of 256 threads per (b, h, 64-row q tile); it walks
//             64-row k/v chunks with an online softmax (running max m, sum
//             l, float32 accumulator), so the score matrix never leaves
//             registers and shared memory.
//   backward: one block per (b, h); it walks 64-row k/v chunks, and for each
//             chunk every 64-row q tile, accumulating dk and dv for the
//             chunk in registers. dq of a q tile gets one partial sum per
//             k/v chunk; partial sums go to a float32 scratch row owned by
//             the same thread in every chunk, so the sum is deterministic
//             and needs no atomics, and the last chunk writes dq.
// Every product is a float32 FMA loop over tiles in shared memory (rows
// padded to an odd stride, so row and column walks are free of bank
// conflicts). What bounds it on this card: at S = 128, D = 64 the work is
// about 2 * 2 * S * S * D flops per head forward and 2.5 times that
// backward against 4 * S * D elements moved, so the bound is the tensor-core
// rate; these kernels use the CUDA cores and run far from that bound. The
// tensor-core version (mma.sync or wgmma) is later work.

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

// state of one k/v column: 0 = past the sequence, 1 = masked by kv_mask,
// 2 = attended
__device__ __forceinline__ void load_col_state(int* ms, const uint8_t* __restrict__ mask,
                                               int k0, int nk, int tid) {
  if (tid < BK) {
    int st = 0;
    if (tid < nk) st = (mask == nullptr || mask[k0 + tid] != 0) ? 2 : 1;
    ms[tid] = st;
  }
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

template <typename T, int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const uint8_t* __restrict__ mask, T* __restrict__ o, float* __restrict__ lse,
           int H, int Sq, int Skv, int causal, float scale) {
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

    float s[4][4];
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
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool allowed[4];
      float rowmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, st = ms[c];
        allowed[j] = st == 2 && (!causal || k0 + c <= row);
        const float x = st == 0 ? -INFINITY : (allowed[j] ? s[i][j] * scale : MASK_VALUE);
        s[i][j] = x;
        rowmax = fmaxf(rowmax, x);
      }
      rowmax = reduce16_max(rowmax);
      const float m_new = fmaxf(m[i], rowmax);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = allowed[j] ? expf(s[i][j] - m_new) : 0.f;
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

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const T* __restrict__ o, const float* __restrict__ lse,
           const uint8_t* __restrict__ mask, T* __restrict__ dq, T* __restrict__ dk,
           T* __restrict__ dv, float* __restrict__ dq_acc, int H, int Sq, int Skv, int causal,
           float scale) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  float* dSs = Ps + BQ * LP;
  __shared__ int ms[BK];
  __shared__ float lse_s[BQ];
  __shared__ float di_s[BQ];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  const uint8_t* mb = mask ? mask + (size_t)b * Skv : nullptr;

  for (int k0 = 0; k0 < Skv; k0 += BK) {
    const int nk = min(BK, Skv - k0);
    const bool last_kv = k0 + BK >= Skv;
    __syncthreads();  // the previous chunk's reads of Ks, Vs are done
    load_tile<T, D>(Ks, k + (bh * Skv + k0) * D, nk, tid);
    load_tile<T, D>(Vs, v + (bh * Skv + k0) * D, nk, tid);
    load_col_state(ms, mb, k0, nk, tid);

    float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;

    for (int q0 = 0; q0 < Sq; q0 += BQ) {
      const int nq = min(BQ, Sq - q0);
      __syncthreads();  // the previous tile's reads of Qs, dOs, Ps, dSs are done
      load_tile<T, D>(Qs, q + (bh * Sq + q0) * D, nq, tid);
      load_tile<T, D>(dOs, dout + (bh * Sq + q0) * D, nq, tid);
      {
        // di = rowsum(o * do) in float32: four threads per row
        const int r = tid >> 2, part = tid & 3;
        float sum = 0.f;
        if (r < nq) {
          const T* orow = o + (bh * Sq + q0 + r) * D;
          const T* drow = dout + (bh * Sq + q0 + r) * D;
          for (int c = part; c < D; c += 4) sum += to_f<T>(orow[c]) * to_f<T>(drow[c]);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (part == 0) {
          di_s[r] = sum;
          lse_s[r] = r < nq ? lse[bh * Sq + q0 + r] : 0.f;
        }
      }
      __syncthreads();

      // s = q k^T and dp = do v^T for rows q0 + ty*4 + i, columns k0 + tx + 16 j
      float s[4][4], dp[4][4];
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
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, row = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool allowed = r < nq && ms[c] == 2 && (!causal || k0 + c <= row);
          const float p = allowed ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          Ps[r * LP + c] = round_t<T>(p);
          dSs[r * LP + c] = round_t<T>(p * (dp[i][j] - di_s[r]) * scale);
        }
      }
      __syncthreads();

      // dv += p^T do and dk += ds^T q for k/v rows k0 + ty*4 + i
      for (int qq = 0; qq < BQ; ++qq) {
        float pa[4], sa[4], gb[NJ], qb[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = Ps[qq * LP + ty * 4 + i];
          sa[i] = dSs[qq * LP + ty * 4 + i];
        }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          gb[jj] = dOs[qq * LD + tx + 16 * jj];
          qb[jj] = Qs[qq * LD + tx + 16 * jj];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            dv_acc[i][jj] = fmaf(pa[i], gb[jj], dv_acc[i][jj]);
            dk_acc[i][jj] = fmaf(sa[i], qb[jj], dk_acc[i][jj]);
          }
      }

      // dq partial = ds k for q rows q0 + ty*4 + i
      float dq_part[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) dq_part[i][jj] = 0.f;
      for (int kk = 0; kk < BK; ++kk) {
        float sa[4], kb[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) sa[i] = dSs[(ty * 4 + i) * LP + kk];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) kb[jj] = Ks[kk * LD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) dq_part[i][jj] = fmaf(sa[i], kb[jj], dq_part[i][jj]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        if (row >= Sq) continue;
        const size_t base = (bh * Sq + row) * D;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const size_t idx = base + tx + 16 * jj;
          const float val = dq_part[i][jj] + (k0 > 0 ? dq_acc[idx] : 0.f);
          if (last_kv) dq[idx] = from_f<T>(val);
          else dq_acc[idx] = val;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + ty * 4 + i;
      if (row >= Skv) continue;
      const size_t base = (bh * Skv + row) * D;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        dk[base + tx + 16 * jj] = from_f<T>(dk_acc[i][jj]);
        dv[base + tx + 16 * jj] = from_f<T>(dv_acc[i][jj]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const uint8_t* mask,
                       void* o, float* lse, int B, int H, int Sq, int Skv, int causal,
                       float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * LP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(o), lse, H, Sq, Skv, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* o, const float* lse, const uint8_t* mask, void* dq, void* dk,
                       void* dv, float* dq_acc, int B, int H, int Sq, int Skv, int causal,
                       float scale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * BQ * (D + 1) + 2 * BK * (D + 1) + 2 * BQ * LP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B);
  bwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const T*>(o), lse, mask, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), dq_acc, H, Sq, Skv, causal, scale);
  return cudaGetLastError();
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

// is_bf16: 0 = float32 inputs, 1 = bfloat16 inputs. mask: (B, Skv) bytes,
// nonzero = attend, or null. Returns a cudaError_t (0 = launched).
extern "C" int flash_single_fwd(const void* q, const void* k, const void* v, const void* mask,
                                void* o, void* lse, int B, int H, int Sq, int Skv, int D,
                                int is_bf16, int causal, float scale, void* stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    DISPATCH_D(__nv_bfloat16, launch_fwd, q, k, v, m, o, l, B, H, Sq, Skv, causal, scale, s)
  }
  DISPATCH_D(float, launch_fwd, q, k, v, m, o, l, B, H, Sq, Skv, causal, scale, s)
}

// dq_acc: float32 scratch of q's shape, used when Skv > 64 (else unread).
extern "C" int flash_single_bwd(const void* q, const void* k, const void* v, const void* dout,
                                const void* o, const void* lse, const void* mask, void* dq,
                                void* dk, void* dv, void* dq_acc, int B, int H, int Sq,
                                int Skv, int D, int is_bf16, int causal, float scale,
                                void* stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  float* acc = static_cast<float*>(dq_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    DISPATCH_D(__nv_bfloat16, launch_bwd, q, k, v, dout, o, l, m, dq, dk, dv, acc, B, H, Sq,
               Skv, causal, scale, s)
  }
  DISPATCH_D(float, launch_bwd, q, k, v, dout, o, l, m, dq, dk, dv, acc, B, H, Sq, Skv,
             causal, scale, s)
}
