// Single-tile flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of the single-tile path in
// betty_tpu/ops/flash_attention.py:
//   flash_single_fwd  <- _fwd_single_kernel (B1, launched by _fwd_single)
//   flash_single_bwd  <- _bwd_single_kernel (B2, launched by _bwd_single)
// and computes what they compute, for q, k, v of shape (B, H, S, D) on the
// single-tile path (the sequence fits one block of the JAX dispatch, 512 by
// default; the kernels themselves take any S):
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
//             registers and shared memory (flash_common.cuh::fwd_q_tile,
//             float32 FMA loops on the CUDA cores in both input types).
//   backward, bfloat16 (mma_bwd_single_kernel): on the tensor cores, with
//             the bodies of the multi-tile backward (flash_mma.cuh). Block x
//             of head (b, h), 128 threads, first computes dk and dv of k/v
//             chunk x, walking every 64-row q tile (mma_dkv_chunk, B4's
//             body), then dq of q tile x, walking every k/v chunk
//             (mma_dq_tile, B5's body); a part whose chunk or tile is past
//             its sequence is skipped, so Sq != Skv works. Every output is
//             summed in registers and written once: no atomics, no float32
//             scratch, the same order of sums on every run; at B32 H16 S128
//             that is 1024 blocks of two tiles each. di = rowsum(o * do)
//             stays in the kernel, as in the TPU kernel: the walked q tiles
//             bring their o tile through the cp.async ring with q and do,
//             and the dq part computes its own rows' di from its o tile. s
//             and dp are computed in both parts, 7 products per pair of
//             tiles for the TPU kernel's 5; at S128 the kernel moves 67 MB
//             for 5.4 GFLOP, so it is bound by bytes and the extra products
//             cost less than the parallelism they buy.
//   backward, float32 (bwd_kernel): one block of 256 threads per (b, h); it
//             walks 64-row k/v chunks, and for each chunk every 64-row q
//             tile, accumulating dk and dv for the chunk in registers. dq of
//             a q tile gets one partial sum per k/v chunk; partial sums go to
//             a float32 scratch row owned by the same thread in every chunk,
//             so the sum is deterministic and needs no atomics, and the last
//             chunk writes dq. Float32 FMA loops over tiles in shared memory
//             (rows padded to an odd stride, so row and column walks are free
//             of bank conflicts): tensor cores in float32 would mean TF32,
//             which would break the float32 solver passes' 1e-4 parity.
// What bounds them on this card: at S = 128, D = 64 the work is about
// 2 * 2 * S * S * D flops per head forward and 2.5 times that backward
// against 4 * S * D elements moved, so the bytes bound bfloat16 and the
// CUDA cores' rate float32.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

// B1: the forward of one q tile (flash_common.cuh::fwd_q_tile)
template <typename T, int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const uint8_t* __restrict__ mask, T* __restrict__ o, float* __restrict__ lse,
           int H, int Sq, int Skv, int causal, float scale) {
  fwd_q_tile<T, D>(q, k, v, mask, o, lse, H, Sq, Skv, causal, scale);
}

// B2 in bf16 on the tensor cores: block blockIdx.x of head (blockIdx.z,
// blockIdx.y) computes dk, dv of k/v chunk blockIdx.x and then dq of q tile
// blockIdx.x, with di from o in the kernel
template <int D>
__global__ void __launch_bounds__(MMA_NT)
mma_bwd_single_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const __nv_bfloat16* __restrict__ o, const float* __restrict__ lse,
                      const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dq,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
                      int Sq, int Skv, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int x = blockIdx.x;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const uint8_t* mb = mask ? mask + (size_t)blockIdx.z * Skv : nullptr;
  if (x * BK < Skv)
    mma_dkv_chunk<D, true>(q, k, v, dout, o, lse, nullptr, mb, dk, dv, Sq, Skv, causal, scale,
                           x * BK, bh, smem_raw);
  if (x * BQ < Sq) {
    __syncthreads();  // every warp is done with the dk/dv part's shared memory
    mma_dq_tile<D, true>(q, k, v, dout, o, lse, nullptr, mb, dq, Sq, Skv, causal, scale, x * BQ,
                         bh, smem_raw);
  }
}

// B2 in float32
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
      scores_and_dp<D>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
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
  return launch_fwd_tiles<T, D>(fwd_kernel<T, D>, q, k, v, mask, o, lse, B, H, Sq, Skv, causal,
                                scale, stream);
}

template <typename T, int D>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const void* dout,
                           const void* o, const float* lse, const uint8_t* mask, void* dq,
                           void* dk, void* dv, int B, int H, int Sq, int Skv, int causal,
                           float scale, cudaStream_t stream) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "the tensor-core path is bf16");
  const void* in[] = {q, k, v, dout, o};
  const void* out[] = {dq, dk, dv};
  if (!mma_aligned(in, 5, out, 3)) return cudaErrorMisalignedAddress;
  // D = 64: 75 KB, over the 48 KB default (the dk/dv part's; the dq part's
  // is less)
  const size_t smem = mma_dkv_smem<D>(true);
  cudaError_t err = cudaFuncSetAttribute(
      mma_bwd_single_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_q = (Sq + BQ - 1) / BQ, n_kv = (Skv + BK - 1) / BK;
  dim3 grid(n_q > n_kv ? n_q : n_kv, H, B);
  mma_bwd_single_kernel<D><<<grid, MMA_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const T*>(o), lse, mask, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Skv, causal, scale);
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

// dq_acc: float32 scratch of q's shape, read by the float32 kernel when
// Skv > 64 (else unread; null for bfloat16).
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
    // the tensor-core kernel (mma_bwd_single_kernel); float32 keeps the FMA loop
    DISPATCH_D(__nv_bfloat16, launch_bwd_mma, q, k, v, dout, o, l, m, dq, dk, dv, B, H, Sq, Skv,
               causal, scale, s)
  }
  DISPATCH_D(float, launch_bwd, q, k, v, dout, o, l, m, dq, dk, dv, acc, B, H, Sq, Skv,
             causal, scale, s)
}
