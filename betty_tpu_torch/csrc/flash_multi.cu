// Multi-tile flash attention, forward and the two backward kernels, for
// Hopper (sm_90a).
//
// Replaces the three Pallas kernels of the multi-tile path in
// betty_tpu/ops/flash_attention.py, which runs when the sequence does not
// fit one block of the JAX dispatch (S > 512 with the default blocks):
//   flash_multi_fwd      <- _fwd_kernel      (B3, launched by _fwd_multi)
//   flash_multi_bwd_dkv  <- _bwd_dkv_kernel  (B4, launched by _bwd_dkv)
//   flash_multi_bwd_dq   <- _bwd_dq_kernel   (B5, launched by _bwd_dq)
// for q, k, v of shape (B, H, S, D), with lse and di = rowsum(o * do) of
// shape (B, H, S) in float32 (di is computed once per backward by the
// wrapper and read by both backward kernels):
//   B3: o = softmax(q k^T * scale, masked) v and lse = m + log l per row,
//       online softmax over k/v chunks; a fully masked row gives o = 0 and
//       lse = 0.
//   B4: p = exp(s - lse), zero where masked; dv = p^T do;
//       ds = p (dp - di) scale rounded to the input type; dk = ds^T q.
//   B5: the same p and ds; dq = ds k.
// Products take operands in the input type (float or bfloat16) and
// accumulate in float32; p is rounded to the input type before p v and
// p^T do, ds before ds k and ds^T q, as the TPU kernels round them.
//
// Design. The TPU kernels walk a grid (B, H, n_q, n_kv) whose last axis runs
// in order on one core and carry m, l, acc (B3), dk, dv (B4) or dq (B5) from
// one grid step to the next in VMEM scratch. Blocks on Hopper run in
// parallel and in no order, so the sequential axis becomes a loop inside
// the block, and each output is summed in registers and written once (no
// atomics, no scratch in device memory, the same order of sums on every
// run):
//   B3: one block per (b, h, 64-row q tile), walking 64-row k/v chunks up
//       to the diagonal when causal, with an online softmax.
//   B4: one block per (b, h, 64-row k/v chunk), walking the 64-row q tiles
//       from the first that reaches the diagonal when causal; K and V stay
//       in shared memory, s and p are recomputed from lse.
//   B5: one block per (b, h, 64-row q tile), walking the k/v chunks up to the
//       diagonal when causal; Q and dO stay in shared memory. At B8 H16
//       S1024 that is 2048 blocks on 132 SMs, where one block per (b, h)
//       would give 128.
// The tiles are 64 rows whatever the JAX blocks are (the blocks only have to
// divide S, and the TPU's (512, 512) tile does not fit a Hopper block); a
// ragged last tile is zero-filled and its columns are masked.
//
// What bounds them: at B8 H16 S1024 D64 they do 2, 4 and 3 products of
// 2 S^2 D flops per head against about 4 to 6 (S, D) tensors moved, so the
// bound is the tensor-core rate in bfloat16 (989 TFLOP/s) and the CUDA
// cores' in float32. dq, dk and dv stay two kernels: one kernel would need
// float32 atomics on dq, whose order changes from run to run, or dq
// partials of the size of the scores.
//
// bfloat16 B3, B4 and B5 (mma_fwd_kernel, mma_bwd_dkv_kernel,
// mma_bwd_dq_kernel) run on the tensor cores in FlashAttention-2's
// structure; their per-block bodies are in flash_mma.cuh (mma_fwd_q_tile,
// mma_dkv_chunk, mma_dq_tile), the last two shared with B2:
//   * 128 threads (4 warps) a block, each warp owning 16 rows of the
//     resident tile: q rows in B3 and B5, k/v rows in B4. Tiles stay bf16 in
//     shared memory with rows padded by 16 bytes (ldmatrix without bank
//     conflicts), copied 16 bytes at a time by cp.async.
//   * The walked tiles (B3 and B5: K, V and the mask; B4: Q, dO, lse, di)
//     come through a 2-stage cp.async ring: the next tile is copied while
//     the warps compute on this one, one barrier a tile.
//   * B3 computes s = Q K^T and keeps each row's running max and sum in
//     registers (the max reduced over the 4 lanes of a quad); B4 computes
//     s^T = K Q^T and dp^T = V dO^T, so that p^T and ds^T are accumulators
//     of the warp's own k/v rows (lse and di are read by column); B5
//     computes s = Q K^T and dp = dO V^T (lse and di by row, in registers).
//     p is computed by exp2 with log2 e folded into the scale, masked by
//     selection, and p and ds are rounded to bf16 and packed into the A
//     operands of O += p V (ldmatrix.trans on V), dV += p^T dO,
//     dK += ds^T Q (ldmatrix.trans on the same Q and dO tiles) or
//     dQ += ds K (ldmatrix.trans on K) in registers: they never touch
//     shared memory, where the float32 kernels stage them.
//   * Shared memory at D64: 46 KB in B3 (Q and two ring stages of K, V),
//     55 KB in B4 (K, V, two ring stages of Q and dO, and lse, di) and B5
//     (the same tiles less lse, di); at D128 87 and 103 KB, against 99.8 and
//     161.5 KB of float32 tiles in the float32 B4. Up to D64 the resident
//     tiles' A fragments stay in registers; at D128 they are loaded with
//     ldmatrix at each use, and B4 computes s^T in two passes of 32 q
//     columns, so that dK and dV (128 registers) fit __launch_bounds__(128).
// float32 B3, B4 and B5 stay CUDA-core FMA loops over float32 tiles (256
// threads, flash_common.cuh): tensor cores in float32 would mean TF32, which
// would break the float32 solver passes' 1e-4 parity.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

// B3 in float32: the forward of one q tile, as B1
template <typename T, int D>
__global__ void __launch_bounds__(NT)
multi_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ mask, T* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Skv, int causal, float scale) {
  fwd_q_tile<T, D>(q, k, v, mask, o, lse, H, Sq, Skv, causal, scale);
}

// B4: dk and dv of the 64-row k/v chunk blockIdx.x of head (blockIdx.z,
// blockIdx.y)
template <typename T, int D>
__global__ void __launch_bounds__(NT)
multi_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ di, const uint8_t* __restrict__ mask,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Skv, int causal,
                     float scale) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LP;
  __shared__ int ms[BK];
  __shared__ float lse_s[BQ];
  __shared__ float di_s[BQ];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const int nk = min(BK, Skv - k0);
  load_tile<T, D>(Ks, k + (bh * Skv + k0) * D, nk, tid);
  load_tile<T, D>(Vs, v + (bh * Skv + k0) * D, nk, tid);
  load_col_state(ms, mask ? mask + (size_t)b * Skv : nullptr, k0, nk, tid);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;

  // causal: q tiles wholly above the chunk's first column see none of it
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < Sq; q0 += BQ) {
    const int nq = min(BQ, Sq - q0);
    __syncthreads();  // the previous tile's reads of Qs, dOs, Ps, dSs are done
    load_tile<T, D>(Qs, q + (bh * Sq + q0) * D, nq, tid);
    load_tile<T, D>(dOs, dout + (bh * Sq + q0) * D, nq, tid);
    load_rows(lse_s, lse + bh * Sq + q0, nq, tid);
    load_rows(di_s, di + bh * Sq + q0, nq, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores_and_dp<D>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        // masked after the exp, as the TPU kernel: select, never multiply,
        // since a fully masked row has lse = 0 and the exp may overflow
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

// B5: dq of the 64-row q tile blockIdx.x of head (blockIdx.z, blockIdx.y)
template <typename T, int D>
__global__ void __launch_bounds__(NT)
multi_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, const uint8_t* __restrict__ mask,
                    T* __restrict__ dq, int H, int Sq, int Skv, int causal, float scale) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  __shared__ int ms[BK];
  __shared__ float lse_s[BQ];
  __shared__ float di_s[BQ];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const uint8_t* mb = mask ? mask + (size_t)b * Skv : nullptr;
  const int nq = min(BQ, Sq - q0);
  load_tile<T, D>(Qs, q + (bh * Sq + q0) * D, nq, tid);
  load_tile<T, D>(dOs, dout + (bh * Sq + q0) * D, nq, tid);
  load_rows(lse_s, lse + bh * Sq + q0, nq, tid);
  load_rows(di_s, di + bh * Sq + q0, nq, tid);

  float dq_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dq_acc[i][jj] = 0.f;

  // causal: chunks wholly above the tile's last row contribute nothing
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    const int nk = min(BK, Skv - k0);
    __syncthreads();  // the previous chunk's reads of Ks, Vs, dSs are done
    load_tile<T, D>(Ks, k + (bh * Skv + k0) * D, nk, tid);
    load_tile<T, D>(Vs, v + (bh * Skv + k0) * D, nk, tid);
    load_col_state(ms, mb, k0, nk, tid);
    __syncthreads();

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
        dSs[r * LP + c] = round_t<T>(p * (dp[i][j] - di_s[r]) * scale);
      }
    }
    __syncthreads();

    // dq += ds k for q rows q0 + ty*4 + i
    for (int kk = 0; kk < BK; ++kk) {
      float sa[4], kb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = dSs[(ty * 4 + i) * LP + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) kb[jj] = Ks[kk * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) dq_acc[i][jj] = fmaf(sa[i], kb[jj], dq_acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    T* drow = dq + (bh * Sq + row) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) drow[tx + 16 * jj] = from_f<T>(dq_acc[i][jj]);
  }
}

// B3 in bf16 on the tensor cores: o and lse of the 64-row q tile blockIdx.x
// of head (blockIdx.z, blockIdx.y)
template <int D>
__global__ void __launch_bounds__(MMA_NT)
mma_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Skv,
               int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  mma_fwd_q_tile<D>(q, k, v, mask ? mask + (size_t)blockIdx.z * Skv : nullptr, o, lse, Sq, Skv,
                    causal, scale, blockIdx.x * BQ, bh, smem_raw);
}

// B4 in bf16 on the tensor cores: dk and dv of the 64-row k/v chunk
// blockIdx.x of head (blockIdx.z, blockIdx.y)
template <int D>
__global__ void __launch_bounds__(MMA_NT)
mma_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ di,
                   const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int H, int Sq, int Skv, int causal,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  mma_dkv_chunk<D, false>(q, k, v, dout, nullptr, lse, di,
                          mask ? mask + (size_t)blockIdx.z * Skv : nullptr, dk, dv, Sq, Skv,
                          causal, scale, blockIdx.x * BK, bh, smem_raw);
}

// B5 in bf16 on the tensor cores: dq of the 64-row q tile blockIdx.x of head
// (blockIdx.z, blockIdx.y)
template <int D>
__global__ void __launch_bounds__(MMA_NT)
mma_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dq, int H,
                  int Sq, int Skv, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  mma_dq_tile<D, false>(q, k, v, dout, nullptr, lse, di,
                        mask ? mask + (size_t)blockIdx.z * Skv : nullptr, dq, Sq, Skv, causal,
                        scale, blockIdx.x * BQ, bh, smem_raw);
}

template <typename T, int D>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, const uint8_t* mask,
                           void* o, float* lse, int B, int H, int Sq, int Skv, int causal,
                           float scale, cudaStream_t stream) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "the tensor-core path is bf16");
  const void* in[] = {q, k, v};
  const void* out[] = {o};
  if (!mma_aligned(in, 3, out, 1)) return cudaErrorMisalignedAddress;
  const size_t smem = mma_fwd_smem<D>();  // D = 128: 87 KB, over the 48 KB default
  cudaError_t err = cudaFuncSetAttribute(
      mma_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  mma_fwd_kernel<D><<<grid, MMA_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(o), lse, H, Sq, Skv, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* di, const uint8_t* mask, void* dk,
                           void* dv, int B, int H, int Sq, int Skv, int causal, float scale,
                           cudaStream_t stream) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "the tensor-core path is bf16");
  const void* in[] = {q, k, v, dout};
  const void* out[] = {dk, dv};
  if (!mma_aligned(in, 4, out, 2)) return cudaErrorMisalignedAddress;
  const size_t smem = mma_dkv_smem<D>(false);  // D = 64: 55 KB, over the 48 KB default
  cudaError_t err = cudaFuncSetAttribute(
      mma_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + BK - 1) / BK, H, B);
  mma_bwd_dkv_kernel<D><<<grid, MMA_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, mask, static_cast<T*>(dk),
      static_cast<T*>(dv), H, Sq, Skv, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* di, const uint8_t* mask, void* dq,
                          int B, int H, int Sq, int Skv, int causal, float scale,
                          cudaStream_t stream) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "the tensor-core path is bf16");
  const void* in[] = {q, k, v, dout};
  const void* out[] = {dq};
  if (!mma_aligned(in, 4, out, 1)) return cudaErrorMisalignedAddress;
  const size_t smem = mma_dq_smem<D>(false);
  cudaError_t err = cudaFuncSetAttribute(
      mma_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  mma_bwd_dq_kernel<D><<<grid, MMA_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, mask, static_cast<T*>(dq), H, Sq, Skv,
      causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const uint8_t* mask,
                       void* o, float* lse, int B, int H, int Sq, int Skv, int causal,
                       float scale, cudaStream_t stream) {
  return launch_fwd_tiles<T, D>(multi_fwd_kernel<T, D>, q, k, v, mask, o, lse, B, H, Sq, Skv,
                                causal, scale, stream);
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* di, const uint8_t* mask, void* dk,
                       void* dv, int B, int H, int Sq, int Skv, int causal, float scale,
                       cudaStream_t stream) {
  // D = 128: 161.5 KB, over the 48 KB default
  const size_t smem =
      (size_t)(2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * LP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      multi_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + BK - 1) / BK, H, B);
  multi_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, mask, static_cast<T*>(dk), static_cast<T*>(dv), H,
      Sq, Skv, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* di, const uint8_t* mask, void* dq, int B,
                      int H, int Sq, int Skv, int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * LP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      multi_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  multi_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, mask, static_cast<T*>(dq), H, Sq, Skv, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

// is_bf16: 0 = float32 inputs, 1 = bfloat16 inputs. mask: (B, Skv) bytes,
// nonzero = attend, or null. Returns a cudaError_t (0 = launched).
extern "C" int flash_multi_fwd(const void* q, const void* k, const void* v, const void* mask,
                               void* o, void* lse, int B, int H, int Sq, int Skv, int D,
                               int is_bf16, int causal, float scale, void* stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    // the tensor-core kernel (mma_fwd_kernel); float32 keeps the FMA loop
    DISPATCH_D(__nv_bfloat16, launch_fwd_mma, q, k, v, m, o, l, B, H, Sq, Skv, causal, scale, s)
  }
  DISPATCH_D(float, launch_fwd, q, k, v, m, o, l, B, H, Sq, Skv, causal, scale, s)
}

// lse, di: (B, H, Sq) float32.
extern "C" int flash_multi_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* di,
                                   const void* mask, void* dk, void* dv, int B, int H, int Sq,
                                   int Skv, int D, int is_bf16, int causal, float scale,
                                   void* stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    // the tensor-core kernel (mma_bwd_dkv_kernel); float32 keeps the FMA loop
    DISPATCH_D(__nv_bfloat16, launch_dkv_mma, q, k, v, dout, l, d, m, dk, dv, B, H, Sq, Skv,
               causal, scale, s)
  }
  DISPATCH_D(float, launch_dkv, q, k, v, dout, l, d, m, dk, dv, B, H, Sq, Skv, causal, scale, s)
}

extern "C" int flash_multi_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* di, const void* mask, void* dq,
                                  int B, int H, int Sq, int Skv, int D, int is_bf16, int causal,
                                  float scale, void* stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    // the tensor-core kernel (mma_bwd_dq_kernel); float32 keeps the FMA loop
    DISPATCH_D(__nv_bfloat16, launch_dq_mma, q, k, v, dout, l, d, m, dq, B, H, Sq, Skv, causal,
               scale, s)
  }
  DISPATCH_D(float, launch_dq, q, k, v, dout, l, d, m, dq, B, H, Sq, Skv, causal, scale, s)
}
