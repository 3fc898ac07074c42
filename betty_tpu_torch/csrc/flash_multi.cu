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
//   B4: one block per (b, h, 64-row k/v chunk), walking the q tiles from
//       the first that reaches the diagonal when causal; K and V stay in
//       shared memory, s and p are recomputed from lse.
//   B5: one block per (b, h, 64-row q tile), walking the k/v chunks up to the
//       diagonal when causal; Q and dO stay in shared memory. At B8 H16
//       S1024 that is 2048 blocks on 132 SMs, where one block per (b, h)
//       would give 128.
// The resident tiles are 64 rows and the walked ones 64 rows (32 in float32
// B4 up to D64) whatever the JAX blocks are (the blocks only have to
// divide S, and the TPU's (512, 512) tile does not fit a Hopper block); a
// ragged last tile is zero-filled and its rows and columns are masked.
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
//     168.5 KB of float32 tiles in the float32 B4. Up to D64 the resident
//     tiles' A fragments stay in registers; at D128 they are loaded with
//     ldmatrix at each use, and B4 computes s^T in two passes of 32 q
//     columns, so that dK and dV (128 registers) fit __launch_bounds__(128).
// float32 B3, B4 and B5 (fp32_fwd_kernel, fp32_bwd_dkv_kernel,
// fp32_bwd_dq_kernel) run exact float32 FMAs on the CUDA cores, on the
// per-block bodies of flash_fp32.cuh (fp32_fwd_q_tile, fp32_dkv_chunk,
// fp32_dq_tile, the last two shared with float32 B2): 128 threads (256 for B3 and B4 at D128), half of them on
// each product (B3: s of chunk i and O += p V of chunk i - 1; B4: s and
// dv, dp and dk; B5: s and dp), so that each product has a register tile
// of 4 x 8 or 8 x 8 read with float4 shared-memory loads; walked tiles
// through a 2-stage cp.async ring; tensor cores in float32 would mean
// TF32, which would break the float32 solver passes' 1e-4 parity.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_fp32.cuh"
#include "flash_mma.cuh"

namespace {

// B3 in float32: o and lse of the 64-row q tile blockIdx.x of head
// (blockIdx.z, blockIdx.y)
template <int D>
__global__ void __launch_bounds__(Fp32Fwd<D>::NT)
fp32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const uint8_t* __restrict__ mask,
                float* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Skv,
                int causal, float scale) {
  extern __shared__ __align__(16) float smem_f32[];
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  fp32_fwd_q_tile<D>(q, k, v, mask ? mask + (size_t)blockIdx.z * Skv : nullptr, o, lse, Sq, Skv,
                     causal, scale, blockIdx.x * BQ, bh, smem_f32);
}

// B4 in float32: dk and dv of the 64-row k/v chunk blockIdx.x of head
// (blockIdx.z, blockIdx.y)
template <int D>
__global__ void __launch_bounds__(Fp32Dkv<D>::NT)
fp32_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    const uint8_t* __restrict__ mask, float* __restrict__ dk,
                    float* __restrict__ dv, int H, int Sq, int Skv, int causal, float scale) {
  extern __shared__ __align__(16) float smem_f32[];
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  fp32_dkv_chunk<D, false>(q, k, v, dout, nullptr, lse, di,
                           mask ? mask + (size_t)blockIdx.z * Skv : nullptr, dk, dv, Sq, Skv,
                           causal, scale, blockIdx.x * BK, bh, smem_f32);
}

// B5 in float32: dq of the 64-row q tile blockIdx.x of head (blockIdx.z,
// blockIdx.y)
template <int D>
__global__ void __launch_bounds__(Fp32Dq<D>::NT)
fp32_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ di,
                   const uint8_t* __restrict__ mask, float* __restrict__ dq, int H, int Sq,
                   int Skv, int causal, float scale) {
  extern __shared__ __align__(16) float smem_f32[];
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  fp32_dq_tile<D, false>(q, k, v, dout, nullptr, lse, di,
                         mask ? mask + (size_t)blockIdx.z * Skv : nullptr, dq, Sq, Skv, causal,
                         scale, blockIdx.x * BQ, bh, smem_f32);
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
  static_assert(std::is_same<T, float>::value, "the CUDA-core forward is float32");
  const void* ptrs[] = {q, k, v, o};
  if (!fp32_aligned(ptrs, 4)) return cudaErrorMisalignedAddress;
  const size_t smem = Fp32Fwd<D>::smem();  // D = 64: 102.5 KB
  cudaError_t err = cudaFuncSetAttribute(
      fp32_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fp32_fwd_kernel<D><<<grid, Fp32Fwd<D>::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(o), lse, H, Sq, Skv, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* di, const uint8_t* mask, void* dk,
                       void* dv, int B, int H, int Sq, int Skv, int causal, float scale,
                       cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value, "the CUDA-core backward is float32");
  const void* ptrs[] = {q, k, v, dout, dk, dv};
  if (!fp32_aligned(ptrs, 6)) return cudaErrorMisalignedAddress;
  const size_t smem = Fp32Dkv<D>::smem(false);  // D = 64: 86.5 KB, over the 48 KB default
  cudaError_t err = cudaFuncSetAttribute(
      fp32_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + BK - 1) / BK, H, B);
  fp32_bwd_dkv_kernel<D><<<grid, Fp32Dkv<D>::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, mask, static_cast<T*>(dk), static_cast<T*>(dv), H,
      Sq, Skv, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* di, const uint8_t* mask, void* dq, int B,
                      int H, int Sq, int Skv, int causal, float scale, cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value, "the CUDA-core backward is float32");
  const void* ptrs[] = {q, k, v, dout, dq};
  if (!fp32_aligned(ptrs, 5)) return cudaErrorMisalignedAddress;
  const size_t smem = Fp32Dq<D>::smem(false);  // D = 64: 102 KB
  cudaError_t err = cudaFuncSetAttribute(
      fp32_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fp32_bwd_dq_kernel<D><<<grid, Fp32Dq<D>::NT, smem, stream>>>(
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
    // the tensor-core kernel (mma_fwd_kernel); float32 runs fp32_fwd_kernel
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
    // the tensor-core kernel (mma_bwd_dkv_kernel); float32 runs fp32_bwd_dkv_kernel
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
    // the tensor-core kernel (mma_bwd_dq_kernel); float32 runs fp32_bwd_dq_kernel
    DISPATCH_D(__nv_bfloat16, launch_dq_mma, q, k, v, dout, l, d, m, dq, B, H, Sq, Skv, causal,
               scale, s)
  }
  DISPATCH_D(float, launch_dq, q, k, v, dout, l, d, m, dq, B, H, Sq, Skv, causal, scale, s)
}
