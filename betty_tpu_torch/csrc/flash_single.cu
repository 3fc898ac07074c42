// Single-tile flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of the single-tile path in
// betty_tpu/ops/flash_attention.py:
//   flash_single_fwd  <- _fwd_single_kernel (B1, launched by _fwd_single)
//   flash_single_bwd  <- _bwd_single_kernel (B2, launched by _bwd_single)
// and computes what they compute, for q, k, v of shape (B, H, S, D) on the
// single-tile path (the sequence fits one block of the JAX dispatch, 512 by
// default; the kernels themselves take any S, bfloat16 B1 up to
// SINGLE_MAX_KV keys):
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
// of VMEM. A Hopper block has at most 227 KB of shared memory, so each
// kernel here runs on 64-row tiles, with per-block bodies from
// flash_mma.cuh (bfloat16) and flash_fp32.cuh (float32):
//   forward, bfloat16 (mma_fwd_single_kernel): on the tensor cores, with
//             the building blocks of bf16 B3 (flash_mma.cuh,
//             mma_fwd_single_q_tile). One block of 128 threads per (b, h,
//             64-row q tile) walks 64-row k/v chunks through a 2-stage
//             cp.async ring twice: first K alone, for each row's max, then
//             K and V for p = exp(s - m), l and O += p V with p rounded to
//             bf16 against the row max, as the TPU kernel rounds it. The
//             tensor cores sum s and p V with truncation, in another order
//             than the plain version's float32 chains, and a last bit of s
//             can flip a bf16 rounding of p, so the row max, each p near a
//             bf16 rounding midpoint and each o element whose sum nearly
//             cancels are taken again as the plain chains give them: o
//             stays within one bf16 ulp of the plain o. The rows' bf16 p
//             stay in shared memory for that, so B1 takes up to
//             SINGLE_MAX_KV keys.
//   forward, float32 (fp32_fwd_single_kernel, body
//             flash_fp32.cuh::fp32_fwd_single_q_tile): one block of 128
//             threads per (b, h, 64-row q tile) takes the keys in chunks of
//             128, each product on all the threads in turn at 8 x 8 a
//             thread: s = Q K^T, each row's max, p^T into K's tile, then
//             O += p V. Up to 128 keys (S128) that is one chunk and the
//             row's own max, as the TPU kernel takes it; past 128 the
//             chunks are summed with the online softmax, which in float32
//             (p never rounded) gives the same o and lse up to rounding.
//   backward (mma_bwd_single_kernel in bfloat16 on the tensor cores,
//             flash_mma.cuh; fp32_bwd_single_kernel in float32 on the CUDA
//             cores, flash_fp32.cuh): block x of head (b, h) first computes
//             dk and dv of k/v chunk x, walking every q tile (B4's body),
//             then dq of q tile x, walking every k/v chunk (B5's body); a
//             part whose chunk or tile is past its sequence is skipped, so
//             Sq != Skv works. Every output is summed in registers and
//             written once: no atomics, no float32 scratch, the same order
//             of sums on every run; at B32 H16 S128 that is 1024 blocks of
//             two tiles each. di = rowsum(o * do) stays in the kernel, as
//             in the TPU kernel (DI_FROM_O): the walked q tiles bring their
//             o tile through the cp.async ring with q and do, and the dq
//             part computes its own rows' di from its o tile. s and dp are
//             computed in both parts, 7 products per pair of tiles for the
//             TPU kernel's 5, for twice the blocks of one per (b, h) and no
//             dq partial sums.
// What bounds them on this card: at S = 128, D = 64 the work is 2 (forward)
// or 5 (backward) products of 2 S^2 D flops per head against 4 to 8 (S, D)
// tensors moved, so the bytes bound bfloat16 (at 295 flops a byte) and the
// CUDA cores' FMA rate float32 (tensor cores in float32 would mean TF32,
// which would break the float32 solver passes' 1e-4 parity).

#include <type_traits>

#include "flash_common.cuh"
#include "flash_fp32.cuh"
#include "flash_mma.cuh"

namespace {

// B1 in float32 on the CUDA cores: o and lse of the 64-row q tile
// blockIdx.x of head (blockIdx.z, blockIdx.y)
template <int D>
__global__ void __launch_bounds__(Fp32Fwd1<D>::NT)
fp32_fwd_single_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const uint8_t* __restrict__ mask,
                       float* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Skv,
                       int causal, float scale) {
  extern __shared__ __align__(16) float smem_f32[];
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  fp32_fwd_single_q_tile<D>(q, k, v, mask ? mask + (size_t)blockIdx.z * Skv : nullptr, o, lse,
                            Sq, Skv, causal, scale, blockIdx.x * BQ, bh, smem_f32);
}

// B1 in bf16 on the tensor cores: o and lse of the 64-row q tile blockIdx.x
// of head (blockIdx.z, blockIdx.y), p rounded against the row max
template <int D>
__global__ void __launch_bounds__(MMA_NT)
mma_fwd_single_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int Sq,
                      int Skv, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  mma_fwd_single_q_tile<D>(q, k, v, mask ? mask + (size_t)blockIdx.z * Skv : nullptr, o, lse,
                           Sq, Skv, causal, scale, blockIdx.x * BQ, bh, smem_raw);
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

// B2 in float32 on the CUDA cores: as mma_bwd_single_kernel, on the
// bodies of float32 B4 and B5; at D128 the dq part runs on the first
// Fp32Dq<D>::NT threads of B4's Fp32Dkv<D>::NT
template <int D>
__global__ void __launch_bounds__(Fp32Dkv<D>::NT)
fp32_bwd_single_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ o, const float* __restrict__ lse,
                       const uint8_t* __restrict__ mask, float* __restrict__ dq,
                       float* __restrict__ dk, float* __restrict__ dv, int H, int Sq, int Skv,
                       int causal, float scale) {
  constexpr int NTB = Fp32Dkv<D>::NT;
  static_assert(NTB >= Fp32Dq<D>::NT, "the dq part fits the block");
  extern __shared__ __align__(16) float smem_f32[];
  const int x = blockIdx.x;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const uint8_t* mb = mask ? mask + (size_t)blockIdx.z * Skv : nullptr;
  if (x * BK < Skv)
    fp32_dkv_chunk<D, true>(q, k, v, dout, o, lse, nullptr, mb, dk, dv, Sq, Skv, causal, scale,
                            x * BK, bh, smem_f32);
  if (x * BQ < Sq) {
    __syncthreads();  // every thread is done with the dk/dv part's shared memory
    if (NTB == Fp32Dq<D>::NT || threadIdx.x < Fp32Dq<D>::NT)
      fp32_dq_tile<D, true, NTB>(q, k, v, dout, o, lse, nullptr, mb, dq, Sq, Skv, causal, scale,
                                 x * BQ, bh, smem_f32);
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const uint8_t* mask,
                       void* o, float* lse, int B, int H, int Sq, int Skv, int causal,
                       float scale, cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value, "the CUDA-core forward is float32");
  const void* ptrs[] = {q, k, v, o};
  if (!fp32_aligned(ptrs, 4)) return cudaErrorMisalignedAddress;
  // D = 64, Skv <= 128: 85.5 KB, two blocks an SM
  const size_t smem = Fp32Fwd1<D>::smem(Skv > Fp32Fwd1<D>::KC);
  cudaError_t err = cudaFuncSetAttribute(
      fp32_fwd_single_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fp32_fwd_single_kernel<D><<<grid, Fp32Fwd1<D>::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(o), lse, H, Sq, Skv, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, const uint8_t* mask,
                           void* o, float* lse, int B, int H, int Sq, int Skv, int causal,
                           float scale, cudaStream_t stream) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "the tensor-core path is bf16");
  const void* in[] = {q, k, v};
  const void* out[] = {o};
  if (!mma_aligned(in, 3, out, 1)) return cudaErrorMisalignedAddress;
  if (Skv > SINGLE_MAX_KV) return cudaErrorInvalidValue;
  const size_t smem = mma_fwd_single_smem<D>(Skv);  // D = 64, S = 128: 63.5 KB
  cudaError_t err = cudaFuncSetAttribute(
      mma_fwd_single_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  mma_fwd_single_kernel<D><<<grid, MMA_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(o), lse, H, Sq, Skv, causal, scale);
  return cudaGetLastError();
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
                       void* dv, int B, int H, int Sq, int Skv, int causal, float scale,
                       cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value, "the CUDA-core backward is float32");
  const void* ptrs[] = {q, k, v, dout, o, dq, dk, dv};
  if (!fp32_aligned(ptrs, 8)) return cudaErrorMisalignedAddress;
  // the larger part's: D = 64: 103.5 KB (dk/dv; dq 102.25 KB), two blocks
  // an SM; D = 128: 201.5 KB
  const size_t dkv = Fp32Dkv<D>::smem(true), dqs = Fp32Dq<D>::smem(true);
  const size_t smem = dkv > dqs ? dkv : dqs;
  cudaError_t err = cudaFuncSetAttribute(
      fp32_bwd_single_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_q = (Sq + BQ - 1) / BQ, n_kv = (Skv + BK - 1) / BK;
  dim3 grid(n_q > n_kv ? n_q : n_kv, H, B);
  fp32_bwd_single_kernel<D><<<grid, Fp32Dkv<D>::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const T*>(o), lse, mask, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Skv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// is_bf16: 0 = float32 inputs, 1 = bfloat16 inputs. mask: (B, Skv) bytes,
// nonzero = attend, or null. Returns a cudaError_t (0 = launched; bfloat16
// takes Skv <= SINGLE_MAX_KV; float32 tensors must be 16-byte aligned).
extern "C" int flash_single_fwd(const void* q, const void* k, const void* v, const void* mask,
                                void* o, void* lse, int B, int H, int Sq, int Skv, int D,
                                int is_bf16, int causal, float scale, void* stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    // the tensor-core kernel (mma_fwd_single_kernel); float32 runs fp32_fwd_single_kernel
    DISPATCH_D(__nv_bfloat16, launch_fwd_mma, q, k, v, m, o, l, B, H, Sq, Skv, causal, scale, s)
  }
  DISPATCH_D(float, launch_fwd, q, k, v, m, o, l, B, H, Sq, Skv, causal, scale, s)
}

// lse: (B, H, Sq) float32; di is computed in the kernel from o and dout.
extern "C" int flash_single_bwd(const void* q, const void* k, const void* v, const void* dout,
                                const void* o, const void* lse, const void* mask, void* dq,
                                void* dk, void* dv, int B, int H, int Sq, int Skv, int D,
                                int is_bf16, int causal, float scale, void* stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    // the tensor-core kernel (mma_bwd_single_kernel); float32 runs fp32_bwd_single_kernel
    DISPATCH_D(__nv_bfloat16, launch_bwd_mma, q, k, v, dout, o, l, m, dq, dk, dv, B, H, Sq, Skv,
               causal, scale, s)
  }
  DISPATCH_D(float, launch_bwd, q, k, v, dout, o, l, m, dq, dk, dv, B, H, Sq, Skv, causal,
             scale, s)
}
