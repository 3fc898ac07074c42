// Device code shared by every flash-attention kernel (flash_single.cu,
// flash_multi.cu) and by the per-block bodies they run (flash_fp32.cuh for
// float32, flash_mma.cuh for bfloat16): the tile geometry, the masking
// constants, the cp.async copies, the column states of a k/v chunk, the
// SFU's 2^x, and the head-dim dispatch of the C entry points.
//
// Layout: q, k, v, o, do of shape (B, H, S, D), row-major and contiguous;
// lse and di of shape (B, H, S) in float32; the kv mask (B, Skv) bytes,
// nonzero = attend, or null.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // q rows per tile
constexpr int BK = 64;  // k/v rows per chunk
// -0.7 * max float32, as betty_tpu's MASK_VALUE: exp of it underflows to 0
// without the NaN traps of -inf
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr float LOG2E = 1.4426950408889634f;

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

// wait until at most N of this thread's committed groups, the newest, are
// still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

// 2^x on the SFU (ex2.approx.ftz: about 2^-22 relative error, results
// below 2^-126 flushed to 0, 2^-inf = 0), with no branch for denormal
// results as exp2f has
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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
