// Stand-in for the CUDA runtime header, for a host compiler's syntax pass
// over betty_tpu_torch/csrc (tests/test_torch_csrc_syntax.py): the
// execution-space keywords are defined away and the runtime's types and
// device intrinsics are declared with host signatures. Nothing here runs.
#pragma once

#include <stddef.h>
#include <stdint.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)

struct uint3 {
  unsigned x, y, z;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
extern const uint3 threadIdx, blockIdx;
extern const dim3 blockDim, gridDim;

struct uint4 {
  unsigned x, y, z, w;
};
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
float2 make_float2(float, float);
float4 make_float4(float, float, float, float);

enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorMisalignedAddress = 716,
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef struct CUstream_st* cudaStream_t;

template <typename F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int);
cudaError_t cudaGetLastError();

void __syncthreads();
void __syncwarp(unsigned mask = 0xffffffffu);
float __fmul_rn(float, float);
float __fsub_rn(float, float);
float __shfl_xor_sync(unsigned, float, int);
float __shfl_down_sync(unsigned, float, int);
size_t __cvta_generic_to_shared(const void*);
int __ffs(int);
int atomicAdd(int*, int);
int __ffsll(long long);
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
