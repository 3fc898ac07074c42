// Vector kernels of the CG and Neumann solvers, for Hopper (sm_90a).
//
// Replaces the three Pallas kernels of betty_tpu/ops/vector.py:
//   vector_dot2          <- _dot2_kernel         (B6, vector.py:85, launched by fused_dot2)
//   vector_cg_step       <- _cg_step_kernel      (B7, vector.py:119, cg_fused_step)
//   vector_neumann_step  <- _neumann_step_kernel (B8, vector.py:163, neumann_fused_step)
// over flat float32 vectors of any length n (the solvers pass the raveled
// parameter tree, about 3.5e8 elements for the RoBERTa-large classifier).
//
// What bounds them on this card: each element is read once and written at
// most once, with at most 4 flops per element against at least 16 bytes, so
// all three are bound by device memory (3.35 TB/s), far from any compute
// rate. The design therefore does one thing: stream every vector through
// once at full width.
//   * Grid-stride loops with 16-byte (float4) loads and stores, neighbouring
//     threads on neighbouring addresses, at most 1024 blocks of 256 threads
//     (enough to fill 132 SMs; the wrapper requires 16-byte aligned
//     pointers); the ragged tail of n % 4 elements is a scalar loop.
//   * The TPU kernels carry their dot products from one grid step to the
//     next in SMEM; here blocks run in parallel and in no order, so a dot is
//     two passes: each block writes its float32 partial sum to a scratch row
//     (a warp-shuffle tree inside the block), and one small launch sums the
//     partials of each row in a fixed order. No atomics, so the result is
//     the same from run to run for the same n.
//   * CG's step size ak is read through a device pointer, so the solver
//     never waits for the host between iterations.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;      // threads per block of the streaming kernels
constexpr int MAX_BLOCKS = 1024;  // blocks of a streaming kernel = partials per row
constexpr int REDUCE_THREADS = 1024;

int grid_for(long long n) {
  long long blocks = ((n >> 2) + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  return static_cast<int>(blocks);
}

// Sum of v over the block, in a fixed order; the result is valid in thread 0.
// Starts with a barrier so two calls in a row may share the scratch.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Second pass of a dot: block r sums partials[r * MAX_BLOCKS + 0 .. ncols).
__global__ void __launch_bounds__(REDUCE_THREADS)
sum_partials(const float* __restrict__ partials, int ncols, float* __restrict__ out) {
  float v = 0.0f;
  for (int i = threadIdx.x; i < ncols; i += blockDim.x) v += partials[blockIdx.x * MAX_BLOCKS + i];
  v = block_sum(v);
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

// B6: (<a, b>, <c, d>) with one read of each vector. Bytes-bound: 16 n bytes
// read, 4 n flops.
__global__ void __launch_bounds__(THREADS)
dot2_kernel(const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ c, const float* __restrict__ d, long long n,
            float* __restrict__ partials) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n4 = n >> 2;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  const float4* c4 = reinterpret_cast<const float4*>(c);
  const float4* d4 = reinterpret_cast<const float4*>(d);
  float s0 = 0.0f, s1 = 0.0f;
  for (long long i = tid; i < n4; i += stride) {
    const float4 x = a4[i], y = b4[i], z = c4[i], w = d4[i];
    s0 += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
    s1 += z.x * w.x + z.y * w.y + z.z * w.z + z.w * w.w;
  }
  for (long long i = (n4 << 2) + tid; i < n; i += stride) {
    s0 += a[i] * b[i];
    s1 += c[i] * d[i];
  }
  s0 = block_sum(s0);
  s1 = block_sum(s1);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s0;
    partials[MAX_BLOCKS + blockIdx.x] = s1;
  }
}

// B7: x' = x + ak p, r' = r - ak hvp and the partial sums of <r', r'>, in one
// pass. Bytes-bound: 16 n bytes read, 8 n written, 6 n flops.
__global__ void __launch_bounds__(THREADS)
cg_step_kernel(const float* __restrict__ ak_ptr, const float* __restrict__ x,
               const float* __restrict__ p, const float* __restrict__ r,
               const float* __restrict__ hvp, float* __restrict__ x_out,
               float* __restrict__ r_out, long long n, float* __restrict__ partials) {
  const float ak = *ak_ptr;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n4 = n >> 2;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const float4* r4 = reinterpret_cast<const float4*>(r);
  const float4* h4 = reinterpret_cast<const float4*>(hvp);
  float4* xo4 = reinterpret_cast<float4*>(x_out);
  float4* ro4 = reinterpret_cast<float4*>(r_out);
  float s = 0.0f;
  for (long long i = tid; i < n4; i += stride) {
    const float4 xv = x4[i], pv = p4[i], rv = r4[i], hv = h4[i];
    float4 xo, ro;
    xo.x = xv.x + ak * pv.x;
    xo.y = xv.y + ak * pv.y;
    xo.z = xv.z + ak * pv.z;
    xo.w = xv.w + ak * pv.w;
    ro.x = rv.x - ak * hv.x;
    ro.y = rv.y - ak * hv.y;
    ro.z = rv.z - ak * hv.z;
    ro.w = rv.w - ak * hv.w;
    xo4[i] = xo;
    ro4[i] = ro;
    s += ro.x * ro.x + ro.y * ro.y + ro.z * ro.z + ro.w * ro.w;
  }
  for (long long i = (n4 << 2) + tid; i < n; i += stride) {
    x_out[i] = x[i] + ak * p[i];
    const float rn = r[i] - ak * hvp[i];
    r_out[i] = rn;
    s += rn * rn;
  }
  s = block_sum(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// B8: v' = v - alpha hv, p' = p + v', in one pass. Bytes-bound: 12 n bytes
// read, 8 n written, 3 n flops.
__global__ void __launch_bounds__(THREADS)
neumann_step_kernel(float alpha, const float* __restrict__ v, const float* __restrict__ hv,
                    const float* __restrict__ p, float* __restrict__ v_out,
                    float* __restrict__ p_out, long long n) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n4 = n >> 2;
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const float4* h4 = reinterpret_cast<const float4*>(hv);
  const float4* p4 = reinterpret_cast<const float4*>(p);
  float4* vo4 = reinterpret_cast<float4*>(v_out);
  float4* po4 = reinterpret_cast<float4*>(p_out);
  for (long long i = tid; i < n4; i += stride) {
    const float4 vv = v4[i], hh = h4[i], pp = p4[i];
    float4 vo, po;
    vo.x = vv.x - alpha * hh.x;
    vo.y = vv.y - alpha * hh.y;
    vo.z = vv.z - alpha * hh.z;
    vo.w = vv.w - alpha * hh.w;
    po.x = pp.x + vo.x;
    po.y = pp.y + vo.y;
    po.z = pp.z + vo.z;
    po.w = pp.w + vo.w;
    vo4[i] = vo;
    po4[i] = po;
  }
  for (long long i = (n4 << 2) + tid; i < n; i += stride) {
    const float vn = v[i] - alpha * hv[i];
    v_out[i] = vn;
    p_out[i] = p[i] + vn;
  }
}

}  // namespace

// Floats of scratch the dot kernels need: two rows of MAX_BLOCKS partials.
extern "C" int vector_scratch_floats() { return 2 * MAX_BLOCKS; }

extern "C" int vector_dot2(const void* a, const void* b, const void* c, const void* d,
                           long long n, void* partials, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(n);
  dot2_kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(d), n, static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials<<<2, REDUCE_THREADS, 0, s>>>(static_cast<const float*>(partials), blocks,
                                            static_cast<float*>(out));
  return cudaGetLastError();
}

extern "C" int vector_cg_step(const void* ak, const void* x, const void* p, const void* r,
                              const void* hvp, void* x_out, void* r_out, long long n,
                              void* partials, void* rr_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(n);
  cg_step_kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<const float*>(ak), static_cast<const float*>(x), static_cast<const float*>(p),
      static_cast<const float*>(r), static_cast<const float*>(hvp), static_cast<float*>(x_out),
      static_cast<float*>(r_out), n, static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials<<<1, REDUCE_THREADS, 0, s>>>(static_cast<const float*>(partials), blocks,
                                            static_cast<float*>(rr_out));
  return cudaGetLastError();
}

extern "C" int vector_neumann_step(float alpha, const void* v, const void* hv, const void* p,
                                   void* v_out, void* p_out, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  neumann_step_kernel<<<grid_for(n), THREADS, 0, s>>>(
      alpha, static_cast<const float*>(v), static_cast<const float*>(hv),
      static_cast<const float*>(p), static_cast<float*>(v_out), static_cast<float*>(p_out), n);
  return cudaGetLastError();
}
