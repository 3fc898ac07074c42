// Tensor-core building blocks for the bfloat16 flash-attention kernels on
// Hopper (sm_90a): cp.async copies into padded bf16 tiles, ldmatrix
// fragment loads, the mma.sync m16n8k16 product (bf16 operands, float32
// accumulators) and the conversion of an accumulator into an A operand.
// flash_multi.cu's bf16 backward kernels (B4, B5) use them; the forward
// kernels can reuse them.
//
// Fragment layouts assumed (PTX ISA, "Matrix Fragments for mma.m16n8k16"
// with .bf16 operands), for lane l of a warp, g = l / 4, t = l % 4; a pair
// "(r, c..c+1)" is one 32-bit register, the lower column in its low half:
//   A, 16 x 16 (row-major):  a0 = (g, 2t..2t+1)    a1 = (g+8, 2t..2t+1)
//                            a2 = (g, 2t+8..2t+9)  a3 = (g+8, 2t+8..2t+9)
//   B, 16 x 8 (k x n):       b0 = (k 2t..2t+1, n g)  b1 = (k 2t+8..2t+9, n g)
//   C/D, 16 x 8 (float32):   c0, c1 = (g, 2t), (g, 2t+1)
//                            c2, c3 = (g+8, 2t), (g+8, 2t+1)
// So the accumulators of two neighbouring n8 tiles (columns 16j..16j+7 and
// 16j+8..16j+15) are, rounded to bf16 and packed in pairs, the A operand of
// a product whose k-step j runs over those 16 columns (acc_to_a below): p
// and ds go from one product into the next without shared memory.
//
// ldmatrix .x4 loads four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i of lane l receives matrix i's
// (row g, columns 2t..2t+1), or with .trans its (rows 2t..2t+1, column g).
// With tile[r][c] row-major in shared memory:
//   ldsm_x4 at frag_off_a:               the A operand of rows r0..r0+15,
//       columns c0..c0+15 (registers a0..a3);
//   ldsm_x4 at frag_off_nk:              the B operands of X * tile^T, where
//       tile holds (n, k): n rows n0..n0+15 as two n8 tiles, k c0..c0+15
//       (registers b0, b1 of the first tile, b0, b1 of the second);
//   ldsm_x4_trans at frag_off_a:         the B operands of X * tile, where
//       tile holds (k, n): k rows r0..r0+15, n columns c0..c0+15 as two
//       n8 tiles (b0, b1 of the first, b0, b1 of the second).
//
// Tiles are 64 rows of D bf16 with a row stride of D + 8 elements
// (tile_ld): a multiple of 16 bytes, as cp.async and ldmatrix need, and
// 4 banks apart from row to row mod 32 banks, so the eight rows of one
// 8 x 8 matrix fall in distinct banks and ldmatrix is free of conflicts.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

template <int D>
__host__ __device__ constexpr int tile_ld() {
  return D + 8;
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

// rows [0, 64) x D of a row-major (rows, D) bf16 source into a tile of
// stride tile_ld<D>(); rows at or past `valid` are zero. NTHREADS threads,
// 16 bytes a copy, neighbouring threads on neighbouring addresses.
template <int D, int NTHREADS>
__device__ __forceinline__ void cp_async_tile(__nv_bfloat16* dst,
                                              const __nv_bfloat16* __restrict__ src, int valid,
                                              int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int idx = tid; idx < 64 * CPR; idx += NTHREADS) {
    const int r = idx / CPR, c = (idx - r * CPR) * 8;
    const bool ok = r < valid;
    cp_async16(smem_u32(dst + r * tile_ld<D>() + c), src + (ok ? (size_t)r * D + c : 0), ok);
  }
}

// byte offsets of lane's row address inside a 16 x 16 block (see the top)
template <int D>
__device__ __forceinline__ uint32_t frag_off_a(int lane) {
  return (uint32_t)(((lane & 15) * tile_ld<D>() + (lane >> 4) * 8) * 2);
}

template <int D>
__device__ __forceinline__ uint32_t frag_off_nk(int lane) {
  const int row = (lane & 7) + (lane >> 4) * 8, col = ((lane >> 3) & 1) * 8;
  return (uint32_t)((row * tile_ld<D>() + col) * 2);
}

// byte offset of element (r, c) of a tile
template <int D>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  return (uint32_t)((r * tile_ld<D>() + c) * 2);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b for one 16 x 8 tile: a 16 x 16 and b 16 x 8 in bf16, d float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &h, sizeof(r));
  return r;
}

// the A operand of k-step j from the float32 values of n8 tiles 2j
// (lo) and 2j+1 (hi), in C layout, rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// a 16 x 8 float32 accumulator tile (C layout) rounded to bf16 into rows
// r0 + g and r0 + g + 8, columns c0 + 2t..2t+1, of a row-major (rows, D)
// output (4-byte aligned); rows at or past `rows` are not written
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* __restrict__ out, const float (&c)[4],
                                          int r0, int c0, int rows, int lane) {
  const int r = r0 + (lane >> 2), col = c0 + 2 * (lane & 3);
  if (r < rows) *reinterpret_cast<uint32_t*>(out + (size_t)r * D + col) = pack_bf16(c[0], c[1]);
  if (r + 8 < rows)
    *reinterpret_cast<uint32_t*>(out + (size_t)(r + 8) * D + col) = pack_bf16(c[2], c[3]);
}

}  // namespace
