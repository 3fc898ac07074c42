// Tensor-core building blocks for the bfloat16 flash-attention kernels on
// Hopper (sm_90a): cp.async copies (helpers in flash_common.cuh) into padded
// bf16 tiles, ldmatrix fragment loads, the mma.sync m16n8k16 product (bf16
// operands, float32 accumulators) and the conversion of an accumulator into
// an A operand;
// and the per-block bodies built from them, shared by the kernels of
// flash_multi.cu (B3 mma_fwd_kernel, B4 mma_bwd_dkv_kernel, B5
// mma_bwd_dq_kernel) and flash_single.cu (B2 mma_bwd_single_kernel):
//   mma_fwd_q_tile   o and lse of one 64-row q tile (online softmax);
//   mma_dkv_chunk    dk and dv of one 64-row k/v chunk;
//   mma_dq_tile      dq of one 64-row q tile.
// Each body runs in a block of MMA_NT threads (4 warps, each owning 16 rows
// of the block's resident tile) and walks the other sequence through a
// 2-stage cp.async ring, one barrier a step (B2's dk/dv part adds one,
// after it sums di).
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

#include "flash_common.cuh"

namespace {

constexpr int MMA_NT = 128;  // threads of a tensor-core block: 4 warps of 16 rows

template <int D>
__host__ __device__ constexpr int tile_ld() {
  return D + 8;
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

// sum over columns c0..c0+N-1 of row r of two bf16 tiles of the products of
// their elements, in float32 (a product of two bf16 values is exact in
// float32); c0 even
template <int D, int N>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* a, const __nv_bfloat16* b, int r,
                                         int c0) {
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(a + r * tile_ld<D>() + c0);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(b + r * tile_ld<D>() + c0);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const uint32_t x = pa[i], y = pb[i];
    const uint32_t xl = x << 16, xh = x & 0xffff0000u, yl = y << 16, yh = y & 0xffff0000u;
    float f[4];
    memcpy(&f[0], &xl, 4);
    memcpy(&f[1], &xh, 4);
    memcpy(&f[2], &yl, 4);
    memcpy(&f[3], &yh, 4);
    sum += f[0] * f[2];
    sum += f[1] * f[3];
  }
  return sum;
}

// ---------------------------------------------------------------------------
// per-block bodies
// ---------------------------------------------------------------------------

// cp.async copies 16 bytes and the outputs are stored 4 at a time
inline bool mma_aligned(const void* const* in, int n_in, const void* const* out, int n_out) {
  for (int i = 0; i < n_in; ++i)
    if (reinterpret_cast<uintptr_t>(in[i]) % 16 != 0) return false;
  for (int i = 0; i < n_out; ++i)
    if (reinterpret_cast<uintptr_t>(out[i]) % 4 != 0) return false;
  return true;
}

// shared memory of mma_fwd_q_tile: the Q tile and two ring stages of K, V
template <int D>
constexpr size_t mma_fwd_smem() {
  return (size_t)5 * BQ * tile_ld<D>() * sizeof(__nv_bfloat16);
}

// shared memory of mma_dkv_chunk: K, V and two ring stages of Q, dO (and O
// with o_tiles), plus the ring's lse and di
template <int D>
constexpr size_t mma_dkv_smem(bool o_tiles) {
  return (size_t)(o_tiles ? 8 : 6) * BQ * tile_ld<D>() * sizeof(__nv_bfloat16) +
         (size_t)4 * BQ * sizeof(float);
}

// shared memory of mma_dq_tile: Q, dO (and O with o_tile) and two ring
// stages of K, V
template <int D>
constexpr size_t mma_dq_smem(bool o_tile) {
  return (size_t)(o_tile ? 7 : 6) * BQ * tile_ld<D>() * sizeof(__nv_bfloat16);
}

// The forward of the 64-row q tile from row q0 of head bh: o and lse of its
// rows, walking 64-row k/v chunks (up to the diagonal when causal) with an
// online softmax on the accumulators. mb: the batch element's kv mask
// (Skv bytes) or null. Warp w owns q rows 16w..16w+15; each thread holds
// rows g and g + 8 of them, whose running max m and partial sum l stay in
// registers (m is reduced over the 4 lanes of a quad every chunk, l once at
// the end, since every lane of a quad scales it by the same alpha).
// Semantics of betty_tpu's _fwd_kernel: masked scores are MASK_VALUE in the
// max, columns past the sequence -inf; p is zero where masked, l sums the
// unrounded p, p is rounded to bf16 before p V; a row with l = 0 gives
// o = 0 and lse = 0. Shared memory: mma_fwd_smem<D>().
template <int D>
__device__ __forceinline__ void mma_fwd_q_tile(const __nv_bfloat16* __restrict__ q,
                                               const __nv_bfloat16* __restrict__ k,
                                               const __nv_bfloat16* __restrict__ v,
                                               const uint8_t* __restrict__ mb,
                                               __nv_bfloat16* __restrict__ o,
                                               float* __restrict__ lse, int Sq, int Skv,
                                               int causal, float scale, int q0, size_t bh,
                                               unsigned char* smem_raw) {
  constexpr int TILE = BQ * tile_ld<D>(), KD = D / 16;
  constexpr bool RESIDENT = D <= 64;  // Q fragments held in registers
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + TILE;      // ring: [2][TILE]
  __nv_bfloat16* Vs = Ks + 2 * TILE;  // ring: [2][TILE]
  __shared__ int ms[2][BK];           // ring: column states

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = min(BQ, Sq - q0);
  // causal: chunks wholly above the tile's last row contribute nothing
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;

  auto load_kv_chunk = [&](int st, int k0) {
    const int nk = min(BK, Skv - k0);
    cp_async_tile<D, MMA_NT>(Ks + st * TILE, k + (bh * Skv + k0) * D, nk, tid);
    cp_async_tile<D, MMA_NT>(Vs + st * TILE, v + (bh * Skv + k0) * D, nk, tid);
  };

  cp_async_tile<D, MMA_NT>(Qs, q + (bh * Sq + q0) * D, nq, tid);
  load_kv_chunk(0, 0);
  cp_async_commit();
  load_col_state(ms[0], mb, 0, min(BK, Skv), tid);
  cp_async_wait_all();
  __syncthreads();

  const int r_lo = warp * 16 + (lane >> 2), t2 = 2 * (lane & 3);
  const uint32_t qs_u = smem_u32(Qs);
  const uint32_t off_a = frag_off_a<D>(lane), off_nk = frag_off_nk<D>(lane);
  uint32_t qf[RESIDENT ? KD : 1][4];
  if constexpr (RESIDENT) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ldsm_x4(qf[kk], qs_u + tile_off<D>(warp * 16, 16 * kk) + off_a);
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const float scale_log2 = scale * LOG2E;
  int st = 0;
  for (int k0 = 0; k0 < kv_end; k0 += BK, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this chunk has landed; every warp is done with the other stage
    const int k_next = k0 + BK;
    int next_state = 0;  // the next chunk's column state of k/v row tid
    if (k_next < kv_end) {
      load_kv_chunk(st ^ 1, k_next);
      if (tid < BK && k_next + tid < Skv)
        next_state = (mb == nullptr || mb[k_next + tid] != 0) ? 2 : 1;
    }
    cp_async_commit();

    const uint32_t ks_u = smem_u32(Ks + st * TILE), vs_u = smem_u32(Vs + st * TILE);
    // s = Q K^T: the warp's 16 q rows by 64 k/v columns
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (RESIDENT) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldsm_x4(a, qs_u + tile_off<D>(warp * 16, 16 * kk) + off_a);
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        uint32_t bk[4];
        ldsm_x4(bk, ks_u + tile_off<D>(16 * j, 16 * kk) + off_nk);
        mma_bf16(s[2 * j], a, bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], a, bk[2], bk[3]);
      }
    }

    // element e of n8 tile n is q row r_lo + 8 (e / 2), k/v column
    // 8 n + t2 + e % 2: the masked scaled scores' row max over the quad
    const int* col_state = ms[st];
    bool allowed[BK / 8][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + t2 + (e & 1), i = e >> 1, state = col_state[c];
        allowed[n][e] = state == 2 && (!causal || k0 + c <= q0 + r_lo + 8 * i);
        const float x = state == 0 ? -INFINITY : (allowed[n][e] ? s[n][e] * scale : MASK_VALUE);
        mx[i] = fmaxf(mx[i], x);
      }
    float alpha[2], m2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);  // finite: every chunk has a column of state >= 1
      alpha[i] = exp2f((m[i] - m_new) * LOG2E);
      m[i] = m_new;
      m2[i] = m_new * LOG2E;
    }
    // p = exp(s scale - m), zero where masked (selected, never multiplied)
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = allowed[n][e] ? exp2f(fmaf(s[n][e], scale_log2, -m2[e >> 1])) : 0.f;
        s[n][e] = p;
        psum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + psum[i];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // O += p V, p rounded to bf16 in the A operand
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vs_u + tile_off<D>(16 * j, 16 * jd) + off_a);
        mma_bf16(acc[2 * jd], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * jd + 1], pa, bv[2], bv[3]);
      }
    }
    // read at the next chunk, after its barrier; nobody reads this stage now
    if (k_next < kv_end && tid < BK) ms[st ^ 1][tid] = next_state;
  }

  float l_safe[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l_safe[i] = l[i] == 0.f ? 1.f : l[i];
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const float out[4] = {acc[n][0] / l_safe[0], acc[n][1] / l_safe[0], acc[n][2] / l_safe[1],
                          acc[n][3] / l_safe[1]};
    store_acc<D>(o + bh * Sq * D, out, q0 + warp * 16, 8 * n, Sq, lane);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r_lo + 8 * i;
      if (row < Sq) lse[bh * Sq + row] = l[i] == 0.f ? 0.f : m[i] + logf(l_safe[i]);
    }
  }
}

// B4's body: dk and dv of the 64-row k/v chunk from row k0 of head bh,
// walking the 64-row q tiles (from the first that reaches the diagonal
// when causal); warp w owns k/v rows 16w..16w+15 of the chunk. Computes
// s^T = K Q^T and dp^T = V dO^T, so that p^T and ds^T are accumulators of
// the warp's own k/v rows (lse and di are read by column from the ring),
// then dV += p^T dO and dK += ds^T Q with p and ds rounded to bf16 in the
// A operands. di = rowsum(o * do) of each q tile is read from `di`, or with
// DI_FROM_O (B2) computed here in float32 from the o and dO tiles, which
// the ring then carries too. mb: the batch element's kv mask or null.
// Shared memory: mma_dkv_smem<D>(DI_FROM_O).
template <int D, bool DI_FROM_O>
__device__ __forceinline__ void mma_dkv_chunk(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const __nv_bfloat16* __restrict__ o, const float* __restrict__ lse,
    const float* __restrict__ di, const uint8_t* __restrict__ mb,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int causal,
    float scale, int k0, size_t bh, unsigned char* smem_raw) {
  constexpr int TILE = BQ * tile_ld<D>(), KD = D / 16;
  constexpr bool RESIDENT = D <= 64;     // K and V fragments held in registers
  constexpr int NC = D <= 64 ? 64 : 32;  // q columns of s^T a pass
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + TILE;
  __nv_bfloat16* Qs = Vs + TILE;       // ring: [2][TILE]
  __nv_bfloat16* dOs = Qs + 2 * TILE;  // ring: [2][TILE]
  __nv_bfloat16* Os = dOs + 2 * TILE;  // ring: [2][TILE], with DI_FROM_O
  float* lse_s = reinterpret_cast<float*>(Os + (DI_FROM_O ? 2 * TILE : 0));  // ring: [2][BQ]
  float* di_s = lse_s + 2 * BQ;                                                // ring: [2][BQ]
  __shared__ int ms[BK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nk = min(BK, Skv - k0);
  // causal: q tiles wholly above the chunk's first column see none of it
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;

  // Q, dO (and O), lse and di of the q tile from row q0 into ring stage st
  auto load_q_tile = [&](int st, int q0) {
    const int nq = min(BQ, Sq - q0);
    cp_async_tile<D, MMA_NT>(Qs + st * TILE, q + (bh * Sq + q0) * D, nq, tid);
    cp_async_tile<D, MMA_NT>(dOs + st * TILE, dout + (bh * Sq + q0) * D, nq, tid);
    const int r = tid & (BQ - 1);
    if constexpr (DI_FROM_O) {
      cp_async_tile<D, MMA_NT>(Os + st * TILE, o + (bh * Sq + q0) * D, nq, tid);
      if (tid < BQ)
        cp_async4(smem_u32(lse_s + st * BQ + r), lse + bh * Sq + q0 + (r < nq ? r : 0), r < nq);
    } else {
      const float* src = (tid < BQ ? lse : di) + bh * Sq + q0;
      float* dst = (tid < BQ ? lse_s : di_s) + st * BQ;
      cp_async4(smem_u32(dst + r), src + (r < nq ? r : 0), r < nq);
    }
  };

  cp_async_tile<D, MMA_NT>(Ks, k + (bh * Skv + k0) * D, nk, tid);
  cp_async_tile<D, MMA_NT>(Vs, v + (bh * Skv + k0) * D, nk, tid);
  if (q_begin < Sq) load_q_tile(0, q_begin);
  cp_async_commit();
  load_col_state(ms, mb, k0, nk, tid);
  cp_async_wait_all();
  __syncthreads();

  // this thread's k/v rows of the chunk: r_lo and r_lo + 8
  const int r_lo = warp * 16 + (lane >> 2), t2 = 2 * (lane & 3);
  const bool row_ok[2] = {ms[r_lo] == 2, ms[r_lo + 8] == 2};
  const uint32_t ks_u = smem_u32(Ks), vs_u = smem_u32(Vs);
  const uint32_t off_a = frag_off_a<D>(lane), off_nk = frag_off_nk<D>(lane);
  uint32_t kf[RESIDENT ? KD : 1][4], vf[RESIDENT ? KD : 1][4];
  if constexpr (RESIDENT) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      ldsm_x4(kf[kk], ks_u + tile_off<D>(warp * 16, 16 * kk) + off_a);
      ldsm_x4(vf[kk], vs_u + tile_off<D>(warp * 16, 16 * kk) + off_a);
    }
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const float scale_log2 = scale * LOG2E;
  int st = 0;
  for (int q0 = q_begin; q0 < Sq; q0 += BQ, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; every warp is done with the other stage
    if (q0 + BQ < Sq) load_q_tile(st ^ 1, q0 + BQ);
    cp_async_commit();
    if constexpr (DI_FROM_O) {
      // di of the tile's rows in float32, two threads a row; read after
      // the barrier below
      const int r = tid >> 1, half = tid & 1;
      float sum = row_dot<D, D / 2>(Os + st * TILE, dOs + st * TILE, r, half * (D / 2));
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0) di_s[st * BQ + r] = sum;
    }

    const uint32_t qs_u = smem_u32(Qs + st * TILE), dos_u = smem_u32(dOs + st * TILE);
    const float* lse_t = lse_s + st * BQ;
    const float* di_t = di_s + st * BQ;
    const int nq = min(BQ, Sq - q0);
#pragma unroll
    for (int c0 = 0; c0 < BQ; c0 += NC) {
      // s^T = K Q^T and dp^T = V dO^T: the warp's 16 k/v rows by NC q columns
      float s[NC / 8][4], dp[NC / 8][4];
#pragma unroll
      for (int n = 0; n < NC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4], av[4];
        if constexpr (RESIDENT) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = kf[kk][i];
            av[i] = vf[kk][i];
          }
        } else {
          ldsm_x4(a, ks_u + tile_off<D>(warp * 16, 16 * kk) + off_a);
          ldsm_x4(av, vs_u + tile_off<D>(warp * 16, 16 * kk) + off_a);
        }
#pragma unroll
        for (int j = 0; j < NC / 16; ++j) {
          uint32_t bq[4], bo[4];
          ldsm_x4(bq, qs_u + tile_off<D>(c0 + 16 * j, 16 * kk) + off_nk);
          ldsm_x4(bo, dos_u + tile_off<D>(c0 + 16 * j, 16 * kk) + off_nk);
          mma_bf16(s[2 * j], a, bq[0], bq[1]);
          mma_bf16(s[2 * j + 1], a, bq[2], bq[3]);
          mma_bf16(dp[2 * j], av, bo[0], bo[1]);
          mma_bf16(dp[2 * j + 1], av, bo[2], bo[3]);
        }
      }
      if constexpr (DI_FROM_O) {
        if (c0 == 0) __syncthreads();  // every row's di is in di_s
      }
      // p^T and ds^T in place: element e of n8 tile n is k/v row
      // r_lo + 8 (e / 2) and q column c0 + 8 n + t2 + e % 2
#pragma unroll
      for (int n = 0; n < NC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 8 * n + t2 + (e & 1);
          // masked after the exp, as the TPU kernel: select, never multiply,
          // since a fully masked row has lse = 0 and the exp may overflow
          const bool allowed = c < nq && row_ok[e >> 1] &&
                               (!causal || k0 + r_lo + 8 * (e >> 1) <= q0 + c);
          const float p =
              allowed ? exp2f(fmaf(s[n][e], scale_log2, -lse_t[c] * LOG2E)) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - di_t[c]) * scale;
        }
      // dV += p^T dO and dK += ds^T Q over these NC q rows, p and ds rounded
      // to bf16 in the A operands
#pragma unroll
      for (int j = 0; j < NC / 16; ++j) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, s[2 * j], s[2 * j + 1]);
        acc_to_a(sa, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
        for (int jd = 0; jd < D / 16; ++jd) {
          uint32_t bo[4], bq[4];
          ldsm_x4_trans(bo, dos_u + tile_off<D>(c0 + 16 * j, 16 * jd) + off_a);
          ldsm_x4_trans(bq, qs_u + tile_off<D>(c0 + 16 * j, 16 * jd) + off_a);
          mma_bf16(dv_acc[2 * jd], pa, bo[0], bo[1]);
          mma_bf16(dv_acc[2 * jd + 1], pa, bo[2], bo[3]);
          mma_bf16(dk_acc[2 * jd], sa, bq[0], bq[1]);
          mma_bf16(dk_acc[2 * jd + 1], sa, bq[2], bq[3]);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    store_acc<D>(dk + bh * Skv * D, dk_acc[n], k0 + warp * 16, 8 * n, Skv, lane);
    store_acc<D>(dv + bh * Skv * D, dv_acc[n], k0 + warp * 16, 8 * n, Skv, lane);
  }
}

// B5's body: dq of the 64-row q tile from row q0 of head bh, walking the
// 64-row k/v chunks (up to the diagonal when causal); warp w owns q rows
// 16w..16w+15 of the tile, whose lse and di stay in registers. Computes
// s = Q K^T and dp = dO V^T, then dQ += ds K with ds rounded to bf16 in the
// A operand. di is read from `di`, or with DI_FROM_O (B2) computed here in
// float32 from the o and dO tiles. Shared memory: mma_dq_smem<D>(DI_FROM_O).
template <int D, bool DI_FROM_O>
__device__ __forceinline__ void mma_dq_tile(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const __nv_bfloat16* __restrict__ o, const float* __restrict__ lse,
    const float* __restrict__ di, const uint8_t* __restrict__ mb, __nv_bfloat16* __restrict__ dq,
    int Sq, int Skv, int causal, float scale, int q0, size_t bh, unsigned char* smem_raw) {
  constexpr int TILE = BQ * tile_ld<D>(), KD = D / 16;
  constexpr bool RESIDENT = D <= 64;  // Q and dO fragments held in registers
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + TILE;
  __nv_bfloat16* Ks = dOs + TILE;     // ring: [2][TILE]
  __nv_bfloat16* Vs = Ks + 2 * TILE;  // ring: [2][TILE]
  __nv_bfloat16* Os = Vs + 2 * TILE;  // with DI_FROM_O
  __shared__ int ms[2][BK];           // ring: column states

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = min(BQ, Sq - q0);
  // causal: chunks wholly above the tile's last row contribute nothing
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;

  // K and V of the k/v chunk from row k0 into ring stage st
  auto load_kv_chunk = [&](int st, int k0) {
    const int nk = min(BK, Skv - k0);
    cp_async_tile<D, MMA_NT>(Ks + st * TILE, k + (bh * Skv + k0) * D, nk, tid);
    cp_async_tile<D, MMA_NT>(Vs + st * TILE, v + (bh * Skv + k0) * D, nk, tid);
  };

  cp_async_tile<D, MMA_NT>(Qs, q + (bh * Sq + q0) * D, nq, tid);
  cp_async_tile<D, MMA_NT>(dOs, dout + (bh * Sq + q0) * D, nq, tid);
  if constexpr (DI_FROM_O) cp_async_tile<D, MMA_NT>(Os, o + (bh * Sq + q0) * D, nq, tid);
  if (kv_end > 0) load_kv_chunk(0, 0);
  cp_async_commit();
  load_col_state(ms[0], mb, 0, min(BK, Skv), tid);

  // this thread's q rows of the tile: r_lo and r_lo + 8, with lse (scaled
  // by log2 e) and di in registers
  const int r_lo = warp * 16 + (lane >> 2), t2 = 2 * (lane & 3);
  float lse2[2], di_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_lo + 8 * i;
    lse2[i] = row < Sq ? lse[bh * Sq + row] * LOG2E : 0.f;
    if constexpr (!DI_FROM_O) di_r[i] = row < Sq ? di[bh * Sq + row] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  if constexpr (DI_FROM_O) {
    // di of rows r_lo and r_lo + 8 in float32: a quarter of each row a lane
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = row_dot<D, D / 4>(Os, dOs, r_lo + 8 * i, (lane & 3) * (D / 4));
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      di_r[i] = sum;
    }
  }

  const uint32_t qs_u = smem_u32(Qs), dos_u = smem_u32(dOs);
  const uint32_t off_a = frag_off_a<D>(lane), off_nk = frag_off_nk<D>(lane);
  uint32_t qf[RESIDENT ? KD : 1][4], gf[RESIDENT ? KD : 1][4];
  if constexpr (RESIDENT) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      ldsm_x4(qf[kk], qs_u + tile_off<D>(warp * 16, 16 * kk) + off_a);
      ldsm_x4(gf[kk], dos_u + tile_off<D>(warp * 16, 16 * kk) + off_a);
    }
  }

  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  const float scale_log2 = scale * LOG2E;
  int st = 0;
  for (int k0 = 0; k0 < kv_end; k0 += BK, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this chunk has landed; every warp is done with the other stage
    const int k_next = k0 + BK;
    int next_state = 0;  // the next chunk's column state of k/v row tid
    if (k_next < kv_end) {
      load_kv_chunk(st ^ 1, k_next);
      if (tid < BK && k_next + tid < Skv)
        next_state = (mb == nullptr || mb[k_next + tid] != 0) ? 2 : 1;
    }
    cp_async_commit();

    const uint32_t ks_u = smem_u32(Ks + st * TILE), vs_u = smem_u32(Vs + st * TILE);
    // s = Q K^T and dp = dO V^T: the warp's 16 q rows by 64 k/v columns
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4], ag[4];
      if constexpr (RESIDENT) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = qf[kk][i];
          ag[i] = gf[kk][i];
        }
      } else {
        ldsm_x4(a, qs_u + tile_off<D>(warp * 16, 16 * kk) + off_a);
        ldsm_x4(ag, dos_u + tile_off<D>(warp * 16, 16 * kk) + off_a);
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, ks_u + tile_off<D>(16 * j, 16 * kk) + off_nk);
        ldsm_x4(bv, vs_u + tile_off<D>(16 * j, 16 * kk) + off_nk);
        mma_bf16(s[2 * j], a, bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], a, bk[2], bk[3]);
        mma_bf16(dp[2 * j], ag, bv[0], bv[1]);
        mma_bf16(dp[2 * j + 1], ag, bv[2], bv[3]);
      }
    }
    // ds in place: element e of n8 tile n is q row r_lo + 8 (e / 2) and k/v
    // column 8 n + t2 + e % 2; masked after the exp by selection
    const int* col_state = ms[st];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + t2 + (e & 1), i = e >> 1;
        const bool allowed =
            col_state[c] == 2 && (!causal || k0 + c <= q0 + r_lo + 8 * i);
        const float p = allowed ? exp2f(fmaf(s[n][e], scale_log2, -lse2[i])) : 0.f;
        dp[n][e] = p * (dp[n][e] - di_r[i]) * scale;
      }
    // dQ += ds K, ds rounded to bf16 in the A operand
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t sa[4];
      acc_to_a(sa, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
        uint32_t bk[4];
        ldsm_x4_trans(bk, ks_u + tile_off<D>(16 * j, 16 * jd) + off_a);
        mma_bf16(dq_acc[2 * jd], sa, bk[0], bk[1]);
        mma_bf16(dq_acc[2 * jd + 1], sa, bk[2], bk[3]);
      }
    }
    // read at the next chunk, after its barrier; nobody reads this stage now
    if (k_next < kv_end && tid < BK) ms[st ^ 1][tid] = next_state;
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    store_acc<D>(dq + bh * Sq * D, dq_acc[n], q0 + warp * 16, 8 * n, Sq, lane);
}

}  // namespace
