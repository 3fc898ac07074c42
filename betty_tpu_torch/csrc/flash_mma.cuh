// Tensor-core building blocks for the bfloat16 flash-attention kernels on
// Hopper (sm_90a): cp.async copies (helpers in flash_common.cuh) into padded
// bf16 tiles, ldmatrix fragment loads, the mma.sync m16n8k16 product (bf16
// operands, float32 accumulators) and the conversion of an accumulator into
// an A operand;
// and the per-block bodies built from them, shared by the kernels of
// flash_multi.cu (B3 mma_fwd_kernel, B4 mma_bwd_dkv_kernel, B5
// mma_bwd_dq_kernel) and flash_single.cu (B1 mma_fwd_single_kernel, B2
// mma_bwd_single_kernel):
//   mma_fwd_q_tile         o and lse of one 64-row q tile (online softmax);
//   mma_fwd_single_q_tile  the same for B1, p against the row max, taken in
//                          a first walk;
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

// the float32 values of a pair of bf16 (lo in the low half)
__device__ __forceinline__ void bf16x2_to_f32(uint32_t w, float& lo, float& hi) {
  const uint32_t a = w << 16, b = w & 0xffff0000u;
  memcpy(&lo, &a, 4);
  memcpy(&hi, &b, 4);
}

// sum_d a[d] b[d] over D bf16 values (16-byte aligned, in shared memory)
// as one chain of fmaf, d ascending: the order of a SIMT float32 matrix
// product, which the plain version's einsum runs on the card
template <int D>
__device__ __forceinline__ float dot_chain(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  const uint4* pa = reinterpret_cast<const uint4*>(a);
  const uint4* pb = reinterpret_cast<const uint4*>(b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const uint4 wa = pa[i], wb = pb[i];
    const uint32_t xa[4] = {wa.x, wa.y, wa.z, wa.w}, xb[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      float a0, a1, b0, b1;
      bf16x2_to_f32(xa[w], a0, a1);
      bf16x2_to_f32(xb[w], b0, b1);
      s = fmaf(a0, b0, s);
      s = fmaf(a1, b1, s);
    }
  }
  return s;
}

// two such chains at once: s[0] of a0 and b0, s[1] of a1 and b1
template <int D>
__device__ __forceinline__ void dot_chain2(const __nv_bfloat16* a0, const __nv_bfloat16* b0,
                                           const __nv_bfloat16* a1, const __nv_bfloat16* b1,
                                           float (&s)[2]) {
  const uint4* p[4] = {reinterpret_cast<const uint4*>(a0), reinterpret_cast<const uint4*>(b0),
                       reinterpret_cast<const uint4*>(a1), reinterpret_cast<const uint4*>(b1)};
  s[0] = s[1] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    uint4 w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = p[u][i];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint32_t xa[4] = {w[2 * c].x, w[2 * c].y, w[2 * c].z, w[2 * c].w};
      const uint32_t xb[4] = {w[2 * c + 1].x, w[2 * c + 1].y, w[2 * c + 1].z, w[2 * c + 1].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float f0, f1, g0, g1;
        bf16x2_to_f32(xa[q], f0, f1);
        bf16x2_to_f32(xb[q], g0, g1);
        s[c] = fmaf(f0, g0, s[c]);
        s[c] = fmaf(f1, g1, s[c]);
      }
    }
  }
}

// float32 ulps of p from a bf16 rounding midpoint within which B1 takes p
// again from the plain chain's s: the tensor-core s moved p by at most 36
// ulps in an emulation of truncating tensor-core sums (randn inputs, D16 to
// D128, S128 and S512; tests/test_torch_b1_rounding.py)
constexpr int PFLIP_ULPS = 128;

// the elements of o a pass of B1's third walk takes again: two a thread
constexpr int FIX_MAX = 2 * MMA_NT;

// B1 takes an o element again from the plain chain where |acc| <
// O_FLAG sum_j p_j |v_jd|; elsewhere one bf16 ulp of acc is above 2^-18 of
// that sum, and the emulated |acc_tc - acc_chain| stayed under 2^-20 of it
constexpr float O_FLAG = 1.f / 1024.f;

// true when rounding p to bf16 (nearest even: on the low 16 bits) could go
// the other way for a p within PFLIP_ULPS float32 ulps of it
__device__ __forceinline__ bool near_bf16_midpoint(float p) {
  uint32_t b;
  memcpy(&b, &p, 4);
  const int low = (int)(b & 0xffffu) - 0x8000;
  return low <= PFLIP_ULPS && low >= -PFLIP_ULPS;
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

// row stride (bf16 elements) of B1's p rows in shared memory: Skv rounded up
// to whole chunks, plus 8, so that a quad's 4-byte stores of 8 rows fall in
// 32 distinct banks
__host__ __device__ constexpr int single_p_ld(int Skv) { return (Skv + BK - 1) / BK * BK + 8; }

// the most keys B1 takes: its rows' p stay in shared memory (227 KB a block)
constexpr int SINGLE_MAX_KV = 1024;

// shared memory of mma_fwd_single_q_tile (B1): mma_fwd_smem and the rows' p
template <int D>
constexpr size_t mma_fwd_single_smem(int Skv) {
  return mma_fwd_smem<D>() + (size_t)BQ * single_p_ld(Skv) * sizeof(__nv_bfloat16);
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

  const int last = st ^ 1;  // the stage of the last chunk
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

// B1's body (betty_tpu's _fwd_single_kernel): o and lse of the 64-row q
// tile from row q0 of head bh, with p rounded to bf16 against the max of
// the whole row, as the single-tile TPU kernel rounds it and as the plain
// version (_fwd_single_plain) does with float32 FMA chains. Warps, rows,
// the ring, the s and p V products and the masking are mma_fwd_q_tile's
// (kept apart from it: B3's register allocation sits at ptxas's
// 128-register edge); the k/v chunks (up to the diagonal when causal) are walked twice:
// first K alone, for each row's max m; then K and V for p = exp(s scale -
// m), l and O += p V with alpha = 1.
//
// The tensor cores sum the 16 products of a k-step with truncation, in
// another order than a chain of fmaf, so s and p V may differ from the
// plain version's in their last bits (on an H100 44 % of s do); that is
// harmless except where it flips a bf16 rounding, so three things are
// taken again as the plain chains give them (dot_chain: d ascending):
//   * the row max m, from which every p of the row is taken: in the first
//     walk each lane recomputes its own max's score as the chain whenever
//     the max moves (from the chunk in shared memory); the lanes within
//     2^-12 of the row's tensor-core max give the row's m;
//   * p: p = 2^(s scale log2 e - m log2 e) from the tensor-core s; where it
//     lies within PFLIP_ULPS float32 ulps of a bf16 rounding midpoint, s is
//     recomputed as the chain and p = expf(s scale - m), as torch.exp with
//     s scale and the difference rounded apart; elsewhere the bf16 p is
//     the plain one;
//   * o: where |acc| < O_FLAG sum_j p_j |v_jd| (a fourth product, p |V|, on
//     the tensor cores), a sum that nearly cancels, the element is listed;
//     a third walk over the V chunks (the last two are still in the ring's
//     stages) takes each listed element as the chain over its row's bf16 p,
//     kept in shared memory (Ps), one element a thread.
// A row with l = 0 gives o = 0 and lse = 0. Shared memory:
// mma_fwd_single_smem<D>(Skv).
template <int D>
__device__ __forceinline__ void mma_fwd_single_q_tile(const __nv_bfloat16* __restrict__ q,
                                                      const __nv_bfloat16* __restrict__ k,
                                                      const __nv_bfloat16* __restrict__ v,
                                                      const uint8_t* __restrict__ mb,
                                                      __nv_bfloat16* __restrict__ o,
                                                      float* __restrict__ lse, int Sq, int Skv,
                                                      int causal, float scale, int q0, size_t bh,
                                                      unsigned char* smem_raw) {
  constexpr int TILE = BQ * tile_ld<D>(), KD = D / 16, LD = tile_ld<D>();
  constexpr bool RESIDENT = D <= 64;  // Q fragments held in registers
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + TILE;      // ring: [2][TILE]
  __nv_bfloat16* Vs = Ks + 2 * TILE;  // ring: [2][TILE]
  __nv_bfloat16* Ps = Vs + 2 * TILE;  // the rows' bf16 p: [BQ][p_ld]
  __shared__ int ms[2][BK];           // ring: column states
  __shared__ float l_s[BQ];           // the rows' l (1 where 0)
  __shared__ int fix_n;               // elements taken again: how many, and
  __shared__ uint16_t fix_list[FIX_MAX];  // which (row << 8 | column)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = min(BQ, Sq - q0);
  // causal: chunks wholly above the tile's last row contribute nothing
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int n = (kv_end + BK - 1) / BK, p_ld = single_p_ld(Skv);

  // K (and with_v V) and the column states of chunk c into ring stage st;
  // the states are computed now and stored by set_states after the step
  auto load_chunk = [&](int st, int c, bool with_v) {
    const int k0 = c * BK, nk = min(BK, Skv - k0);
    cp_async_tile<D, MMA_NT>(Ks + st * TILE, k + (bh * Skv + k0) * D, nk, tid);
    if (with_v) cp_async_tile<D, MMA_NT>(Vs + st * TILE, v + (bh * Skv + k0) * D, nk, tid);
    cp_async_commit();
    int state = 0;
    if (tid < BK && k0 + tid < Skv) state = (mb == nullptr || mb[k0 + tid] != 0) ? 2 : 1;
    return state;
  };
  // read at the next step, after its barrier; nobody reads that stage now
  auto set_states = [&](int st, int state) {
    if (tid < BK) ms[st][tid] = state;
  };

  cp_async_tile<D, MMA_NT>(Qs, q + (bh * Sq + q0) * D, nq, tid);
  set_states(0, load_chunk(0, 0, false));
  if (tid == 0) fix_n = 0;
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

  // s = Q K^T of ring stage st: the warp's 16 q rows by 64 k/v columns;
  // element e of n8 tile j is q row r_lo + 8 (e / 2), k/v column
  // 8 j + t2 + e % 2, and `allowed` says whether it is attended
  auto scores = [&](int st, int k0, float (&s)[BK / 8][4], bool (&allowed)[BK / 8][4]) {
    const uint32_t ks_u = smem_u32(Ks + st * TILE);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
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
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + t2 + (e & 1);
        allowed[j][e] = ms[st][c] == 2 && (!causal || k0 + c <= q0 + r_lo + 8 * (e >> 1));
      }
  };

  // first walk (K only): the thread's max of each of its rows of the masked
  // scaled scores (MASK_VALUE where masked, -inf past the sequence) and,
  // when it is an attended score, that score as the plain chain gives it,
  // taken from the chunk in shared memory whenever the max moves
  float own_max[2] = {-INFINITY, -INFINITY}, own_exact[2] = {-INFINITY, -INFINITY};
  int st = 0;
  for (int c = 0; c < n; ++c, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this chunk has landed; every warp is done with the other stage
    // the next chunk, or the second walk's first with its V
    const int next = c + 1 < n ? load_chunk(st ^ 1, c + 1, false) : load_chunk(st ^ 1, 0, true);
    float s[BK / 8][4];
    bool allowed[BK / 8][4];
    scores(st, c * BK, s, allowed);
    float cmax[2] = {-INFINITY, -INFINITY};
    int ccol[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + t2 + (e & 1), i = e >> 1;
        const float x = allowed[j][e] ? __fmul_rn(s[j][e], scale)
                                      : (c * BK + col < Skv ? MASK_VALUE : -INFINITY);
        if (x > cmax[i]) {
          cmax[i] = x;
          ccol[i] = col;
        }
      }
    const bool moved[2] = {cmax[0] > own_max[0], cmax[1] > own_max[1]};
    if (moved[0] || moved[1]) {
      // both rows' chains at once, so that their latencies overlap
      float x[2];
      dot_chain2<D>(Qs + r_lo * LD, Ks + st * TILE + ccol[0] * LD, Qs + (r_lo + 8) * LD,
                    Ks + st * TILE + ccol[1] * LD, x);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (moved[i]) {
          own_max[i] = cmax[i];
          // an attended column's score is finite, above MASK_VALUE
          own_exact[i] = cmax[i] > MASK_VALUE ? __fmul_rn(x[i], scale) : -INFINITY;
        }
    }
    set_states(st ^ 1, next);
  }

  // the row max as the plain version's: the quad's max of the tensor-core
  // scores, then the plain chain's of the lanes near it
  float m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mt = fmaxf(own_max[i], __shfl_xor_sync(0xffffffffu, own_max[i], 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    float exact =
        own_max[i] >= mt - fmaxf(1.f, fabsf(mt)) * (1.f / 4096.f) ? own_exact[i] : -INFINITY;
    exact = fmaxf(exact, __shfl_xor_sync(0xffffffffu, exact, 1));
    exact = fmaxf(exact, __shfl_xor_sync(0xffffffffu, exact, 2));
    m[i] = exact == -INFINITY ? mt : exact;
  }

  // second walk (K and V): p, l, O += p V and the bound sum_j p_j |v_jd| of
  // each element, the scale of its float32 rounding
  const float scale_log2 = scale * LOG2E, m2[2] = {m[0] * LOG2E, m[1] * LOG2E};
  float l[2] = {0.f, 0.f}, acc[D / 8][4], bnd[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = bnd[j][e] = 0.f;
  for (int c = 0; c < n; ++c, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this chunk has landed; every warp is done with the other stage
    const int next = c + 1 < n ? load_chunk(st ^ 1, c + 1, true) : 0;
    const int k0 = c * BK;
    float s[BK / 8][4];
    bool allowed[BK / 8][4];
    scores(st, k0, s, allowed);
    // p = exp(s scale - m), zero where masked (an exponent of -inf); the p
    // near a bf16 rounding midpoint (bit 4 j + e of `again`) are taken again
    // from the plain chain's s, one a lane at a time
    uint32_t again = 0;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            exp2_sfu(allowed[j][e] ? fmaf(s[j][e], scale_log2, -m2[e >> 1]) : -INFINITY);
        if (allowed[j][e] && near_bf16_midpoint(p)) again |= 1u << (4 * j + e);
        s[j][e] = p;
      }
    while (again) {
      const int b = __ffs((int)again) - 1, i = (b & 3) >> 1;
      again &= again - 1;
      const int col = 8 * (b >> 2) + t2 + (b & 1);
      const float x =
          __fmul_rn(dot_chain<D>(Qs + (r_lo + 8 * i) * LD, Ks + st * TILE + col * LD), scale);
      const float p = expf(__fsub_rn(x, i ? m[1] : m[0]));
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * j + e == b) s[j][e] = p;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += s[j][e];
    // O += p V and the bound += p |V|, p rounded to bf16 in the A operand
    const uint32_t vs_u = smem_u32(Vs + st * TILE);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * j], s[2 * j + 1]);
      // the rows' bf16 p, for the o elements taken again at the end
      uint32_t* prow = reinterpret_cast<uint32_t*>(Ps + r_lo * p_ld + k0 + 16 * j + t2);
      prow[0] = pa[0];
      prow[4 * p_ld] = pa[1];
      prow[4] = pa[2];
      prow[4 * p_ld + 4] = pa[3];
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vs_u + tile_off<D>(16 * j, 16 * jd) + off_a);
        mma_bf16(acc[2 * jd], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * jd + 1], pa, bv[2], bv[3]);
        // |v|: the sign bits cleared
        mma_bf16(bnd[2 * jd], pa, bv[0] & 0x7fff7fffu, bv[1] & 0x7fff7fffu);
        mma_bf16(bnd[2 * jd + 1], pa, bv[2] & 0x7fff7fffu, bv[3] & 0x7fff7fffu);
      }
    }
    if (c + 1 < n) set_states(st ^ 1, next);
  }

  const int last = st ^ 1;  // the stage of the last chunk
  float l_safe[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l_safe[i] = l[i] == 0.f ? 1.f : l[i];
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r_lo + 8 * i;
      l_s[r_lo + 8 * i] = l_safe[i];
      if (row < Sq) lse[bh * Sq + row] = l[i] == 0.f ? 0.f : m[i] + logf(l_safe[i]);
    }
  }
  // o; the elements whose sum nearly cancels (bit 4 j + e of `again`) are
  // written again below from the plain chain
  uint64_t again = 0;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    float out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (fabsf(acc[j][e]) < bnd[j][e] * O_FLAG && q0 + r_lo + 8 * (e >> 1) < Sq)
        again |= 1ull << (4 * j + e);
      out[e] = acc[j][e] / l_safe[e >> 1];
    }
    store_acc<D>(o + bh * Sq * D, out, q0 + warp * 16, 8 * j, Sq, lane);
  }
  // in passes of up to FIX_MAX elements of the block, listed in fix_list:
  // a third walk over the V chunks (through the ring's V stages) takes
  // each listed element as the plain chain over its row's bf16 p (Ps), one
  // element a thread
  for (int pass = 0;; ++pass) {
    if (pass > 0) {
      __syncthreads();  // the last pass is done with the list
      if (tid == 0) fix_n = 0;
      __syncthreads();
    }
    while (again) {
      const int b = __ffsll((long long)again) - 1, e = b & 3;
      const int slot = atomicAdd(&fix_n, 1);
      if (slot >= FIX_MAX) break;  // the rest wait for the next pass
      again &= again - 1;
      fix_list[slot] = (uint16_t)(((r_lo + 8 * (e >> 1)) << 8) | (8 * (b >> 2) + t2 + (e & 1)));
    }
    __syncthreads();  // the list, o, Ps and l_s are written
    const int wanted = fix_n, listed = min(wanted, FIX_MAX);
    // this thread's elements: slots tid and tid + MMA_NT
    int fr[2], fc[2];
    float fa[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int slot = tid + u * MMA_NT;
      const int code = slot < listed ? fix_list[slot] : 0;
      fr[u] = slot < listed ? code >> 8 : -1;
      fc[u] = code & 0xff;
    }
    // the second walk left its last chunk in stage `last` and the one
    // before in the other; with more than two chunks those before the last
    // are loaded again, one at a time, into the other stage
    for (int c = 0; c < (listed > 0 ? n : 0); ++c) {
      const int k0 = c * BK;
      const int vst = c == n - 1 ? last : last ^ 1;
      if (n > 2 && c < n - 1) {
        __syncthreads();  // every thread is done with the stage
        cp_async_tile<D, MMA_NT>(Vs + vst * TILE, v + (bh * Skv + k0) * D, min(BK, Skv - k0),
                                 tid);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();  // the chunk has landed
      }
      const int len = min(BK, kv_end - k0);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (fr[u] < 0) continue;
        const __nv_bfloat16* prow = Ps + fr[u] * p_ld + k0;
        const __nv_bfloat16* vcol = Vs + vst * TILE + fc[u];
        float a = fa[u];
#pragma unroll 16
        for (int jj = 0; jj < len; ++jj)
          a = fmaf(__bfloat162float(prow[jj]), __bfloat162float(vcol[jj * LD]), a);
        fa[u] = a;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (fr[u] >= 0)
        o[(bh * Sq + q0 + fr[u]) * D + fc[u]] = __float2bfloat16_rn(fa[u] / l_s[fr[u]]);
    if (wanted <= FIX_MAX) break;
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
