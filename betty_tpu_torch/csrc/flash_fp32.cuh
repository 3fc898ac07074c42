// Float32 per-block bodies of the multi-tile attention on Hopper's CUDA
// cores (sm_90a), used by flash_multi.cu's float32 B3, B4 and B5
// (fp32_fwd_kernel, fp32_bwd_dkv_kernel, fp32_bwd_dq_kernel):
//   fp32_fwd_q_tile  o and lse of one 64-row q tile, walking k/v chunks;
//   fp32_dkv_chunk   dk and dv of one 64-row k/v chunk, walking q tiles;
//   fp32_dq_tile     dq of one 64-row q tile, walking k/v chunks.
// Exact float32: every product is a chain of fmaf in the order of the plain
// loop (d ascending for s and dp, the walked rows ascending for the
// outputs; B5's dq as two such chains at D64, added at the end), no TF32.
// The tensor cores would mean TF32, about three decimal digits, and the
// float32 solver passes are held to 1e-4.
//
// What bounds them: at B8 H16 S1024 D64 two (B3), four (B4) and three (B5)
// products of 2 S^2 D flops per head against a few (S, D) tensors, so the CUDA
// cores' FMA rate (67 TFLOP/s) if the operands come fast enough. An SM
// issues four warp-wide FFMA a cycle and its shared memory serves 32
// floats a cycle: a warp-wide LDS.128 takes 4 cycles however few distinct
// words its lanes read (on an H100, 4 x 4 tiles at 0.4375 floats per FFMA
// ran at the shared-memory rate). So a product loop keeps the FFMA pipes
// fed only at 0.25 floats loaded per FFMA or less: 8 x 8 register tiles,
// 16 FFMA per LDS.128, as a SIMT SGEMM holds them. The registers do not
// hold 8 x 8 of s, of dp and of two outputs at once, so each product gets
// half the block's warps:
//   * B4 (dk, dv of a 64-row k/v chunk, walking q tiles): threads [0, NH)
//     compute s (4 x 8 a thread: 0.375 floats per FFMA), write p to
//     shared memory, then dv += p^T dO (8 x 8: 0.25); threads [NH, NT)
//     compute dp, read p and write ds = p (dp - di) scale, then
//     dk += ds^T Q. P and dS are [q][k] tiles of stride 72, so a warp's
//     4 x 8 scalar stores hit 32 distinct banks.
//   * B5 (dq of a 64-row q tile, walking 64-row k/v chunks): threads
//     [0, NH) compute s and p, threads [NH, NT) dp (8 x 8 each); each
//     role passes half its columns through shared memory (the V stage just
//     read at D64: [k][q], stride 68) and writes ds^T of the other half
//     there; then every thread takes
//     dq += ds K over half the chunk's rows at D64 (8 x 8), the two halves'
//     sums added once at the end.
//   * Operands are read with float4 loads along each product's reduction
//     axis (d for s and dp; the walked rows for the outputs); tiles of D
//     floats a row are padded to D + 4 (fp32_ld): 16-byte rows for
//     cp.async and float4, consecutive rows in consecutive 16-byte bank
//     groups, so a quarter warp's 8 rows are free of conflicts.
//   * A 2-stage cp.async ring (16-byte copies, zero-filled past the
//     sequence) for the walked tiles: B4's Q, dO, lse, di (32-row tiles);
//     B5's K, V and column states. The next tile is copied while this one
//     is computed. Shared memory at D64: 86.5 KB (B4) and 102 KB (B5), two
//     blocks an SM. At D128 B4 runs 256 threads on 64-row q tiles through a
//     1-stage ring (168.5 KB), so that dk and dv stay 8 x 8 a thread.
//   * B3 (o, lse of a 64-row q tile, walking 64-row k/v chunks): threads
//     [0, NS) compute s (8 x 8 a thread, 4 x 8 at D128) of chunk i, the
//     others rescale O and add p V of chunk i - 1 (8 x 8), so that the two
//     products overlap; p^T and the rows' alpha pass through shared memory
//     ([k][q], stride 68: a warp's scalar stores hit 32 banks). Shared
//     memory at D64: 102.5 KB (Q, two stages each of K and V, p^T), two
//     blocks an SM.
//   * p = 2^(s scale log2 e - lse log2 e) on the SFU (exp2_sfu), with a
//     masked entry's exponent selected to -inf: no branch around the exp
//     (B3: 2^(s scale log2 e - m log2 e), m the running max).
// Semantics of betty_tpu's _bwd_dkv_kernel / _bwd_dq_kernel, as the CUDA-core
// loops they replace: p = exp(s scale - lse) selected to 0 where masked
// (never multiplied: a fully masked row has lse = 0), ds = p (dp - di)
// scale, column states 0/1/2 (load_col_state), whole tiles above the
// diagonal skipped when causal, a ragged last tile zero-filled with its
// rows and columns masked, each output summed in registers and written once.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

// row stride of a float32 tile of D columns in shared memory
template <int D>
__host__ __device__ constexpr int fp32_ld() {
  return D + 4;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// N consecutive floats (N = 1, 2 or 4) of shared memory, in one load
template <int N>
__device__ __forceinline__ void lds_vec(float (&out)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = lds4(p);
    out[0] = t.x;
    out[1] = t.y;
    out[2] = t.z;
    out[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x;
    out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

// rows [0, ROWS) x D of a row-major (rows, D) float32 source into a tile of
// stride fp32_ld<D>(); rows at or past `valid` are zero. NTHREADS threads,
// 16 bytes a copy, neighbouring threads on neighbouring addresses.
template <int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void cp_async_tile_f32(float* dst, const float* __restrict__ src,
                                                  int valid, int tid) {
  constexpr int CPR = D / 4;  // 16-byte chunks per row
  static_assert(ROWS * CPR % NTHREADS == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / NTHREADS; ++it) {
    const int idx = tid + it * NTHREADS, r = idx / CPR, c = (idx - r * CPR) * 4;
    const bool ok = r < valid;
    cp_async16(smem_u32(dst + r * fp32_ld<D>() + c), src + (ok ? (size_t)r * D + c : 0), ok);
  }
}

// wait at named barrier `id` (1..15) until `count` threads (a multiple of
// 32, whole warps) have arrived
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// acc[i][j] = sum_d A[ra + SA i][d] Bm[rb + 8j][d], d ascending (one fmaf a
// step, as the plain loop), over tiles of stride fp32_ld<D>(): TN + TM
// LDS.128 for 4 TM TN FFMA a step of four d
template <int D, int TM, int TN, int SA>
__device__ __forceinline__ void fp32_product(const float* A, const float* Bm, int ra, int rb,
                                             float (&acc)[TM][TN]) {
  constexpr int LD = fp32_ld<D>();
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 b[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = lds4(Bm + (rb + 8 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 a = lds4(A + (ra + SA * i) * LD + d);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
      }
    }
  }
}

// The output columns of thread group cg (of NCG groups) over D columns:
// TD = D / NCG of them, in runs of VEC = min(4, TD), run m at
// VEC (cg + NCG m), so that a quarter warp's loads of one run are
// consecutive.
template <int D, int NCG>
struct OutCols {
  static constexpr int TD = D / NCG;
  static constexpr int VEC = TD < 4 ? TD : 4;
  __device__ __forceinline__ static int col(int cg, int c) {
    return VEC * (cg + NCG * (c / VEC)) + c % VEC;
  }
};

// row a (< 8) of an output tile held by row group rg: two runs of four,
// 4 rg and 32 + 4 rg, so that X's reads of them are two float4
__device__ __forceinline__ int out_row(int rg, int a) { return 4 * rg + (a & 3) + 32 * (a >> 2); }

// acc[a][c] += sum_{x < N} X[(x0 + x) LX + out_row(rg, a)] Y[(x0 + x) LY +
// col(cg, c)], x ascending: two LDS.128 of X and TD / VEC loads of Y for
// 8 TD FFMA a step (16 FFMA per LDS.128 at TD = 8)
template <int D, int NCG, int N, int LX, int LY>
__device__ __forceinline__ void fp32_outer(const float* X, const float* Y, int x0, int rg, int cg,
                                           float (&acc)[8][OutCols<D, NCG>::TD]) {
  using C = OutCols<D, NCG>;
#pragma unroll 4
  for (int x = x0; x < x0 + N; ++x) {
    const float4 lo = lds4(X + x * LX + 4 * rg), hi = lds4(X + x * LX + 32 + 4 * rg);
    const float xr[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float yb[C::TD / C::VEC][C::VEC];
#pragma unroll
    for (int m = 0; m < C::TD / C::VEC; ++m)
      lds_vec<C::VEC>(yb[m], Y + x * LY + C::col(cg, m * C::VEC));
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < C::TD; ++c)
        acc[a][c] = fmaf(xr[a], yb[c / C::VEC][c % C::VEC], acc[a][c]);
  }
}

// the thread's rows (those below `rows`) of a row-major (rows, D) float32
// output (global or shared, row stride LDO) from its accumulators; with
// ADD, plus the same elements of a tile of stride fp32_ld<D>() at add_from
template <int D, int NCG, int LDO, bool ADD>
__device__ __forceinline__ void store_rows_f32(float* out, const float* add_from,
                                               const float (&acc)[8][OutCols<D, NCG>::TD],
                                               int rg, int cg, int rows) {
  using C = OutCols<D, NCG>;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int row = out_row(rg, a);
    if (row >= rows) continue;
#pragma unroll
    for (int m = 0; m < C::TD / C::VEC; ++m) {
      const int c = m * C::VEC, col = C::col(cg, c);
      float v[C::VEC];
#pragma unroll
      for (int e = 0; e < C::VEC; ++e) v[e] = acc[a][c + e];
      if constexpr (ADD) {
        float w[C::VEC];
        lds_vec<C::VEC>(w, add_from + row * fp32_ld<D>() + col);
#pragma unroll
        for (int e = 0; e < C::VEC; ++e) v[e] = w[e] + v[e];
      }
      float* dst = out + (size_t)row * LDO + col;
      if constexpr (C::VEC == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else if constexpr (C::VEC == 2) {
        *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
      } else {
        *dst = v[0];
      }
    }
  }
}

// cp.async and the float4 loads and stores need 16-byte aligned tensors
inline bool fp32_aligned(const void* const* p, int n) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(p[i]) % 16 != 0) return false;
  return true;
}

// B4's geometry: q tiles of QT rows, NT threads (NH for s and dv, NH for
// dp and dk), STAGES ring stages
template <int D>
struct Fp32Dkv {
  static constexpr int QT = D <= 64 ? 32 : 64;
  static constexpr int NT = D <= 64 ? 128 : 256;
  static constexpr int STAGES = D <= 64 ? 2 : 1;
  static constexpr int NH = NT / 2;
  static constexpr int SA = QT / 4;    // q-row step of a thread's 4 x 8 score tile
  static constexpr int NCG = NH / 8;   // column groups of dk and dv
  static constexpr int LS = BK + 8;    // stride of the P and dS tiles, [q][k]
  // K, V; the ring's Q, dO, lse, di; P and dS
  static constexpr size_t smem() {
    return (size_t)(2 * BK * fp32_ld<D>() + STAGES * (2 * QT * fp32_ld<D>() + 2 * QT) +
                    2 * QT * LS) * sizeof(float);
  }
};

// B5's geometry: k/v chunks of KT rows, NT threads (NH for s, NH for dp),
// a 2-stage ring; dq += ds K split over KS parts of a chunk's rows (two at
// D64, so that each thread holds 8 x 8 of dq), summed at the end
template <int D>
struct Fp32Dq {
  static constexpr int KT = 64;
  static constexpr int NT = 128;
  static constexpr int NH = NT / 2;
  static constexpr int KS = D == 64 ? 2 : 1;
  static constexpr int NCG = NT / KS / 8;  // column groups of dq
  static constexpr int LX = BQ + 4;        // stride of the dp^T / dS^T tile, [k][q]
  // dp^T and dS^T go in the V stage just read when a row of it is as long
  static constexpr bool X_IN_V = KT * fp32_ld<D>() >= KT * LX;
  // Q, dO; the ring's K, V; dS^T unless in V
  static constexpr size_t smem() {
    return (size_t)(2 * BQ * fp32_ld<D>() + 2 * 2 * KT * fp32_ld<D>() + (X_IN_V ? 0 : KT * LX)) *
           sizeof(float);
  }
};

// B4's body: dk and dv of the 64-row k/v chunk from row k0 of head bh,
// walking the q tiles (from the first that reaches the diagonal when
// causal). K, V and the chunk's column states stay in shared memory; Q, dO,
// lse and di come through the ring. Threads [0, NH) compute s (4 x 8 a
// thread), p into shared memory, then dv += p^T dO (8 x 8); threads
// [NH, NT) compute dp, then ds from p into shared memory, then
// dk += ds^T Q. mb: the batch element's kv mask (Skv bytes) or null. Runs
// in a block of Fp32Dkv<D>::NT threads with Fp32Dkv<D>::smem() bytes of
// dynamic shared memory at `smem`.
template <int D>
__device__ __forceinline__ void fp32_dkv_chunk(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    const uint8_t* __restrict__ mb, float* __restrict__ dk, float* __restrict__ dv, int Sq,
    int Skv, int causal, float scale, int k0, size_t bh, float* smem) {
  using G = Fp32Dkv<D>;
  constexpr int QT = G::QT, NT = G::NT, NH = G::NH, LD = fp32_ld<D>(), LS = G::LS;
  constexpr int TILE = QT * LD, TD = OutCols<D, G::NCG>::TD;
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;               // ring: [STAGES][TILE]
  float* dOs = Qs + G::STAGES * TILE;     // ring: [STAGES][TILE]
  float* lse_s = dOs + G::STAGES * TILE;  // ring: [STAGES][QT]
  float* di_s = lse_s + G::STAGES * QT;   // ring: [STAGES][QT]
  float* Ps = di_s + G::STAGES * QT;      // [QT][LS]
  float* dSs = Ps + QT * LS;              // [QT][LS]
  __shared__ int ms[BK];

  const int tid = threadIdx.x;
  const int nk = min(BK, Skv - k0);
  // causal: q tiles wholly above the chunk's first column see none of it
  const int q_begin = causal ? (k0 / QT) * QT : 0;

  // Q, dO, lse and di of the q tile from row q0 into ring stage st
  auto load_q_tile = [&](int st, int q0) {
    const int nq = min(QT, Sq - q0);
    cp_async_tile_f32<D, QT, NT>(Qs + st * TILE, q + (bh * Sq + q0) * D, nq, tid);
    cp_async_tile_f32<D, QT, NT>(dOs + st * TILE, dout + (bh * Sq + q0) * D, nq, tid);
    if (tid < 2 * QT) {
      const int r = tid % QT;
      const float* src = (tid < QT ? lse : di) + bh * Sq + q0;
      float* dst = (tid < QT ? lse_s : di_s) + st * QT;
      cp_async4(smem_u32(dst + r), src + (r < nq ? r : 0), r < nq);
    }
  };

  cp_async_tile_f32<D, BK, NT>(Ks, k + (bh * Skv + k0) * D, nk, tid);
  cp_async_tile_f32<D, BK, NT>(Vs, v + (bh * Skv + k0) * D, nk, tid);
  if (q_begin < Sq) load_q_tile(0, q_begin);
  cp_async_commit();
  load_col_state(ms, mb, k0, nk, tid);
  cp_async_wait_all();
  __syncthreads();

  // the thread's role and, in it, its 4 x 8 score tile (q rows tq + SA i,
  // k/v columns tk + 8j: a quarter warp reads one q row and 8 consecutive
  // k/v rows) and its 8 x TD output tile (k/v rows out_row(rg, .), columns
  // of cg: a quarter warp reads the same rows and consecutive columns)
  const bool s_role = tid < NH;
  const int t = s_role ? tid : tid - NH;
  const int tq = t >> 3, tk = t & 7, rg = t / G::NCG, cg = t % G::NCG;
  bool col_ok[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) col_ok[j] = ms[tk + 8 * j] == 2;
  float acc[8][TD];  // dv (s role) or dk (dp role)
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[a][c] = 0.f;

  const float scale_log2 = scale * LOG2E;
  int st = 0;
  for (int q0 = q_begin; q0 < Sq; q0 += QT) {
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; every thread is done with the last one
    if constexpr (G::STAGES == 2) {
      if (q0 + QT < Sq) load_q_tile(st ^ 1, q0 + QT);
      cp_async_commit();
    }
    const float* Qt = Qs + st * TILE;
    const float* dOt = dOs + st * TILE;
    const int nq = min(QT, Sq - q0);

    // s = Q K^T (s role) or dp = dO V^T (dp role)
    float sc[4][8];
    fp32_product<D, 4, 8, G::SA>(s_role ? Qt : dOt, s_role ? Ks : Vs, tq, tk, sc);
    if (s_role) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tq + G::SA * i;
        const float lse2 = lse_s[st * QT + r] * LOG2E;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tk + 8 * j;
          // p = exp(s scale - lse) = 2^(s scale log2 e - lse log2 e), masked
          // by selection, never by a product (a fully masked row has
          // lse = 0 and its exp may overflow): a masked entry's exponent is
          // -inf, whose 2^ is exactly 0 (no branch around the exp)
          const bool allowed = (r < nq) & col_ok[j] & (!causal | (k0 + c <= q0 + r));
          Ps[r * LS + c] = exp2_sfu(allowed ? fmaf(sc[i][j], scale_log2, -lse2) : -INFINITY);
        }
      }
    }
    __syncthreads();  // P is written
    if (!s_role) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tq + G::SA * i;
        const float di_r = di_s[st * QT + r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tk + 8 * j;
          dSs[r * LS + c] = Ps[r * LS + c] * (sc[i][j] - di_r) * scale;
        }
      }
      bar_sync(1, NH);  // dS is written (the dp role's threads only)
    }
    // dv += p^T dO (s role) or dk += ds^T Q (dp role) over the tile's rows
    fp32_outer<D, G::NCG, QT, LS, LD>(s_role ? Ps : dSs, s_role ? dOt : Qt, 0, rg, cg, acc);
    if constexpr (G::STAGES == 1) {
      if (q0 + QT < Sq) {
        __syncthreads();  // every thread is done with the stage
        load_q_tile(0, q0 + QT);
        cp_async_commit();
      }
    } else {
      st ^= 1;
    }
  }

  store_rows_f32<D, G::NCG, D, false>((s_role ? dv : dk) + (bh * Skv + k0) * D, nullptr, acc, rg,
                                      cg, nk);
}

// B5's body: dq of the 64-row q tile from row q0 of head bh, walking the k/v
// chunks (up to the diagonal when causal). Q and dO stay in shared memory;
// K, V and the column states come through the ring. Threads [0, NH)
// compute s and p (8 x 8 a thread), threads [NH, NT) dp; each role passes
// half its columns to the other through shared memory and turns the other
// half into ds^T there; then every thread takes dq += ds K over its part
// of the chunk's rows. Runs in a block of Fp32Dq<D>::NT threads with
// Fp32Dq<D>::smem() bytes of dynamic shared memory at `smem`.
template <int D>
__device__ __forceinline__ void fp32_dq_tile(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    const uint8_t* __restrict__ mb, float* __restrict__ dq, int Sq, int Skv, int causal,
    float scale, int q0, size_t bh, float* smem) {
  using G = Fp32Dq<D>;
  constexpr int KT = G::KT, NT = G::NT, NH = G::NH, LD = fp32_ld<D>(), LX = G::LX;
  constexpr int TILE = KT * LD, TD = OutCols<D, G::NCG>::TD, KP = KT / G::KS;
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;   // ring: [2][TILE]
  float* Vs = Ks + 2 * TILE;   // ring: [2][TILE]
  float* Xs = Vs + 2 * TILE;   // [KT][LX], unless X_IN_V
  __shared__ int ms[2][KT];    // ring: column states

  const int tid = threadIdx.x;
  const int nq = min(BQ, Sq - q0);
  // causal: chunks wholly above the tile's last row contribute nothing
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;

  // K and V of the k/v chunk from row k0 into ring stage st
  auto load_kv_chunk = [&](int st, int k0) {
    const int nk = min(KT, Skv - k0);
    cp_async_tile_f32<D, KT, NT>(Ks + st * TILE, k + (bh * Skv + k0) * D, nk, tid);
    cp_async_tile_f32<D, KT, NT>(Vs + st * TILE, v + (bh * Skv + k0) * D, nk, tid);
  };

  cp_async_tile_f32<D, BQ, NT>(Qs, q + (bh * Sq + q0) * D, nq, tid);
  cp_async_tile_f32<D, BQ, NT>(dOs, dout + (bh * Sq + q0) * D, nq, tid);
  if (kv_end > 0) load_kv_chunk(0, 0);
  cp_async_commit();
  load_col_state<KT>(ms[0], mb, 0, min(KT, Skv), tid);

  // the thread's role, its 8 x 8 score tile (q rows tq + 8i, k/v columns
  // tk + 8j), its part h of a chunk's rows and its 8 x TD tile of dq (q
  // rows out_row(rg, .), columns of cg)
  const bool s_role = tid < NH;
  const int t = s_role ? tid : tid - NH;
  const int tq = t >> 3, tk = t & 7;
  const int h = tid / (NT / G::KS), u = tid % (NT / G::KS), rg = u / G::NCG, cg = u % G::NCG;
  float lse2[8], di_r[8];  // lse in units of log2 e (s role), and di, of the rows
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + tq + 8 * i;
    lse2[i] = s_role && row < Sq ? lse[bh * Sq + row] * LOG2E : 0.f;
    di_r[i] = row < Sq ? di[bh * Sq + row] : 0.f;
  }
  float acc[8][TD];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[a][c] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  const float scale_log2 = scale * LOG2E;
  int st = 0;
  for (int k0 = 0; k0 < kv_end; k0 += KT, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this chunk has landed; every thread is done with the last one
    const int k_next = k0 + KT;
    int next_state = 0;  // the next chunk's column state of k/v row tid
    if (k_next < kv_end) {
      load_kv_chunk(st ^ 1, k_next);
      if (tid < KT && k_next + tid < Skv)
        next_state = (mb == nullptr || mb[k_next + tid] != 0) ? 2 : 1;
    }
    cp_async_commit();
    const float* Kt = Ks + st * TILE;
    const float* Vt = Vs + st * TILE;
    float* X = G::X_IN_V ? Vs + st * TILE : Xs;

    // s = Q K^T (s role) or dp = dO V^T (dp role)
    float sc[8][8];
    fp32_product<D, 8, 8, 8>(s_role ? Qs : dOs, s_role ? Kt : Vt, tq, tk, sc);
    if (s_role) {
      bool col_ok[8];  // in registers first: no branch around a load per entry
#pragma unroll
      for (int j = 0; j < 8; ++j) col_ok[j] = ms[st][tk + 8 * j] == 2;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = tq + 8 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tk + 8 * j;
          // as B4: masked by an exponent of -inf, selected, never multiplied
          const bool allowed = (r < nq) & col_ok[j] & (!causal | (k0 + c <= q0 + r));
          sc[i][j] = exp2_sfu(allowed ? fmaf(sc[i][j], scale_log2, -lse2[i]) : -INFINITY);
        }
      }
    }
    // ds = p (dp - di) scale, half the columns by each role: the s role
    // passes p of columns j >= 4 and takes dp of j < 4, the dp role the
    // other way round; X holds ds^T when done
    __syncthreads();  // every thread is done reading V, where X may lie
    auto x_at = [&](int i, int j) { return X + (tk + 8 * j) * LX + tq + 8 * i; };
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (s_role) *x_at(i, j + 4) = sc[i][j + 4];
        else *x_at(i, j) = sc[i][j];
      }
    __syncthreads();  // the passed halves are written
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (s_role) {
          float* x = x_at(i, j);
          *x = sc[i][j] * (*x - di_r[i]) * scale;
        } else {
          float* x = x_at(i, j + 4);
          *x = *x * (sc[i][j + 4] - di_r[i]) * scale;
        }
      }
    __syncthreads();  // ds^T is written

    // dq += ds K over rows [h KP, (h + 1) KP) of the chunk
    fp32_outer<D, G::NCG, KP, LX, LD>(X, Kt, h * KP, rg, cg, acc);
    // read at the next chunk, after its barrier; nobody reads this stage now
    if (k_next < kv_end && tid < KT) ms[st ^ 1][tid] = next_state;
  }

  float* out = dq + (bh * Sq + q0) * D;
  if constexpr (G::KS == 1) {
    store_rows_f32<D, G::NCG, D, false>(out, nullptr, acc, rg, cg, nq);
  } else {
    // dq = part 0 + part 1, through the Q tile (no longer read)
    static_assert(G::KS == 2, "two parts");
    __syncthreads();
    if (h == 1) store_rows_f32<D, G::NCG, LD, false>(Qs, nullptr, acc, rg, cg, BQ);
    __syncthreads();
    if (h == 0) store_rows_f32<D, G::NCG, D, true>(out, Qs, acc, rg, cg, nq);
  }
}

// B3's geometry: NT threads, NS of them computing s and p (TM x 8 a thread:
// 8 x 8 up to D64, 4 x 8 at D128, whose 256 threads keep the output at
// 8 x 8 a thread), the other NT - NS owning the 64 x D output (8 x TD a
// thread); k/v chunks of BK rows through a 2-stage ring
template <int D>
struct Fp32Fwd {
  static constexpr int NT = D <= 64 ? 128 : 256;
  static constexpr int NS = NT / 2;
  static constexpr int TM = BQ * 8 / NS;  // q rows of a thread's score tile
  static constexpr int SA = BQ / TM;      // their step
  static constexpr int NCG = (NT - NS) / 8;  // column groups of the output
  static constexpr int LP = BQ + 4;          // stride of the p^T tile, [k][q]
  // Q; the ring's K, V; p^T; the rows' alpha (then l)
  static constexpr size_t smem() {
    return (size_t)(5 * BQ * fp32_ld<D>() + BK * LP + BQ) * sizeof(float);
  }
};

// B3's body: o and lse of the 64-row q tile from row q0 of head bh, walking
// the 64-row k/v chunks (up to the diagonal when causal) with an online
// softmax. Q stays in shared memory; K, V and the column states come
// through the ring. The two products have equal flops, and each gets half
// the threads, one chunk apart: in step i threads [0, NS) compute
// s = Q K^T of chunk i while threads [NS, NT) rescale their rows of O by
// chunk i-1's alpha and add p V of chunk i-1; after a barrier the s role
// takes each row's masked max over the 8 lanes that share the row, updates
// m and its partial l, and writes p^T and alpha to shared memory for the
// next step. mb: the batch element's kv mask (Skv bytes) or null. Runs in a
// block of Fp32Fwd<D>::NT threads with Fp32Fwd<D>::smem() bytes of dynamic
// shared memory at `smem`.
template <int D>
__device__ __forceinline__ void fp32_fwd_q_tile(const float* __restrict__ q,
                                                const float* __restrict__ k,
                                                const float* __restrict__ v,
                                                const uint8_t* __restrict__ mb,
                                                float* __restrict__ o, float* __restrict__ lse,
                                                int Sq, int Skv, int causal, float scale, int q0,
                                                size_t bh, float* smem) {
  using G = Fp32Fwd<D>;
  constexpr int NT = G::NT, NS = G::NS, TM = G::TM, SA = G::SA, LD = fp32_ld<D>(), LP = G::LP;
  constexpr int TILE = BK * LD, TD = OutCols<D, G::NCG>::TD;
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;    // ring: [2][TILE]
  float* Vs = Ks + 2 * TILE;   // ring: [2][TILE]
  float* Pt = Vs + 2 * TILE;   // [BK][LP]: p^T of the last chunk
  float* row_s = Pt + BK * LP;  // [BQ]: each row's alpha of the last chunk, at the end l
  __shared__ int ms[2][BK];     // ring: column states

  const int tid = threadIdx.x;
  const int nq = min(BQ, Sq - q0);
  // causal: chunks wholly above the tile's last row contribute nothing
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int n_chunks = (kv_end + BK - 1) / BK;

  auto load_rows = [&](float* dst, const float* src, int k0) {
    cp_async_tile_f32<D, BK, NT>(dst, src + (bh * Skv + k0) * D, min(BK, Skv - k0), tid);
  };

  cp_async_tile_f32<D, BQ, NT>(Qs, q + (bh * Sq + q0) * D, nq, tid);
  load_rows(Ks, k, 0);
  cp_async_commit();
  load_col_state(ms[0], mb, 0, min(BK, Skv), tid);

  // the thread's role; in the s role its TM x 8 score tile (q rows
  // tq + SA i, k/v columns tk + 8 j: the 8 lanes of a row are neighbours),
  // in the other its 8 x TD output tile (q rows out_row(rg, .), columns of
  // cg). Each role runs its own loop, so that the registers of one (s, m,
  // l) are not live in the other's (O); the loops meet at named barriers
  // 1 and 2 each step, 3 at the end.
  const bool s_role = tid < NS;
  const int t = s_role ? tid : tid - NS;

  // step it: K of chunk it and V of chunk it - 1 have landed; p^T and
  // alpha of chunk it - 1 are written; every thread is done with the stages
  // that are loaded now. Returns the next chunk's column state of k/v row
  // tid (threads [0, BK), all in the s role).
  auto begin_step = [&](int it) {
    cp_async_wait_all();
    bar_sync(1, NT);
    const int k_next = (it + 1) * BK;
    int next_state = 0;
    if (it + 1 < n_chunks) {
      load_rows(Ks + ((it + 1) & 1) * TILE, k, k_next);
      if (tid < BK && k_next + tid < Skv)
        next_state = (mb == nullptr || mb[k_next + tid] != 0) ? 2 : 1;
    }
    if (it < n_chunks) load_rows(Vs + (it & 1) * TILE, v, it * BK);
    cp_async_commit();
    return next_state;
  };

  if (s_role) {
    const int tq = t >> 3, tk = t & 7;
    float m[TM], l[TM];  // the rows' max and the thread's part of l
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
    const float scale_log2 = scale * LOG2E;
    for (int it = 0; it <= n_chunks; ++it) {
      const int next_state = begin_step(it), k0 = it * BK;
      float sc[TM][8];
      if (it < n_chunks) fp32_product<D, TM, 8, SA>(Qs, Ks + (it & 1) * TILE, tq, tk, sc);
      bar_sync(2, NT);  // the O role is done with p^T and alpha of chunk it - 1
      if (it == n_chunks) break;
      bool col_ok[8], in_seq[8];  // in registers first: no branch around a load per entry
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int state = ms[it & 1][tk + 8 * j];
        col_ok[j] = state == 2;
        in_seq[j] = state != 0;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = tq + SA * i;
        bool allowed[8];
        // the masked scaled scores' max: MASK_VALUE where masked, -inf past
        // the sequence, over the 8 lanes of the row
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          allowed[j] = col_ok[j] & (!causal | (k0 + tk + 8 * j <= q0 + r));
          mx = fmaxf(mx, allowed[j] ? sc[i][j] * scale : (in_seq[j] ? MASK_VALUE : -INFINITY));
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m[i], mx);  // finite: every chunk has a column of state >= 1
        const float alpha = exp2_sfu((m[i] - m_new) * LOG2E);
        const float m2 = m_new * LOG2E;
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // p = exp(s scale - m), masked by an exponent of -inf (no branch)
          const float p = exp2_sfu(allowed[j] ? fmaf(sc[i][j], scale_log2, -m2) : -INFINITY);
          Pt[(tk + 8 * j) * LP + r] = p;
          psum += p;
        }
        l[i] = alpha * l[i] + psum;
        m[i] = m_new;
        if (tk == 0) row_s[r] = alpha;
      }
      // read at the next step, after its first barrier; nobody reads this stage now
      if (it + 1 < n_chunks && tid < BK) ms[(it + 1) & 1][tid] = next_state;
    }
    // past the last step's barrier 2 the O role no longer reads row_s
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      li += __shfl_xor_sync(0xffffffffu, li, 4);
      const int r = tq + SA * i;
      if (tk == 0) {
        row_s[r] = li;
        if (r < nq) lse[bh * Sq + q0 + r] = li == 0.f ? 0.f : m[i] + logf(li);
      }
    }
    bar_sync(3, NT);  // the rows' l are written
  } else {
    const int rg = t / G::NCG, cg = t % G::NCG;
    float acc[8][TD];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[a][c] = 0.f;
    for (int it = 0; it <= n_chunks; ++it) {
      begin_step(it);
      if (it > 0) {
        // O = alpha O + p V of chunk it - 1
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const float alpha = row_s[out_row(rg, a)];
#pragma unroll
          for (int c = 0; c < TD; ++c) acc[a][c] *= alpha;
        }
        fp32_outer<D, G::NCG, BK, LP, LD>(Pt, Vs + ((it - 1) & 1) * TILE, 0, rg, cg, acc);
      }
      bar_sync(2, NT);
    }
    bar_sync(3, NT);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float li = row_s[out_row(rg, a)];
      const float l_safe = li == 0.f ? 1.f : li;
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[a][c] = acc[a][c] / l_safe;
    }
    store_rows_f32<D, G::NCG, D, false>(o + (bh * Sq + q0) * D, nullptr, acc, rg, cg, nq);
  }
}

}  // namespace
