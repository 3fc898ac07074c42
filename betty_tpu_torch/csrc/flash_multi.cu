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
//   B3: one 256-thread block per (b, h, 64-row q tile), walking 64-row k/v
//       chunks up to the diagonal when causal: B1's tile code
//       (flash_common.cuh::fwd_q_tile), which takes any sequence length.
//   B4: one block per (b, h, 64-row k/v chunk), walking the 64-row q tiles
//       from the first that reaches the diagonal when causal; K and V stay
//       in shared memory, s and p are recomputed from lse.
//   B5: one block per (b, h, 64-row q tile), walking the k/v chunks up to the
//       diagonal when causal; Q and dO stay in shared memory. At B8 H16
//       S1024 that is 2048 blocks on 132 SMs, where B2's one block per (b,
//       h) would give 128.
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
// bfloat16 B4 and B5 (mma_bwd_dkv_kernel, mma_bwd_dq_kernel) run on the
// tensor cores in FlashAttention-2's structure, with the mma.sync, ldmatrix
// and cp.async helpers of flash_mma.cuh:
//   * 128 threads (4 warps) a block, each warp owning 16 rows of the
//     resident tile: k/v rows in B4, q rows in B5. Tiles stay bf16 in shared
//     memory with rows padded by 16 bytes (ldmatrix without bank
//     conflicts).
//   * The walked tiles (B4: Q, dO, lse, di; B5: K, V and the mask) come
//     through a 2-stage cp.async ring: the next tile is copied while the
//     warps compute on this one, one barrier a tile.
//   * B4 computes s^T = K Q^T and dp^T = V dO^T, so that p^T and ds^T are
//     accumulators of the warp's own k/v rows (lse and di are read by
//     column); B5 computes s = Q K^T and dp = dO V^T (lse and di by row, in
//     registers). p is recomputed by exp, masked by selection, and p and ds
//     are rounded to bf16 and packed into the A operands of dV += p^T dO,
//     dK += ds^T Q (ldmatrix.trans on the same Q and dO tiles) or
//     dQ += ds K (ldmatrix.trans on K) in registers: they never touch
//     shared memory, where the float32 kernels stage them.
//   * Shared memory 55 KB at D64 (B4: K, V, two ring stages of Q and dO, and
//     lse, di; B5 the same tiles less lse, di) and 103 KB at D128, against
//     99.8 and 161.5 KB of float32 tiles in the float32 B4. Up to D64 the
//     resident tiles' A fragments stay in registers; at D128 they are
//     loaded with ldmatrix at each use, and B4 computes s^T in two passes of
//     32 q columns, so that dK and dV (128 registers) fit
//     __launch_bounds__(128).
// float32 B4 and B5 stay CUDA-core FMA loops over float32 tiles (256
// threads, flash_common.cuh): tensor cores in float32 would mean TF32, which
// would break the float32 solver passes' 1e-4 parity.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int MMA_NT = 128;  // threads of a bf16 backward block: 4 warps of 16 rows
constexpr float LOG2E = 1.4426950408889634f;

// B3: the forward of one q tile, as B1
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

// B4 in bf16 on the tensor cores: dk and dv of the 64-row k/v chunk
// blockIdx.x of head (blockIdx.z, blockIdx.y); warp w owns k/v rows
// 16w..16w+15 of the chunk
template <int D>
__global__ void __launch_bounds__(MMA_NT)
mma_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ di,
                   const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int H, int Sq, int Skv, int causal,
                   float scale) {
  constexpr int TILE = BQ * tile_ld<D>(), KD = D / 16;
  constexpr bool RESIDENT = D <= 64;  // K and V fragments held in registers
  constexpr int NC = D <= 64 ? 64 : 32;  // q columns of s^T a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + TILE;
  __nv_bfloat16* Qs = Vs + TILE;       // ring: [2][TILE]
  __nv_bfloat16* dOs = Qs + 2 * TILE;  // ring: [2][TILE]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * TILE);  // ring: [2][BQ]
  float* di_s = lse_s + 2 * BQ;                              // ring: [2][BQ]
  __shared__ int ms[BK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const int nk = min(BK, Skv - k0);
  // causal: q tiles wholly above the chunk's first column see none of it
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;

  // Q, dO, lse and di of the q tile from row q0 into ring stage st
  auto load_q_tile = [&](int st, int q0) {
    const int nq = min(BQ, Sq - q0);
    cp_async_tile<D, MMA_NT>(Qs + st * TILE, q + (bh * Sq + q0) * D, nq, tid);
    cp_async_tile<D, MMA_NT>(dOs + st * TILE, dout + (bh * Sq + q0) * D, nq, tid);
    const int r = tid & (BQ - 1);
    const float* src = (tid < BQ ? lse : di) + bh * Sq + q0;
    float* dst = (tid < BQ ? lse_s : di_s) + st * BQ;
    cp_async4(smem_u32(dst + r), src + (r < nq ? r : 0), r < nq);
  };

  cp_async_tile<D, MMA_NT>(Ks, k + (bh * Skv + k0) * D, nk, tid);
  cp_async_tile<D, MMA_NT>(Vs, v + (bh * Skv + k0) * D, nk, tid);
  if (q_begin < Sq) load_q_tile(0, q_begin);
  cp_async_commit();
  load_col_state(ms, mask ? mask + (size_t)b * Skv : nullptr, k0, nk, tid);
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

// B5 in bf16 on the tensor cores: dq of the 64-row q tile blockIdx.x of head
// (blockIdx.z, blockIdx.y); warp w owns q rows 16w..16w+15 of the tile
template <int D>
__global__ void __launch_bounds__(MMA_NT)
mma_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ dq, int H,
                  int Sq, int Skv, int causal, float scale) {
  constexpr int TILE = BQ * tile_ld<D>(), KD = D / 16;
  constexpr bool RESIDENT = D <= 64;  // Q and dO fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + TILE;
  __nv_bfloat16* Ks = dOs + TILE;     // ring: [2][TILE]
  __nv_bfloat16* Vs = Ks + 2 * TILE;  // ring: [2][TILE]
  __shared__ int ms[2][BK];           // ring: column states

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const uint8_t* mb = mask ? mask + (size_t)b * Skv : nullptr;
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
    di_r[i] = row < Sq ? di[bh * Sq + row] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

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

// shared memory of the bf16 backward kernels: two resident 64-row tiles and
// two ring stages of two more, plus (B4) the ring's lse and di
template <int D>
constexpr size_t mma_bwd_smem(bool row_stats) {
  return (size_t)6 * BQ * tile_ld<D>() * sizeof(__nv_bfloat16) +
         (row_stats ? (size_t)4 * BQ * sizeof(float) : 0);
}

// cp.async copies 16 bytes and the outputs are stored 4 at a time
inline bool mma_aligned(const void* const* in, int n_in, const void* const* out, int n_out) {
  for (int i = 0; i < n_in; ++i)
    if (reinterpret_cast<uintptr_t>(in[i]) % 16 != 0) return false;
  for (int i = 0; i < n_out; ++i)
    if (reinterpret_cast<uintptr_t>(out[i]) % 4 != 0) return false;
  return true;
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
  const size_t smem = mma_bwd_smem<D>(true);  // D = 64: 55 KB, over the 48 KB default
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
  const size_t smem = mma_bwd_smem<D>(false);
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
    DISPATCH_D(__nv_bfloat16, launch_fwd, q, k, v, m, o, l, B, H, Sq, Skv, causal, scale, s)
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
