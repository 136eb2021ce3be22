// Flash-attention dq on Hopper's tensor cores by mma.sync (sm_90a), for
// what the wgmma kernels do not take: f32 q, k, v, do at head_dim 64, 128
// and 256, and bf16 at head_dim 256; f32 lse, delta and dq. The kernel and
// its host launcher as templates over the element type and the tile:
// flash_dq_mma.cu holds the entry point, the flash_dq_mma_*.cu files the
// compiled instances (TPX_FLASH_DQ_MMA_TILES).
//
// Replaces the Pallas TPU kernel torchx_tpu/ops/fused.py _flash_dq_kernel
// (in _flash_bwd) on those routes, with the contract of flash_dq_wgmma.cuh:
// dq per query head from its KV head h / n_rep read in place (K and V are
// never repeated), in f32, without atomics, so the result is bitwise
// repeatable.
//
// What bounds it on an H100: operations. Three products (Q K^T, dO V^T,
// dS K) of 103 GFLOP at Gemma-2-2B's attention shape (b 4, s 2048, 8 query
// over 4 KV heads of 256, causal) over ~170 MB in f32, ~600 operations per
// byte. f32 products run as three TF32 products each (flash_fwd_mma.cuh
// says why), so the f32 bound is three times the operations over 495
// TFLOP/s.
//
//   * the forward's loop with dk/dv's arithmetic: a CTA owns BQ query rows
//     of one (batch, head), BQ / 16 warps of 16 rows, times DSPLIT along
//     the head dim (dsplit()). Q and dO are loaded once by TMA (128-byte
//     swizzle); lse and delta of a thread's two rows stay in registers; one
//     thread streams BK-row K and V tiles through a two-stage ring,
//     refilling a stage as soon as every warp has released it;
//   * per warp S = Q K^T and dP = dO V^T (16 rows by BK keys) by mma.sync
//     from shared memory (hopper.cuh warp_mma_abt); P = exp2(S scale log2 e
//     - lse log2 e), zeroed where masked, and dS = P (dP - delta) in f32
//     registers, as flash_dkv_mma.cuh forms P^T and dS^T;
//   * dQ += dS K with dS from those registers and K read MN-major from the
//     tile that S read K-major (warp_mma_pv: f32 three TF32 passes; bf16 dS
//     split into bf16 hi + lo, two products: one rounding misses 1e-3);
//   * dQ times the scale in the epilogue.
//
// Registers: dq has one accumulator, where dk/dv has two: 16 x DACC / 32
// registers a thread for the DACC = D / DSPLIT columns a warp owns, beside
// S and dP (16 x BK / 32 each). f32 keeps 128 columns a warp (DSPLIT 2 at
// head_dim 256, so S and dP cost twice there), bf16 all 256. Shared
// memory: f32 at 256 with 32-row q tiles takes 64 KB for Q and dO and 128
// KB for two stages of 32-row K and V. The tiles are the fastest of the
// candidates ptxas compiled without spills (chip_smoke.py --phases
// build,dqgrid, which builds this file with TPX_FLASH_DQ_MMA_GRID).
//
// Causal: a CTA streams only the kv tiles up to its last row's diagonal; a
// warp skips the tiles wholly after its rows and masks those that cross its
// diagonal. The CTAs with the longest rows are scheduled first.
// Segment ids (flash_dq_wgmma.cuh's): with seg [b, s] int32 given (the kSeg
// instance), each K/V stage also brings the tile's BK ids by bulk copy, a
// thread keeps its two rows' ids in registers, and P is zeroed where a
// key's id differs from its query's, so pairs across documents add exactly
// 0 and a row whose ids are all equal gets the unmasked instance's bits.
// Layouts: q, do [b, s, h, d]; k, v [b, s, kvh, d]; lse, delta f32
// [b, h, s]; dq f32 [b, s, h, d]; s a multiple of BQ and of BK.

#pragma once

#include <math.h>

#include "hopper.cuh"

// The compiled tiles (element type, head_dim, block_q, block_kv), each with
// and without segment ids, by the file that instantiates them; ops/fused.py's
// MMA_TILES names the same.
#define TPX_FLASH_DQ_MMA_TILES_F32_D64(X) X(float, 64, 128, 64)
#define TPX_FLASH_DQ_MMA_TILES_F32_D128(X) X(float, 128, 128, 32)
#define TPX_FLASH_DQ_MMA_TILES_F32_D256(X) X(float, 256, 32, 32)
#define TPX_FLASH_DQ_MMA_TILES_BF16_D256(X) X(__nv_bfloat16, 256, 64, 16)
#define TPX_FLASH_DQ_MMA_TILES(X)                                                \
  TPX_FLASH_DQ_MMA_TILES_F32_D64(X) TPX_FLASH_DQ_MMA_TILES_F32_D128(X)          \
  TPX_FLASH_DQ_MMA_TILES_F32_D256(X) TPX_FLASH_DQ_MMA_TILES_BF16_D256(X)

// The candidates the tiles were picked from (element type, head_dim,
// block_q, block_kv, warps along d), by group: the grid build
// (-DTPX_FLASH_DQ_MMA_GRID=<group>) compiles one group's, each with and
// without segment ids.
#define TPX_FLASH_DQ_MMA_GRID_1(X)                                               \
  X(float, 64, 64, 64, 1) X(float, 64, 64, 32, 1) X(float, 64, 128, 64, 1)       \
  X(float, 64, 128, 32, 1) X(float, 64, 128, 128, 1) X(float, 64, 64, 128, 1)
#define TPX_FLASH_DQ_MMA_GRID_2(X)                                               \
  X(float, 128, 64, 32, 1) X(float, 128, 64, 16, 1) X(float, 128, 128, 16, 1)    \
  X(float, 128, 128, 32, 1) X(float, 128, 64, 32, 2)
#define TPX_FLASH_DQ_MMA_GRID_3(X)                                               \
  X(float, 256, 32, 32, 2) X(float, 256, 64, 16, 2) X(float, 256, 32, 16, 2)     \
  X(float, 256, 32, 32, 4)
#define TPX_FLASH_DQ_MMA_GRID_4(X)                                               \
  X(__nv_bfloat16, 256, 64, 32, 1) X(__nv_bfloat16, 256, 64, 16, 1)              \
  X(__nv_bfloat16, 256, 128, 16, 1) X(__nv_bfloat16, 256, 128, 32, 1)            \
  X(__nv_bfloat16, 256, 64, 32, 2) X(__nv_bfloat16, 256, 128, 32, 2)

namespace tpx {

struct DqMmaArgs {
  const void *q, *k, *v, *dout, *lse, *delta, *seg;  // seg: int32 [B, S], or null
  void* dq;
  int B, S, H, KVH, causal;
  cudaStream_t stream;
};

template <typename T, int D, int BQ, int BK, bool kSeg>
cudaError_t flash_dq_mma_tile(const DqMmaArgs& a);

#define TPX_FLASH_DQ_MMA_EXTERN(T, D, BQ, BK)                                          \
  extern template cudaError_t flash_dq_mma_tile<T, D, BQ, BK, false>(const DqMmaArgs&); \
  extern template cudaError_t flash_dq_mma_tile<T, D, BQ, BK, true>(const DqMmaArgs&);
#define TPX_FLASH_DQ_MMA_INSTANCE(T, D, BQ, BK)                                        \
  template cudaError_t flash_dq_mma_tile<T, D, BQ, BK, false>(const DqMmaArgs&);      \
  template cudaError_t flash_dq_mma_tile<T, D, BQ, BK, true>(const DqMmaArgs&);

namespace dq_mma {

constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// Warps along the head dim: a warp keeps 128 columns of dQ in f32 (64
// registers a thread), all of them in bf16, whose fragments take fewer.
template <typename T, int D> __host__ __device__ constexpr int dsplit() {
  return sizeof(T) == 4 && D > 128 ? D / 128 : 1;
}

template <typename T, int D, int BQ, int BK>
struct Smem {
  T q[BQ * D];  // [D / W][BQ][W] (W = 128 / sizeof(T)), swizzled; every tile 1024-byte aligned
  T dout[BQ * D];
  T k[kStages][BK * D];  // [D / W][BK][W]
  T v[kStages][BK * D];
  int kseg[kStages][BK];  // the K/V tile's segment ids (kSeg only)
  uint64_t q_full, full[kStages], empty[kStages];
};

template <typename T, int D, int BQ, int BK, int DSPLIT, bool kSeg>
__global__ void __launch_bounds__(2 * BQ * DSPLIT, 1)
flash_dq_mma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ seg,
                    float* __restrict__ dq, int S, int H, int KVH, float scale,
                    float scale_log2, int causal) {
  constexpr int E = sizeof(T), W = 128 / E;  // a column block: 128 bytes
  constexpr int kThreads = 2 * BQ * DSPLIT;  // BQ / 16 warps along the rows, DSPLIT along d
  constexpr int RG = BQ / 16, DACC = D / DSPLIT;  // row groups; dQ columns a warp owns
  constexpr int NB = BK / 8, ND = DACC / 8;  // n8 blocks of S and of dQ
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && D % W == 0, "tile shapes");
  static_assert(sizeof(T) * BQ * D % 1024 == 0 && sizeof(T) * BK * D % 1024 == 0,
                "each tile 1024-byte aligned");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem<T, D, BQ, BK>& sm = *reinterpret_cast<Smem<T, D, BQ, BK>*>(align_1024(smem_raw));
  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest causal rows first
  // causal: the kv tiles up to the last row's diagonal (S is a multiple of BK)
  const int nk = causal ? (q0 + BQ + BK - 1) / BK : S / BK;

  // thread 0 issues every load; a stage is refilled once every warp has
  // released it (empty), and the products wait for it to land (full)
  auto load_kv = [&](int kt) {
    const int st = kt % kStages;
    mbar_expect_tx(&sm.full[st], 2 * BK * D * E + (kSeg ? BK * 4 : 0));
    for (int c = 0; c < D / W; ++c) {
      tma_load_3d(sm.k[st] + c * BK * W, &tk, &sm.full[st], c * W, hk, b * S + kt * BK);
      tma_load_3d(sm.v[st] + c * BK * W, &tv, &sm.full[st], c * W, hk, b * S + kt * BK);
    }
    if constexpr (kSeg)
      bulk_load(sm.kseg[st], seg + (int64_t)b * S + kt * BK, BK * 4, &sm.full[st]);
  };
  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kThreads);
    }
    mbar_fence_init();
    mbar_expect_tx(&sm.q_full, 2 * BQ * D * E);
    for (int c = 0; c < D / W; ++c) {
      tma_load_3d(sm.q + c * BQ * W, &tq, &sm.q_full, c * W, h, b * S + q0);
      tma_load_3d(sm.dout + c * BQ * W, &tdo, &sm.q_full, c * W, h, b * S + q0);
    }
    for (int kt = 0; kt < kStages && kt < nk; ++kt) load_kv(kt);
  }
  __syncthreads();

  // warp w: query rows r0 + [0, 16) (row group w % RG), dQ columns
  // dc0 + [0, DACC); this thread rows `row` and row + 8, columns 2c, 2c + 1
  // of every n8 block. The DSPLIT warps of a row group compute the same S
  // and dP.
  const int warp = tid / 32, lane = tid % 32, c = lane % 4;
  const int wr = (DSPLIT == 1 ? warp : warp % RG) * 16, r0 = q0 + wr;
  const int dc0 = DSPLIT == 1 ? 0 : (warp / RG) * DACC;
  const int row = r0 + lane / 4;

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  // lse in the base-2 domain and delta of rows row and row + 8
  const float* L = lse + (int64_t)(b * H + h) * S + row;
  const float* Dl = delta + (int64_t)(b * H + h) * S + row;
  const float ls0 = __fmul_rn(L[0], kLog2e), ls1 = __fmul_rn(L[8], kLog2e);
  const float dl0 = Dl[0], dl1 = Dl[8];
  int qs0 = 0, qs1 = 0;  // the segment ids of rows row and row + 8
  if constexpr (kSeg) {
    qs0 = seg[(int64_t)b * S + row];
    qs1 = seg[(int64_t)b * S + row + 8];
  }
  mbar_wait(&sm.q_full, 0);

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kStages;
    const int k0 = kt * BK;
    mbar_wait(&sm.full[st], (kt / kStages) & 1);
    // skipped when every key of the tile follows every query of the warp
    if (!causal || k0 <= r0 + 15) {
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
      warp_mma_abt<T, D, BQ, BK, BK>(s, sm.q, wr, sm.k[st], lane);
      warp_mma_abt<T, D, BQ, BK, BK>(dp, sm.dout, wr, sm.v[st], lane);

      // s[j][i], dp[j][i]: row (i & 2 ? row + 8 : row), key k0 + col with
      // col = 8j + 2c + (i & 1); masked where the key follows the query, on
      // the tiles that cross the warp's diagonal. dS overwrites S.
      const bool diag = causal && k0 + BK - 1 > r0;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 8 * j + 2 * c + (i & 1);
          float p = exp2_approx(__fmaf_rn(s[j][i], scale_log2, -(i & 2 ? ls1 : ls0)));
          if (diag && k0 + col > row + (i & 2 ? 8 : 0)) p = 0.f;
          if constexpr (kSeg)
            if (sm.kseg[st][col] != (i & 2 ? qs1 : qs0)) p = 0.f;
          s[j][i] = __fmul_rn(p, __fsub_rn(dp[j][i], i & 2 ? dl1 : dl0));
        }
      warp_mma_pv<T, BK, DACC>(acc, s, sm.k[st], dc0, lane);
    }
    mbar_arrive(&sm.empty[st]);
    if (tid == 0 && kt + kStages < nk) {
      mbar_wait(&sm.empty[st], (kt / kStages) & 1);
      load_kv(kt + kStages);
    }
    __syncwarp();
  }

  float* o0 = dq + ((int64_t)(b * S + row) * H + h) * D + dc0 + 2 * c;
  float* o1 = o0 + (int64_t)8 * H * D;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    *reinterpret_cast<float2*>(o0 + 8 * j) =
        make_float2(__fmul_rn(acc[j][0], scale), __fmul_rn(acc[j][1], scale));
    *reinterpret_cast<float2*>(o1 + 8 * j) =
        make_float2(__fmul_rn(acc[j][2], scale), __fmul_rn(acc[j][3], scale));
  }
}

}  // namespace dq_mma

// One launch at the tile (BQ, BK) and DSPLIT warps along the head dim.
template <typename T, int D, int BQ, int BK, int DSPLIT, bool kSeg>
cudaError_t flash_dq_mma_launch(const DqMmaArgs& a) {
  constexpr size_t smem = sizeof(dq_mma::Smem<T, D, BQ, BK>) + 1024;
  static_assert(smem <= 232448, "the tile's shared memory exceeds a block's 227 KB");
  constexpr int eb = sizeof(T);
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  const int64_t rows = (int64_t)a.B * a.S;
  if ((err = make_row_map(&tq, a.q, D, a.H, rows, BQ, eb)) != cudaSuccess) return err;
  if ((err = make_row_map(&tk, a.k, D, a.KVH, rows, BK, eb)) != cudaSuccess) return err;
  if ((err = make_row_map(&tv, a.v, D, a.KVH, rows, BK, eb)) != cudaSuccess) return err;
  if ((err = make_row_map(&tdo, a.dout, D, a.H, rows, BQ, eb)) != cudaSuccess) return err;
  const double scale = 1.0 / sqrt((double)D);
  return launch(dq_mma::flash_dq_mma_kernel<T, D, BQ, BK, DSPLIT, kSeg>,
                dim3(a.B * a.H, a.S / BQ), 2 * BQ * DSPLIT, smem, a.stream, tq, tk, tv, tdo,
                (const float*)a.lse, (const float*)a.delta, (const int*)a.seg, (float*)a.dq,
                a.S, a.H, a.KVH, (float)scale, (float)(scale * 1.4426950408889634), a.causal);
}

template <typename T, int D, int BQ, int BK, bool kSeg>
cudaError_t flash_dq_mma_tile(const DqMmaArgs& a) {
  return flash_dq_mma_launch<T, D, BQ, BK, dq_mma::dsplit<T, D>(), kSeg>(a);
}

}  // namespace tpx
