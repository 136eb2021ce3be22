// Flash-attention dk/dv on Hopper's tensor cores by mma.sync (sm_90a), for
// what the wgmma kernels do not take: f32 q, k, v, do at head_dim 64, 128
// and 256, and bf16 at head_dim 256; f32 lse, delta, dk, dv. The kernel and
// its host launcher as templates over the element type and the tile:
// flash_dkv_mma.cu holds the entry point, the flash_dkv_mma_*.cu files the
// compiled instances (TPX_FLASH_DKV_MMA_TILES).
//
// Replaces the Pallas TPU kernel torchx_tpu/ops/fused.py _flash_dkv_kernel
// (in _flash_bwd) on those routes, with the contract of
// flash_dkv_wgmma.cuh: dk and dv per KV head, summed over the n_rep query
// heads that share it (native GQA: K and V are never repeated), in f32,
// without atomics, so the result is bitwise repeatable.
//
// What bounds it on an H100: operations. Four products (K Q^T, V dO^T,
// P^T dO, dS^T Q) of 138 GFLOP at Gemma-2-2B's attention shape (b 4, s
// 2048, 8 over 4 heads of 256, causal) over ~270 MB in f32, ~500 operations
// per byte. f32 products run as
// three TF32 products each (flash_fwd_mma.cuh says why), so the f32 bound
// is three times the operations over 495 TFLOP/s.
//
//   * a CTA owns BKV kv rows of one (batch, KV head): BKV / 16 warps along
//     the rows, times DSPLIT along the head dim. K and V are loaded once;
//     one thread streams Q, dO (TMA, 128-byte swizzle), lse and delta (bulk
//     copies) through a two-stage ring, walking the KV head's query heads
//     and their BQ-row q tiles in a fixed order, and refills a stage as
//     soon as every warp has released it;
//   * per warp S^T = K Q^T and dP^T = V dO^T (16 kv rows by BQ queries) by
//     mma.sync from shared memory (hopper.cuh warp_mma_abt);
//     P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T (dP^T -
//     delta) in f32 registers;
//   * dV += P^T dO and dK += dS^T Q with P^T and dS^T from those registers
//     and dO, Q read MN-major from the same tiles (warp_mma_pv: f32 three
//     TF32 passes; bf16 P^T and dS^T split into bf16 hi + lo, two products,
//     as the wgmma kernel splits them: one rounding misses 1e-3);
//   * dK and dV for a warp's 16 rows over all of head_dim are 16 x
//     head_dim / 32 registers each. The warps split the head dim (DSPLIT,
//     dsplit()) so that a warp keeps 64 columns of dK and of dV in f32 (64
//     registers for both; 128 columns spilled beside the split TF32
//     fragments, ptxas -v) and 128 in bf16: the DSPLIT warps of a row group
//     compute the same S^T and dP^T and each accumulates its columns of dK
//     and dV, so S^T and dP^T cost DSPLIT times, in one stream of the
//     tiles. Shared memory
//     bounds the rest: f32 K and V at head_dim 256 take 64 KB for 32 kv
//     rows, beside two stages of 32-row Q and dO tiles (128 KB).
//
// Causal q tiles whose every query precedes a warp's keys are skipped; the
// grid puts the low kv tiles, which see the most q tiles, first.
// Segment ids (flash_dkv_wgmma.cuh's): with seg [b, s] int32 given (the kSeg
// instance), a thread keeps its two kv rows' ids in registers, each Q/dO
// stage also brings the q tile's ids, and P^T is zeroed where a query's id
// differs from its key's, so pairs across documents add exactly 0.
// Layouts: q, do [b, s, h, d]; k, v [b, s, kvh, d]; lse,
// delta f32 [b, h, s]; dk, dv f32 [b, s, kvh, d]; s a multiple of BQ and of
// BKV.

#pragma once

#include <math.h>

#include "hopper.cuh"

// The compiled tiles (element type, head_dim, block_q, block_kv), each with
// and without segment ids, by the file that instantiates them; ops/fused.py's
// MMA_TILES names the same.
#define TPX_FLASH_DKV_MMA_TILES_F32_D64(X) X(float, 64, 32, 64)
#define TPX_FLASH_DKV_MMA_TILES_F32_D128(X) X(float, 128, 16, 64)
#define TPX_FLASH_DKV_MMA_TILES_F32_D256(X) X(float, 256, 32, 32)
#define TPX_FLASH_DKV_MMA_TILES_BF16_D256(X) X(__nv_bfloat16, 256, 32, 64)
#define TPX_FLASH_DKV_MMA_TILES(X)                                               \
  TPX_FLASH_DKV_MMA_TILES_F32_D64(X) TPX_FLASH_DKV_MMA_TILES_F32_D128(X)         \
  TPX_FLASH_DKV_MMA_TILES_F32_D256(X) TPX_FLASH_DKV_MMA_TILES_BF16_D256(X)

namespace tpx {

struct DkvMmaArgs {
  const void *q, *k, *v, *dout, *lse, *delta, *seg;  // seg: int32 [B, S], or null
  void *dk, *dv;
  int B, S, H, KVH, causal;
  cudaStream_t stream;
};

template <typename T, int D, int BQ, int BKV, bool kSeg>
cudaError_t flash_dkv_mma_tile(const DkvMmaArgs& a);

#define TPX_FLASH_DKV_MMA_EXTERN(T, D, BQ, BKV)                                          \
  extern template cudaError_t flash_dkv_mma_tile<T, D, BQ, BKV, false>(const DkvMmaArgs&); \
  extern template cudaError_t flash_dkv_mma_tile<T, D, BQ, BKV, true>(const DkvMmaArgs&);
#define TPX_FLASH_DKV_MMA_INSTANCE(T, D, BQ, BKV)                                        \
  template cudaError_t flash_dkv_mma_tile<T, D, BQ, BKV, false>(const DkvMmaArgs&);      \
  template cudaError_t flash_dkv_mma_tile<T, D, BQ, BKV, true>(const DkvMmaArgs&);

namespace dkv_mma {

constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// Warps along the head dim, so that a warp's dK and dV (16 x DACC x 2 / 32
// registers a thread) leave room for the products: 64 registers in f32,
// whose split fragments take more than bf16's (128 in f32 spilled, ptxas
// -v), 128 in bf16.
template <typename T, int D> __host__ __device__ constexpr int dsplit() {
  return sizeof(T) == 4 ? D / 64 : D / 128;
}

template <typename T, int D, int BQ, int BKV>
struct Smem {
  T k[BKV * D];  // [D / W][BKV][W] (W = 128 / sizeof(T)), swizzled; every tile 1024-byte aligned
  T v[BKV * D];
  T q[kStages][BQ * D];  // [D / W][BQ][W]
  T dout[kStages][BQ * D];
  float lse[kStages][BQ];
  float delta[kStages][BQ];
  int qseg[kStages][BQ];  // the q tile's segment ids (kSeg only)
  uint64_t kv_full, full[kStages], empty[kStages];
};

template <typename T, int D, int BQ, int BKV, int DSPLIT, bool kSeg>
__global__ void __launch_bounds__(32 * (BKV / 16) * DSPLIT, 1)
flash_dkv_mma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ seg,
                     float* __restrict__ dk, float* __restrict__ dv, int S, int H, int KVH,
                     float scale, float scale_log2, int causal) {
  constexpr int E = sizeof(T), W = 128 / E;  // a column block: 128 bytes
  constexpr int RG = BKV / 16;                     // warps along the kv rows
  constexpr int kThreads = 32 * RG * DSPLIT;
  constexpr int DACC = D / DSPLIT;                 // dK, dV columns a warp owns
  constexpr int NQ = BQ / 8, NA = DACC / 8;        // n8 blocks of S^T and of dK, dV
  static_assert(BQ % 16 == 0 && BKV % 16 == 0 && D % W == 0, "tile shapes");
  static_assert(sizeof(T) * BQ * D % 1024 == 0, "each tile 1024-byte aligned");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem<T, D, BQ, BKV>& sm = *reinterpret_cast<Smem<T, D, BQ, BKV>*>(align_1024(smem_raw));
  const int tid = threadIdx.x;
  const int b = blockIdx.x / KVH, hk = blockIdx.x % KVH;
  const int kt = blockIdx.y;  // low kv tiles see the most causal q tiles: they go first
  const int n_rep = H / KVH;
  // causal: from the q tile that holds the CTA's first key
  const int q_begin = causal ? kt * BKV / BQ : 0;
  const int nq = S / BQ - q_begin;  // q tiles per query head
  const int n_iter = n_rep * nq;

  // thread 0 issues every load; a stage is refilled once every warp has
  // released it (empty), and the products wait for it to land (full).
  // Iteration it covers query head hk * n_rep + it / nq, q tile q_begin + it % nq.
  auto load_q = [&](int it) {
    const int st = it % kStages;
    const int h = hk * n_rep + it / nq, q0 = (q_begin + it % nq) * BQ;
    mbar_expect_tx(&sm.full[st], 2 * BQ * D * E + (kSeg ? 3 : 2) * BQ * 4);
    for (int c = 0; c < D / W; ++c) {
      tma_load_3d(sm.q[st] + c * BQ * W, &tq, &sm.full[st], c * W, h, b * S + q0);
      tma_load_3d(sm.dout[st] + c * BQ * W, &tdo, &sm.full[st], c * W, h, b * S + q0);
    }
    const int64_t rows = (int64_t)(b * H + h) * S + q0;
    bulk_load(sm.lse[st], lse + rows, BQ * 4, &sm.full[st]);
    bulk_load(sm.delta[st], delta + rows, BQ * 4, &sm.full[st]);
    if constexpr (kSeg) bulk_load(sm.qseg[st], seg + (int64_t)b * S + q0, BQ * 4, &sm.full[st]);
  };
  if (tid == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kThreads);
    }
    mbar_fence_init();
    mbar_expect_tx(&sm.kv_full, 2 * BKV * D * E);
    for (int c = 0; c < D / W; ++c) {
      tma_load_3d(sm.k + c * BKV * W, &tk, &sm.kv_full, c * W, hk, b * S + kt * BKV);
      tma_load_3d(sm.v + c * BKV * W, &tv, &sm.kv_full, c * W, hk, b * S + kt * BKV);
    }
    for (int it = 0; it < kStages && it < n_iter; ++it) load_q(it);
  }
  __syncthreads();

  // warp w: kv rows kv0 + [0, 16) (row group w % RG), dK and dV columns
  // dc0 + [0, DACC); this thread kv rows `row` and row + 8, queries 2c,
  // 2c + 1 of every n8 block
  const int warp = tid / 32, lane = tid % 32, c = lane % 4;
  const int kl = (DSPLIT == 1 ? warp : warp % RG) * 16;
  const int dc0 = DSPLIT == 1 ? 0 : (warp / RG) * DACC;
  const int kv0 = kt * BKV + kl;
  const int row = kv0 + lane / 4;

  float dk_acc[NA][4], dv_acc[NA][4];
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;
  int ks0 = 0, ks1 = 0;  // the segment ids of kv rows row and row + 8
  if constexpr (kSeg) {
    ks0 = seg[(int64_t)b * S + row];
    ks1 = seg[(int64_t)b * S + row + 8];
  }
  mbar_wait(&sm.kv_full, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int st = it % kStages;
    const int q0 = (q_begin + it % nq) * BQ;
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    // skipped when every query of the tile precedes every key of the warp
    if (!causal || q0 + BQ > kv0) {
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
      warp_mma_abt<T, D, BKV, BQ, BQ>(s, sm.k, kl, sm.q[st], lane);
      warp_mma_abt<T, D, BKV, BQ, BQ>(dp, sm.v, kl, sm.dout[st], lane);

      // s[j][i], dp[j][i]: kv row (i & 2 ? row + 8 : row), query q0 + qc with
      // qc = 8j + 2c + (i & 1); masked where the query precedes the key
      const bool diag = causal && q0 < kv0 + 16;
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = 8 * j + 2 * c + (i & 1);
          float p = exp2_approx(
              __fmaf_rn(s[j][i], scale_log2, -__fmul_rn(sm.lse[st][qc], kLog2e)));
          if (diag && q0 + qc < row + (i & 2 ? 8 : 0)) p = 0.f;
          if constexpr (kSeg)
            if (sm.qseg[st][qc] != (i & 2 ? ks1 : ks0)) p = 0.f;
          s[j][i] = p;
          dp[j][i] = __fmul_rn(p, __fsub_rn(dp[j][i], sm.delta[st][qc]));
        }
      warp_mma_pv<T, BQ, DACC>(dv_acc, s, sm.dout[st], dc0, lane);
      warp_mma_pv<T, BQ, DACC>(dk_acc, dp, sm.q[st], dc0, lane);
    }
    mbar_arrive(&sm.empty[st]);
    if (tid == 0 && it + kStages < n_iter) {
      mbar_wait(&sm.empty[st], (it / kStages) & 1);
      load_q(it + kStages);
    }
    __syncwarp();
  }

  float* k0 = dk + ((int64_t)(b * S + row) * KVH + hk) * D + dc0 + 2 * c;
  float* v0 = dv + ((int64_t)(b * S + row) * KVH + hk) * D + dc0 + 2 * c;
  const int64_t down = (int64_t)8 * KVH * D;  // row + 8
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    *reinterpret_cast<float2*>(k0 + 8 * j) =
        make_float2(__fmul_rn(dk_acc[j][0], scale), __fmul_rn(dk_acc[j][1], scale));
    *reinterpret_cast<float2*>(k0 + down + 8 * j) =
        make_float2(__fmul_rn(dk_acc[j][2], scale), __fmul_rn(dk_acc[j][3], scale));
    *reinterpret_cast<float2*>(v0 + 8 * j) = make_float2(dv_acc[j][0], dv_acc[j][1]);
    *reinterpret_cast<float2*>(v0 + down + 8 * j) = make_float2(dv_acc[j][2], dv_acc[j][3]);
  }
}

}  // namespace dkv_mma

template <typename T, int D, int BQ, int BKV, bool kSeg>
cudaError_t flash_dkv_mma_tile(const DkvMmaArgs& a) {
  constexpr size_t smem = sizeof(dkv_mma::Smem<T, D, BQ, BKV>) + 1024;
  static_assert(smem <= 232448, "the tile's shared memory exceeds a block's 227 KB");
  constexpr int eb = sizeof(T);
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  const int64_t rows = (int64_t)a.B * a.S;
  if ((err = make_row_map(&tq, a.q, D, a.H, rows, BQ, eb)) != cudaSuccess) return err;
  if ((err = make_row_map(&tk, a.k, D, a.KVH, rows, BKV, eb)) != cudaSuccess) return err;
  if ((err = make_row_map(&tv, a.v, D, a.KVH, rows, BKV, eb)) != cudaSuccess) return err;
  if ((err = make_row_map(&tdo, a.dout, D, a.H, rows, BQ, eb)) != cudaSuccess) return err;
  const double scale = 1.0 / sqrt((double)D);
  constexpr int dsplit = dkv_mma::dsplit<T, D>();
  return launch(dkv_mma::flash_dkv_mma_kernel<T, D, BQ, BKV, dsplit, kSeg>,
                dim3(a.B * a.KVH, a.S / BKV), 32 * (BKV / 16) * dsplit, smem, a.stream, tq,
                tk, tv, tdo, (const float*)a.lse, (const float*)a.delta, (const int*)a.seg,
                (float*)a.dk, (float*)a.dv, a.S, a.H, a.KVH, (float)scale,
                (float)(scale * 1.4426950408889634), a.causal);
}

}  // namespace tpx
