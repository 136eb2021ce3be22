// Flash-attention dq on Hopper's tensor cores (sm_90a): wgmma fed by TMA.
// bf16 q, k, v, do at head_dim 64 and 128; f32 lse, delta and dq. The
// kernel and its host launcher as templates over the tile:
// flash_dq_wgmma.cu holds the entry point, the flash_dq_wgmma_d*.cu files
// the compiled instances (TPX_FLASH_DQ_TILES).
//
// Replaces the Pallas TPU kernel torchx_tpu/ops/fused.py _flash_dq_kernel
// (in _flash_bwd) for bf16; flash_dq_mma.cuh takes f32 and head_dim 256
// with the same contract:
//   P = exp(Q K^T * scale - lse),  dS = P (dO V^T - delta),  dQ = dS K * scale.
//
// What bounds it on an H100: operations. Three products (Q K^T, dO V^T,
// dS K) of 3 * 2 * b*h*s*(s+1)/2 * d = 103 GFLOP at the llama3_1b shapes
// over ~80 MB, far above the card's ridge, so all three run on wgmma. The
// design is flash_dkv_wgmma.cuh's turned round:
//
//   * the tile is (BQ, BK), the Pallas kernel's (block_q, block_kv): a CTA
//     owns BQ query rows of one (batch, head), BQ / 64 warpgroups of 64
//     rows. One thread TMA-loads Q and dO once (128-byte swizzle) and the
//     CTA's lse and delta rows once by bulk copy, then streams the BK-row K
//     and V tiles of KV head h / n_rep through a two-stage ring, refilling
//     a stage as soon as every warpgroup has released it. There is no
//     producer warpgroup: beside one, with setmaxnreg, ptxas serialised
//     the wgmmas and spilled (flash_fwd_wgmma.cuh, flash_dkv_wgmma.cuh);
//   * per thread the S and dP accumulators take BK / 2 registers each, dQ
//     head_dim / 2 and the dS hi and lo fragments BK / 4 each: 128-204
//     registers at head_dim 64 and 155-234 at 128 for BK 64 and 128, no
//     spills (ptxas -v in chip_smoke.py's build phase);
//   * S = Q K^T and dP = dO V^T by wgmma from shared memory, Q, dO, K and V
//     read K-major;
//   * P = exp2(S * scale * log2 e - lse * log2 e) and dS = P (dP - delta)
//     in f32 registers; the scale is applied to S in f32 (1/sqrt(128) is not
//     exact in bf16);
//   * dQ += dS K by wgmma with dS from registers and the same swizzled K
//     tile read MN-major (the transpose bit). dS is split into bf16 hi + lo
//     and the product issued twice: one bf16 rounding of dS costs ~1e-3
//     relative against the f32 plain version
//     (tests/test_torch_flash_variants.py), the pair ~1e-6. The scale
//     multiplies dQ once, in the f32 epilogue.
//
// Causal kv tiles after a warpgroup's rows are skipped, and only the tiles
// that cross its diagonal are masked; the grid puts the longest q tiles
// first, and the CTAs of one q tile, whose heads share KV heads, run
// together, so K and V come from L2. dq is owned by one CTA: no atomics,
// the result is bitwise repeatable. Layouts: q, do [b, s,
// h, d]; k, v [b, s, kvh, d]; lse, delta f32 [b, h, s]; dq f32 [b, s, h,
// d]; s a multiple of BQ and of BK.
//
// Segment ids (the forward's, flash_fwd_wgmma.cuh): with seg [b, s] int32
// given (the kSeg instance), each K/V stage also brings the tile's ids by
// bulk copy, and P is zeroed where a key's id differs from its query's, on
// every tile, so that dS of a pair across documents is exactly 0, as in
// the forward. lse is finite on every row (each row keeps its own key).

#pragma once

#include <math.h>

#include "hopper.cuh"

// The compiled tiles (head_dim, block_q, block_kv), each with and without
// segment ids, by the file that instantiates them; ops/fused.py's
// WGMMA_TILES names the same.
#define TPX_FLASH_DQ_TILES_D64_Q64(X) X(64, 64, 64) X(64, 64, 128)
#define TPX_FLASH_DQ_TILES_D64_Q128(X) X(64, 128, 64) X(64, 128, 128)
#define TPX_FLASH_DQ_TILES_D128_Q64(X) X(128, 64, 64) X(128, 64, 128)
#define TPX_FLASH_DQ_TILES_D128_Q128(X) X(128, 128, 64) X(128, 128, 128)
#define TPX_FLASH_DQ_TILES(X)                                                    \
  TPX_FLASH_DQ_TILES_D64_Q64(X) TPX_FLASH_DQ_TILES_D64_Q128(X)                   \
  TPX_FLASH_DQ_TILES_D128_Q64(X) TPX_FLASH_DQ_TILES_D128_Q128(X)

namespace tpx {

struct DqArgs {
  const void *q, *k, *v, *dout, *lse, *delta, *seg;  // seg: int32 [B, S], or null
  void* dq;
  int B, S, H, KVH, causal;
  cudaStream_t stream;
};

template <int D, int BQ, int BK, bool kSeg>
cudaError_t flash_dq_tile(const DqArgs& a);

#define TPX_FLASH_DQ_EXTERN(D, BQ, BK)                                           \
  extern template cudaError_t flash_dq_tile<D, BQ, BK, false>(const DqArgs&);    \
  extern template cudaError_t flash_dq_tile<D, BQ, BK, true>(const DqArgs&);
#define TPX_FLASH_DQ_INSTANCE(D, BQ, BK)                                         \
  template cudaError_t flash_dq_tile<D, BQ, BK, false>(const DqArgs&);           \
  template cudaError_t flash_dq_tile<D, BQ, BK, true>(const DqArgs&);

namespace dq {

using bf16 = __nv_bfloat16;

constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int BQ, int BK>
struct Smem {
  bf16 q[BQ * D];  // [D/64][BQ][64], swizzled; every tile 1024-byte aligned
  bf16 dout[BQ * D];
  bf16 k[kStages][BK * D];  // [D/64][BK][64]
  bf16 v[kStages][BK * D];
  int kseg[kStages][BK];  // the K/V tile's segment ids (kSeg only)
  float lse[BQ];
  float delta[BQ];
  uint64_t q_full, full[kStages], empty[kStages];
};

template <int D, int BQ, int BK, bool kSeg>
__global__ void __launch_bounds__(2 * BQ, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                      const float* __restrict__ delta, const int* __restrict__ seg,
                      float* __restrict__ dq, int S, int H, int KVH, float scale,
                      float scale_log2, int causal) {
  constexpr int kThreads = 2 * BQ;  // BQ / 64 warpgroups
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem<D, BQ, BK>& sm = *reinterpret_cast<Smem<D, BQ, BK>*>(align_1024(smem_raw));
  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest causal rows first
  // causal: the kv tiles up to the last row's diagonal (S is a multiple of BK)
  const int nk = causal ? (q0 + BQ + BK - 1) / BK : S / BK;

  // thread 0 issues every load; a stage is refilled once every warpgroup
  // has released it (empty), and the products wait for it to land (full)
  auto load_kv = [&](int kt) {
    const int st = kt % kStages;
    mbar_expect_tx(&sm.full[st], 2 * BK * D * 2 + (kSeg ? BK * 4 : 0));
    for (int c = 0; c < D / 64; ++c) {
      tma_load_3d(sm.k[st] + c * BK * 64, &tk, &sm.full[st], c * 64, hk, b * S + kt * BK);
      tma_load_3d(sm.v[st] + c * BK * 64, &tv, &sm.full[st], c * 64, hk, b * S + kt * BK);
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
    mbar_expect_tx(&sm.q_full, 2 * BQ * D * 2 + 2 * BQ * 4);
    for (int c = 0; c < D / 64; ++c) {
      tma_load_3d(sm.q + c * BQ * 64, &tq, &sm.q_full, c * 64, h, b * S + q0);
      tma_load_3d(sm.dout + c * BQ * 64, &tdo, &sm.q_full, c * 64, h, b * S + q0);
    }
    const int64_t rows = (int64_t)(b * H + h) * S + q0;
    bulk_load(sm.lse, lse + rows, BQ * 4, &sm.q_full);
    bulk_load(sm.delta, delta + rows, BQ * 4, &sm.q_full);
    for (int kt = 0; kt < kStages && kt < nk; ++kt) load_kv(kt);
  }
  __syncthreads();

  // warpgroup wg: query rows r0 + [0, 64)
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = q0 + wg * 64;
  const int local = wg * 64 + warp * 16 + lane / 4;  // this thread's rows: local, local + 8
  const int row = q0 + local;
  const int col = 2 * (lane % 4);
  const bf16* q_wg = sm.q + wg * 64 * 64;
  const bf16* do_wg = sm.dout + wg * 64 * 64;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  int qs0 = 0, qs1 = 0;  // the segment ids of rows row and row + 8
  if constexpr (kSeg) {
    qs0 = seg[(int64_t)b * S + row];
    qs1 = seg[(int64_t)b * S + row + 8];
  }
  mbar_wait(&sm.q_full, 0);
  const float lse0 = sm.lse[local] * kLog2e, lse1 = sm.lse[local + 8] * kLog2e;
  const float delta0 = sm.delta[local], delta1 = sm.delta[local + 8];

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kStages;
    const int k0 = kt * BK;
    mbar_wait(&sm.full[st], (kt / kStages) & 1);
    // skipped when every key of the tile follows every query of the warpgroup
    if (!causal || k0 <= r0 + 63) {
      float s[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a_off = (kk / 4) * BQ * 64 + (kk % 4) * 16;
        const int b_off = (kk / 4) * BK * 64 + (kk % 4) * 16;
        wgmma_ss(s, desc_sw128(q_wg + a_off, 16, 1024), desc_sw128(sm.k[st] + b_off, 16, 1024),
                 kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a_off = (kk / 4) * BQ * 64 + (kk % 4) * 16;
        const int b_off = (kk / 4) * BK * 64 + (kk % 4) * 16;
        wgmma_ss(dp, desc_sw128(do_wg + a_off, 16, 1024), desc_sw128(sm.v[st] + b_off, 16, 1024),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // s[i], dp[i]: query row (i & 2 ? row + 8 : row), key k0 + kc with
      // kc = 8 * (i / 4) + col + (i & 1); masked where the key follows the query
      const bool diag = causal && k0 + BK - 1 > r0;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const bool low = i & 2;
        float p = exp2_approx(s[i] * scale_log2 - (low ? lse1 : lse0));
        if (diag && k0 + 8 * (i / 4) + col + (i & 1) > row + (low ? 8 : 0)) p = 0.f;
        if constexpr (kSeg)
          if (sm.kseg[st][8 * (i / 4) + col + (i & 1)] != (low ? qs1 : qs0)) p = 0.f;
        dp[i] = p * (dp[i] - (low ? delta1 : delta0));
      }

      uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16x2(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t kd = desc_sw128(sm.k[st] + kk * 16 * 64, BK * 128, 1024);
        wgmma_rs(acc, hi[kk], kd);
        wgmma_rs(acc, lo[kk], kd);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    mbar_arrive(&sm.empty[st]);
    if (tid == 0 && kt + kStages < nk) {
      mbar_wait(&sm.empty[st], (kt / kStages) & 1);
      load_kv(kt + kStages);
    }
    __syncwarp();
  }

  float* d0 = dq + ((int64_t)(b * S + row) * H + h) * D + col;
  float* d1 = d0 + (int64_t)8 * H * D;  // row + 8
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(d0 + 8 * j) = make_float2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    *reinterpret_cast<float2*>(d1 + 8 * j) =
        make_float2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

}  // namespace dq

template <int D, int BQ, int BK, bool kSeg>
cudaError_t flash_dq_tile(const DqArgs& a) {
  constexpr size_t smem = sizeof(dq::Smem<D, BQ, BK>) + 1024;
  static_assert(smem <= 232448, "the tile's shared memory exceeds a block's 227 KB");
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  const int64_t rows = (int64_t)a.B * a.S;
  if ((err = make_row_map(&tq, a.q, D, a.H, rows, BQ)) != cudaSuccess) return err;
  if ((err = make_row_map(&tk, a.k, D, a.KVH, rows, BK)) != cudaSuccess) return err;
  if ((err = make_row_map(&tv, a.v, D, a.KVH, rows, BK)) != cudaSuccess) return err;
  if ((err = make_row_map(&tdo, a.dout, D, a.H, rows, BQ)) != cudaSuccess) return err;
  const double scale = 1.0 / sqrt((double)D);
  return launch(dq::flash_dq_wgmma_kernel<D, BQ, BK, kSeg>, dim3(a.B * a.H, a.S / BQ), 2 * BQ,
                smem, a.stream, tq, tk, tv, tdo, (const float*)a.lse, (const float*)a.delta,
                (const int*)a.seg, (float*)a.dq, a.S, a.H, a.KVH, (float)scale,
                (float)(scale * 1.4426950408889634), a.causal);
}

}  // namespace tpx
