// Flash-attention dk/dv on Hopper's tensor cores (sm_90a): wgmma fed by
// TMA. bf16 q, k, v, do at head_dim 64 and 128; f32 lse, delta, dk, dv. The
// kernel and its host launcher as templates over the tile:
// flash_dkv_wgmma.cu holds the entry point, the flash_dkv_wgmma_d*.cu files
// the compiled instances (TPX_FLASH_DKV_TILES).
//
// Replaces the Pallas TPU kernel torchx_tpu/ops/fused.py _flash_dkv_kernel
// (in _flash_bwd) for bf16; flash_dkv_mma.cuh takes f32 and head_dim 256
// with the same contract:
// dk and dv per KV head, summed over the n_rep query heads that share it.
//
// What bounds it on an H100: operations. Four products (K Q^T, V dO^T,
// P^T dO, dS^T Q) of 4 * 2 * b*h*s*(s+1)/2 * d = 138 GFLOP at the llama3_1b
// shapes over ~90 MB, far above the card's ridge, so all four run on wgmma:
//
//   * the tile is (BQ, BKV), the Pallas kernel's (block_q, block_kv) in
//     its dk/dv grid: a CTA owns BKV kv rows of one (batch, KV head),
//     BKV / 64 warpgroups of 64 rows, each thread with up to 255 registers
//     (140-199 at head_dim 64 for BQ 32 and 64, 203-206 at 128 for BQ 32,
//     no spills: ptxas -v); K and V are loaded once;
//   * it walks its n_rep query heads and their BQ-row q tiles in a fixed
//     order, so dk and dv are summed in registers without atomics and the
//     result is deterministic; one thread streams Q, dO (TMA, 128-byte
//     swizzle), lse and delta (bulk copies) through a two-stage ring,
//     refilling a stage as soon as every warpgroup has released it;
//   * per thread S^T and dP^T take BQ / 2 registers each and their
//     fragments BQ / 2 more beside dk and dv (head_dim / 2 each): at head_dim
//     128 the accumulators alone take 128 registers. BQ 128 spilled and
//     serialised the wgmmas at both head dims, and the masked BQ 64
//     instance spilled at 128, so they are not compiled;
//   * S^T = K Q^T and dP^T = V dO^T by wgmma from shared memory, Q and dO
//     read K-major;
//   * P^T = exp(S^T * scale - lse) and dS^T = P^T (dP^T - delta) in f32
//     registers;
//   * dV += P^T dO and dK += dS^T Q by wgmma with A from registers and Q,
//     dO read MN-major from the same swizzled tiles (the transpose bit).
//     P^T and dS^T are split into bf16 hi + lo and each product issued
//     twice: one bf16 rounding costs ~1.7e-3 relative against the f32
//     plain version, above the 1e-3 tolerance; the pair ~3e-6.
//
// Causal q tiles whose every query precedes a warpgroup's keys are skipped;
// the grid puts the low kv tiles, which see the most q tiles, first.
// Layouts: q, do [b, s, h, d]; k, v [b, s, kvh, d]; lse,
// delta f32 [b, h, s]; dk, dv f32 [b, s, kvh, d]; s a multiple of BQ and of
// BKV.
//
// Segment ids (the forward's, flash_fwd_wgmma.cuh): with seg [b, s] int32
// given (the kSeg instance), a thread keeps its two kv rows' ids in
// registers, each Q/dO stage also brings the q tile's ids by bulk copy,
// and P^T is zeroed where a query's id differs from its key's, on every
// tile, so that pairs across documents add exactly 0 to dk and dv.

#pragma once

#include <math.h>

#include "hopper.cuh"

// The compiled tiles (head_dim, block_q, block_kv), each with and without
// segment ids, by the file that instantiates them; ops/fused.py's
// WGMMA_TILES names the same.
#define TPX_FLASH_DKV_TILES_D64_KV64(X) X(64, 32, 64) X(64, 64, 64)
#define TPX_FLASH_DKV_TILES_D64_KV128(X) X(64, 32, 128) X(64, 64, 128)
#define TPX_FLASH_DKV_TILES_D128_KV64(X) X(128, 32, 64)
#define TPX_FLASH_DKV_TILES_D128_KV128(X) X(128, 32, 128)
#define TPX_FLASH_DKV_TILES(X)                                                   \
  TPX_FLASH_DKV_TILES_D64_KV64(X) TPX_FLASH_DKV_TILES_D64_KV128(X)               \
  TPX_FLASH_DKV_TILES_D128_KV64(X) TPX_FLASH_DKV_TILES_D128_KV128(X)

namespace tpx {

struct DkvArgs {
  const void *q, *k, *v, *dout, *lse, *delta, *seg;  // seg: int32 [B, S], or null
  void *dk, *dv;
  int B, S, H, KVH, causal;
  cudaStream_t stream;
};

template <int D, int BQ, int BKV, bool kSeg>
cudaError_t flash_dkv_tile(const DkvArgs& a);

#define TPX_FLASH_DKV_EXTERN(D, BQ, BKV)                                         \
  extern template cudaError_t flash_dkv_tile<D, BQ, BKV, false>(const DkvArgs&); \
  extern template cudaError_t flash_dkv_tile<D, BQ, BKV, true>(const DkvArgs&);
#define TPX_FLASH_DKV_INSTANCE(D, BQ, BKV)                                       \
  template cudaError_t flash_dkv_tile<D, BQ, BKV, false>(const DkvArgs&);        \
  template cudaError_t flash_dkv_tile<D, BQ, BKV, true>(const DkvArgs&);

namespace dkv {

using bf16 = __nv_bfloat16;

constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int BQ, int BKV>
struct Smem {
  bf16 k[BKV * D];  // [D/64][BKV][64], swizzled; every tile 1024-byte aligned
  bf16 v[BKV * D];
  bf16 q[kStages][BQ * D];  // [D/64][BQ][64]
  bf16 dout[kStages][BQ * D];
  float lse[kStages][BQ];
  float delta[kStages][BQ];
  int qseg[kStages][BQ];  // the q tile's segment ids (kSeg only)
  uint64_t kv_full, full[kStages], empty[kStages];
};

template <int D, int BQ, int BKV, bool kSeg>
__global__ void __launch_bounds__(2 * BKV, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                       const float* __restrict__ delta, const int* __restrict__ seg,
                       float* __restrict__ dk, float* __restrict__ dv, int S, int H, int KVH,
                       float scale, float scale_log2, int causal) {
  constexpr int kThreads = 2 * BKV;  // BKV / 64 warpgroups
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem<D, BQ, BKV>& sm = *reinterpret_cast<Smem<D, BQ, BKV>*>(align_1024(smem_raw));
  const int tid = threadIdx.x;
  const int b = blockIdx.x / KVH, hk = blockIdx.x % KVH;
  const int kt = blockIdx.y;  // low kv tiles see the most causal q tiles: they go first
  const int n_rep = H / KVH;
  // causal: from the q tile that holds the CTA's first key
  const int q_begin = causal ? kt * BKV / BQ : 0;
  const int nq = S / BQ - q_begin;  // q tiles per query head
  const int n_iter = n_rep * nq;

  // thread 0 issues every load; a stage is refilled once every warpgroup
  // has released it (empty), and the products wait for it to land (full).
  // Iteration it covers query head hk * n_rep + it / nq, q tile q_begin + it % nq.
  auto load_q = [&](int it) {
    const int st = it % kStages;
    const int h = hk * n_rep + it / nq, q0 = (q_begin + it % nq) * BQ;
    mbar_expect_tx(&sm.full[st], 2 * BQ * D * 2 + (kSeg ? 3 : 2) * BQ * 4);
    for (int c = 0; c < D / 64; ++c) {
      tma_load_3d(sm.q[st] + c * BQ * 64, &tq, &sm.full[st], c * 64, h, b * S + q0);
      tma_load_3d(sm.dout[st] + c * BQ * 64, &tdo, &sm.full[st], c * 64, h, b * S + q0);
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
    mbar_expect_tx(&sm.kv_full, 2 * BKV * D * 2);
    for (int c = 0; c < D / 64; ++c) {
      tma_load_3d(sm.k + c * BKV * 64, &tk, &sm.kv_full, c * 64, hk, b * S + kt * BKV);
      tma_load_3d(sm.v + c * BKV * 64, &tv, &sm.kv_full, c * 64, hk, b * S + kt * BKV);
    }
    for (int it = 0; it < kStages && it < n_iter; ++it) load_q(it);
  }
  __syncthreads();

  // warpgroup wg: kv rows kv0 + [0, 64)
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int kv0 = kt * BKV + wg * 64;
  const int row = kv0 + warp * 16 + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);
  const bf16* k_wg = sm.k + wg * 64 * 64;
  const bf16* v_wg = sm.v + wg * 64 * 64;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
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
    // skipped when every query of the tile precedes every key of the warpgroup
    if (!causal || q0 + BQ > kv0) {
      float s[BQ / 2], dp[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a_off = (kk / 4) * BKV * 64 + (kk % 4) * 16;
        const int b_off = (kk / 4) * BQ * 64 + (kk % 4) * 16;
        wgmma_ss(s, desc_sw128(k_wg + a_off, 16, 1024), desc_sw128(sm.q[st] + b_off, 16, 1024),
                 kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a_off = (kk / 4) * BKV * 64 + (kk % 4) * 16;
        const int b_off = (kk / 4) * BQ * 64 + (kk % 4) * 16;
        wgmma_ss(dp, desc_sw128(v_wg + a_off, 16, 1024),
                 desc_sw128(sm.dout[st] + b_off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // s[i], dp[i]: kv row (i & 2 ? row + 8 : row), query q0 + qc with
      // qc = 8 * (i / 4) + col + (i & 1); masked where the query precedes the key
      const bool diag = causal && q0 < kv0 + 64;
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int qc = 8 * (i / 4) + col + (i & 1);
        float p = exp2_approx(s[i] * scale_log2 - sm.lse[st][qc] * kLog2e);
        if (diag && q0 + qc < row + (i & 2 ? 8 : 0)) p = 0.f;
        if constexpr (kSeg)
          if (sm.qseg[st][qc] != (i & 2 ? ks1 : ks0)) p = 0.f;
        s[i] = p;
        dp[i] = p * (dp[i] - sm.delta[st][qc]);
      }

      uint32_t hi[BQ / 16][4], lo[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t dod = desc_sw128(sm.dout[st] + kk * 16 * 64, BQ * 128, 1024);
        wgmma_rs(dv_acc, hi[kk], dod);
        wgmma_rs(dv_acc, lo[kk], dod);
      }
      wgmma_commit();
      // at D = 128 the accumulators take 128 registers: let the P^T fragments
      // go before the dS^T ones are made
      if (D > 64) wgmma_wait<0>();

      uint32_t dhi[BQ / 16][4], dlo[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16x2(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1], dhi[kk][r], dlo[kk][r]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t qd = desc_sw128(sm.q[st] + kk * 16 * 64, BQ * 128, 1024);
        wgmma_rs(dk_acc, dhi[kk], qd);
        wgmma_rs(dk_acc, dlo[kk], qd);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    mbar_arrive(&sm.empty[st]);
    if (tid == 0 && it + kStages < n_iter) {
      mbar_wait(&sm.empty[st], (it / kStages) & 1);
      load_q(it + kStages);
    }
    __syncwarp();
  }

  float* k0 = dk + ((int64_t)(b * S + row) * KVH + hk) * D + col;
  float* v0 = dv + ((int64_t)(b * S + row) * KVH + hk) * D + col;
  const int64_t down = (int64_t)8 * KVH * D;  // row + 8
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(k0 + 8 * j) =
        make_float2(dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
    *reinterpret_cast<float2*>(k0 + down + 8 * j) =
        make_float2(dk_acc[4 * j + 2] * scale, dk_acc[4 * j + 3] * scale);
    *reinterpret_cast<float2*>(v0 + 8 * j) = make_float2(dv_acc[4 * j], dv_acc[4 * j + 1]);
    *reinterpret_cast<float2*>(v0 + down + 8 * j) =
        make_float2(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
  }
}

}  // namespace dkv

template <int D, int BQ, int BKV, bool kSeg>
cudaError_t flash_dkv_tile(const DkvArgs& a) {
  constexpr size_t smem = sizeof(dkv::Smem<D, BQ, BKV>) + 1024;
  static_assert(smem <= 232448, "the tile's shared memory exceeds a block's 227 KB");
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  const int64_t rows = (int64_t)a.B * a.S;
  if ((err = make_row_map(&tq, a.q, D, a.H, rows, BQ)) != cudaSuccess) return err;
  if ((err = make_row_map(&tk, a.k, D, a.KVH, rows, BKV)) != cudaSuccess) return err;
  if ((err = make_row_map(&tv, a.v, D, a.KVH, rows, BKV)) != cudaSuccess) return err;
  if ((err = make_row_map(&tdo, a.dout, D, a.H, rows, BQ)) != cudaSuccess) return err;
  const double scale = 1.0 / sqrt((double)D);
  return launch(dkv::flash_dkv_wgmma_kernel<D, BQ, BKV, kSeg>, dim3(a.B * a.KVH, a.S / BKV),
                2 * BKV, smem, a.stream, tq, tk, tv, tdo, (const float*)a.lse,
                (const float*)a.delta, (const int*)a.seg, (float*)a.dk, (float*)a.dv, a.S, a.H,
                a.KVH, (float)scale, (float)(scale * 1.4426950408889634), a.causal);
}

}  // namespace tpx
