// Flash-attention forward on Hopper's tensor cores (sm_90a): wgmma fed by
// TMA. bf16 q, k, v at head_dim 64 and 128; f32 o and lse. The kernel and
// its host launcher as templates over the tile: flash_fwd_wgmma.cu holds the
// entry point, the flash_fwd_wgmma_d*.cu files the compiled instances
// (TPX_FLASH_FWD_TILES), spread so that their nvcc calls run side by side.
//
// Replaces the Pallas TPU kernel torchx_tpu/ops/fused.py _flash_fwd_kernel
// (launched by _flash_fwd) for bf16; flash_fwd_mma.cuh takes f32 and head_dim
// 256 with the same contract.
//
// What bounds it on an H100: operations. At the llama3_1b shapes (b=4,
// s=2048, 32 query over 8 KV heads, head_dim 64, causal) QK^T and PV are
// 69 GFLOP over ~70 MB of q/k/v/o, ~1000 operations per byte against the
// card's ridge of ~295. Only the tensor cores (989 TFLOP/s bf16 against
// 67 TFLOP/s of f32 FMAs) reach that neighbourhood, so both products run on
// wgmma and every other step is kept off their path:
//
//   * the tile is (BQ, BK), the Pallas kernel's (block_q, block_kv): a CTA
//     owns BQ query rows of one (batch, head), BQ / 64 warpgroups of 64
//     rows (one or two), and streams BK-row K/V tiles. A thread holds S
//     (BK / 2 registers), O (head_dim / 2), the softmax state and the P
//     fragments (BK / 2), up to 255 a thread: 123-201 registers at head_dim
//     64 and 167-229 at 128 for BK 64 and 128, no spills (ptxas -v). BK 192
//     spilled at head_dim 128 and in the masked 64-row instance at 64, so
//     it is not compiled. Beside a producer warpgroup and setmaxnreg,
//     ptxas serialised the wgmmas and spilled at 128;
//   * one thread loads Q once and streams the K/V tiles through a
//     two-stage ring by TMA (128-byte swizzle, the layout wgmma reads):
//     it refills a stage as soon as every warpgroup has released it,
//     full/empty mbarriers between the loads and the products;
//   * S = Q K^T by wgmma from shared memory; the scale is applied to S in
//     f32 (1/sqrt(128) is not exact in bf16), in the base-2 domain, and
//     the online softmax (row max and sum over the 4 lanes sharing a row)
//     runs in registers;
//   * O += P V by wgmma with P from registers. P is split into bf16
//     hi + lo and the product issued twice: one bf16 rounding of P costs
//     ~1e-3 relative against the f32 plain version, the pair ~1e-6, at
//     1.5x the tensor-core work of the plain bf16 design;
//   * O is divided by l in the epilogue; lse = (m + log2 l) ln 2.
//
// Causal: a CTA streams only the kv tiles up to its last row's diagonal; a
// warpgroup skips the tiles wholly after its rows and masks those that
// cross its diagonal. The CTAs with the longest rows are scheduled first.
// GQA reads KV head h / n_rep in place.
//
// Segment ids (packed documents; the SegmentIds(q=seg, kv=seg) that
// torchx_tpu/ops/attention.py splash_attention hands the library kernel):
// with seg [b, s] int32 given, a query sees only keys of its own segment.
// Each tile is instantiated twice (kSeg), so launches without ids keep
// their code. With ids, each K/V stage also brings the tile's BK ids by
// bulk copy, a thread keeps its two rows' ids in registers, and every tile
// is masked per element (a tile whose segments never meet is still
// computed: skipping it is later work). A row may then see a whole tile
// masked before any key of its own: its running max stays -inf, and the
// softmax takes 0 as its reference so that exp2 yields 0, not NaN.
// Layouts: q [b, s, h, d]; k, v [b, s, kvh, d]; o f32
// [b, s, h, d]; lse f32 [b, h, s]; s a multiple of BQ and of BK.

#pragma once

#include <math.h>

#include "hopper.cuh"

// The compiled tiles (head_dim, block_q, block_kv), each with and without
// segment ids, by the file that instantiates them; ops/fused.py's
// WGMMA_TILES names the same.
#define TPX_FLASH_FWD_TILES_D64_Q64(X) X(64, 64, 64) X(64, 64, 128)
#define TPX_FLASH_FWD_TILES_D64_Q128(X) X(64, 128, 64) X(64, 128, 128)
#define TPX_FLASH_FWD_TILES_D128_Q64(X) X(128, 64, 64) X(128, 64, 128)
#define TPX_FLASH_FWD_TILES_D128_Q128(X) X(128, 128, 64) X(128, 128, 128)
#define TPX_FLASH_FWD_TILES(X)                                                   \
  TPX_FLASH_FWD_TILES_D64_Q64(X) TPX_FLASH_FWD_TILES_D64_Q128(X)                 \
  TPX_FLASH_FWD_TILES_D128_Q64(X) TPX_FLASH_FWD_TILES_D128_Q128(X)

namespace tpx {

struct FwdArgs {
  const void *q, *k, *v, *seg;  // seg: int32 [B, S], or null
  void *o, *lse;
  int B, S, H, KVH, causal;
  cudaStream_t stream;
};

template <int D, int BQ, int BK, bool kSeg>
cudaError_t flash_fwd_tile(const FwdArgs& a);

// Explicit instantiation (declaration with `extern`, definition without) of
// one tile, with and without segment ids.
#define TPX_FLASH_FWD_EXTERN(D, BQ, BK)                                          \
  extern template cudaError_t flash_fwd_tile<D, BQ, BK, false>(const FwdArgs&);  \
  extern template cudaError_t flash_fwd_tile<D, BQ, BK, true>(const FwdArgs&);
#define TPX_FLASH_FWD_INSTANCE(D, BQ, BK)                                        \
  template cudaError_t flash_fwd_tile<D, BQ, BK, false>(const FwdArgs&);         \
  template cudaError_t flash_fwd_tile<D, BQ, BK, true>(const FwdArgs&);

namespace fwd {

using bf16 = __nv_bfloat16;

constexpr int kStages = 2;
constexpr float kLn2 = 0.6931471805599453f;

template <int D, int BQ, int BK>
struct Smem {
  bf16 q[BQ * D];  // [D/64][BQ][64], swizzled; every array 1024-byte aligned
  bf16 k[kStages][BK * D];
  bf16 v[kStages][BK * D];
  int kseg[kStages][BK];  // the K/V tile's segment ids (kSeg only)
  uint64_t q_full, full[kStages], empty[kStages];
};

template <int D, int BQ, int BK, bool kSeg>
__global__ void __launch_bounds__(2 * BQ, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const int* __restrict__ seg,
                       float* __restrict__ o, float* __restrict__ lse, int S, int H, int KVH,
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
    mbar_expect_tx(&sm.q_full, BQ * D * 2);
    for (int c = 0; c < D / 64; ++c)
      tma_load_3d(sm.q + c * BQ * 64, &tq, &sm.q_full, c * 64, h, b * S + q0);
    for (int kt = 0; kt < kStages && kt < nk; ++kt) load_kv(kt);
  }
  __syncthreads();

  // warpgroup wg: query rows r0 + [0, 64)
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = q0 + wg * 64;
  const int row = r0 + warp * 16 + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);
  const bf16* q_wg = sm.q + wg * 64 * 64;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's columns only
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
    // skipped when every key of the tile follows every query of the warpgroup
    if (!causal || k0 <= r0 + 63) {
      float s[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * BQ * 64 + (kk % 4) * 16;
        wgmma_ss(s, desc_sw128(q_wg + off, 16, 1024),
                 desc_sw128(sm.k[st] + (kk / 4) * BK * 64 + (kk % 4) * 16, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // online softmax in base 2; s[i] is row (i & 2 ? row + 8 : row),
      // column k0 + 8 * (i / 4) + col + (i & 1); masked where the key
      // follows the query, on the tiles that cross the warpgroup's diagonal
      const bool diag = causal && k0 + BK - 1 > r0;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = s[i] * scale_log2;
        if (diag && k0 + 8 * (i / 4) + col + (i & 1) > row + (i & 2 ? 8 : 0)) x = -INFINITY;
        if constexpr (kSeg)
          if (sm.kseg[st][8 * (i / 4) + col + (i & 1)] != (i & 2 ? qs1 : qs0)) x = -INFINITY;
        s[i] = x;
        if (i & 2)
          mx1 = fmaxf(mx1, x);
        else
          mx0 = fmaxf(mx0, x);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // without segments tile 0 leaves every row a finite max (column 0 is
      // never masked); with them a row's max is -inf until a key of its own
      // segment: the reference 0 then gives a = p = 0 instead of NaN
      float ref0 = mx0, ref1 = mx1;
      if constexpr (kSeg) {
        ref0 = mx0 == -INFINITY ? 0.f : mx0;
        ref1 = mx1 == -INFINITY ? 0.f : mx1;
      }
      const float a0 = exp2_approx(m0 - ref0), a1 = exp2_approx(m1 - ref1);
      m0 = mx0;
      m1 = mx1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float p = exp2_approx(s[i] - (i & 2 ? ref1 : ref0));
        s[i] = p;
        if (i & 2)
          rs1 += p;
        else
          rs0 += p;
      }
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? a1 : a0;

      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], ph[kk][r], pl[kk][r]);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t vd = desc_sw128(sm.v[st] + kk * 16 * 64, BK * 128, 1024);
        wgmma_rs(acc, ph[kk], vd);
        wgmma_rs(acc, pl[kk], vd);
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

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  float* o0 = o + ((int64_t)(b * S + row) * H + h) * D + col;
  float* o1 = o0 + (int64_t)8 * H * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(o0 + 8 * j) = make_float2(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    *reinterpret_cast<float2*>(o1 + 8 * j) =
        make_float2(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
  if (lane % 4 == 0) {
    float* L = lse + (int64_t)(b * H + h) * S + row;
    L[0] = (m0 + log2f(l0)) * kLn2;
    L[8] = (m1 + log2f(l1)) * kLn2;
  }
}

}  // namespace fwd

template <int D, int BQ, int BK, bool kSeg>
cudaError_t flash_fwd_tile(const FwdArgs& a) {
  constexpr size_t smem = sizeof(fwd::Smem<D, BQ, BK>) + 1024;
  static_assert(smem <= 232448, "the tile's shared memory exceeds a block's 227 KB");
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_row_map(&tq, a.q, D, a.H, (int64_t)a.B * a.S, BQ)) != cudaSuccess) return err;
  if ((err = make_row_map(&tk, a.k, D, a.KVH, (int64_t)a.B * a.S, BK)) != cudaSuccess) return err;
  if ((err = make_row_map(&tv, a.v, D, a.KVH, (int64_t)a.B * a.S, BK)) != cudaSuccess) return err;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  return launch(fwd::flash_fwd_wgmma_kernel<D, BQ, BK, kSeg>, dim3(a.B * a.H, a.S / BQ), 2 * BQ,
                smem, a.stream, tq, tk, tv, (const int*)a.seg, (float*)a.o, (float*)a.lse, a.S,
                a.H, a.KVH, scale_log2, a.causal);
}

}  // namespace tpx
