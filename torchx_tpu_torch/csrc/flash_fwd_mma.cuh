// Flash-attention forward on Hopper's tensor cores by mma.sync (sm_90a),
// for what the wgmma kernels do not take: f32 q, k, v at head_dim 64, 128
// and 256, and bf16 at head_dim 256; f32 o and lse. The kernel and its host
// launcher as templates over the element type and the tile:
// flash_fwd_mma.cu holds the entry point, the flash_fwd_mma_*.cu files the
// compiled instances (TPX_FLASH_FWD_MMA_TILES), spread so that their nvcc
// calls run side by side.
//
// Replaces the Pallas TPU kernel torchx_tpu/ops/fused.py _flash_fwd_kernel
// (launched by _flash_fwd) on those routes, with the contract of
// flash_fwd_wgmma.cuh: the same layouts, lse convention and segment ids.
//
// What bounds it on an H100: operations. At Gemma-2-2B's attention shape
// (b 4, s 2048, 8 query over 4 KV heads of 256, causal) QK^T and PV are 69
// GFLOP over ~200 MB in f32, ~350 operations per byte. The JAX kernel forms
// every product in f32 (_dot); one TF32 pass keeps ~3 decimal digits, short
// of the port's f32 tolerance (2e-5), so each f32 product runs as three
// TF32 products: hi*hi + hi*lo + lo*hi, each operand split once it is in
// registers (hopper.cuh split_tf32). The bound is then three times the
// operations over the TF32 rate (495 TFLOP/s); bf16 runs at the bf16 rate.
//
//   * a CTA owns BQ query rows of one (batch, head), BQ / 16 warps of 16
//     rows (for f32 at head_dim 256 twice that, DSPLIT 2: the two warps of
//     a row group compute the same S and each accumulates half of O, 1.5x
//     the products); one thread loads Q once and streams BK-row K/V tiles
//     through a two-stage ring by TMA (128-byte swizzle, so that the
//     fragment reads below are free of bank conflicts), refilling a stage
//     as soon as every warp has released it: full/empty mbarriers between
//     loads and products;
//   * S = Q K^T per warp by mma.sync from shared memory (hopper.cuh
//     warp_mma_abt: f32 m16n8k8 TF32 in three passes, bf16 m16n8k16 by
//     ldmatrix); the scale is applied to S in f32 in the base-2 domain and
//     the online softmax (row max and sum over the 4 lanes that share a row)
//     runs in registers;
//   * O += P V with P from the S accumulators (warp_mma_pv: f32 P and V
//     split into TF32 hi + lo, three products; bf16 P split into bf16
//     hi + lo as the wgmma kernels split it, V by ldmatrix.trans);
//   * O is divided by l in the epilogue; lse = (m + log2 l) ln 2.
//
// Why not wgmma: with 32-bit operands wgmma reads only K-major tiles from
// shared memory, so P V (V is [kv, d]) would need a transposed copy of V,
// and three passes a hi and a lo copy of every shared operand, on tiles
// twice bf16's size. A thread's O accumulator is 16 x head_dim / 32
// registers: 128 at head_dim 256, hence 16-row warps and 32-row K/V tiles
// there (f32: Q 64 KB and two stages of K and V 128 KB of the 227 KB), and
// in f32, whose split fragments take more registers than bf16's, the head
// dim split over two warps: one warp's O spilled (ptxas -v).
//
// Causal: a CTA streams only the kv tiles up to its last row's diagonal; a
// warp skips the tiles wholly after its rows and masks those that cross its
// diagonal. The CTAs with the longest rows are scheduled first. GQA reads KV
// head h / n_rep in place.
//
// Segment ids (packed documents, as flash_fwd_wgmma.cuh): with seg [b, s]
// int32 given (the kSeg instance), each K/V stage also brings the tile's BK
// ids by bulk copy, a thread keeps its two rows' ids in registers, and every
// element whose ids differ is masked; a row whose keys so far all lie in
// other segments keeps a running max of -inf and takes 0 as its softmax
// reference, so that exp2 yields 0, not NaN. The scaled scores and the
// running sums use explicitly rounded operations (no contraction), so a row
// whose ids are all equal gets the unmasked instance's bits.
// Layouts: q [b, s, h, d]; k, v [b, s, kvh, d]; o f32
// [b, s, h, d]; lse f32 [b, h, s]; s a multiple of BQ and of BK.

#pragma once

#include <math.h>

#include "hopper.cuh"

// The compiled tiles (element type, head_dim, block_q, block_kv), each with
// and without segment ids, by the file that instantiates them; ops/fused.py's
// MMA_TILES names the same.
#define TPX_FLASH_FWD_MMA_TILES_F32_D64(X) X(float, 64, 64, 64)
#define TPX_FLASH_FWD_MMA_TILES_F32_D128(X) X(float, 128, 64, 32)
#define TPX_FLASH_FWD_MMA_TILES_F32_D256(X) X(float, 256, 64, 32)
#define TPX_FLASH_FWD_MMA_TILES_BF16_D256(X) X(__nv_bfloat16, 256, 64, 32)
#define TPX_FLASH_FWD_MMA_TILES(X)                                               \
  TPX_FLASH_FWD_MMA_TILES_F32_D64(X) TPX_FLASH_FWD_MMA_TILES_F32_D128(X)         \
  TPX_FLASH_FWD_MMA_TILES_F32_D256(X) TPX_FLASH_FWD_MMA_TILES_BF16_D256(X)

namespace tpx {

struct FwdMmaArgs {
  const void *q, *k, *v, *seg;  // seg: int32 [B, S], or null
  void *o, *lse;
  int B, S, H, KVH, causal;
  cudaStream_t stream;
};

template <typename T, int D, int BQ, int BK, bool kSeg>
cudaError_t flash_fwd_mma_tile(const FwdMmaArgs& a);

// Explicit instantiation (declaration with `extern`, definition without) of
// one tile, with and without segment ids.
#define TPX_FLASH_FWD_MMA_EXTERN(T, D, BQ, BK)                                          \
  extern template cudaError_t flash_fwd_mma_tile<T, D, BQ, BK, false>(const FwdMmaArgs&); \
  extern template cudaError_t flash_fwd_mma_tile<T, D, BQ, BK, true>(const FwdMmaArgs&);
#define TPX_FLASH_FWD_MMA_INSTANCE(T, D, BQ, BK)                                        \
  template cudaError_t flash_fwd_mma_tile<T, D, BQ, BK, false>(const FwdMmaArgs&);      \
  template cudaError_t flash_fwd_mma_tile<T, D, BQ, BK, true>(const FwdMmaArgs&);

namespace fwd_mma {

constexpr int kStages = 2;
constexpr float kLn2 = 0.6931471805599453f;

// Warps along the head dim: two for f32 at head_dim 256, where one warp's O
// (128 registers a thread) beside the split TF32 fragments spilled.
template <typename T, int D> __host__ __device__ constexpr int dsplit() {
  return sizeof(T) == 4 && D == 256 ? 2 : 1;
}

template <typename T, int D, int BQ, int BK>
struct Smem {
  T q[BQ * D];  // [D / W][BQ][W] (W = 128 / sizeof(T)), swizzled; every tile 1024-byte aligned
  T k[kStages][BK * D];
  T v[kStages][BK * D];
  int kseg[kStages][BK];  // the K/V tile's segment ids (kSeg only)
  uint64_t q_full, full[kStages], empty[kStages];
};

template <typename T, int D, int BQ, int BK, int DSPLIT, bool kSeg>
__global__ void __launch_bounds__(2 * BQ * DSPLIT, 1)
flash_fwd_mma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const int* __restrict__ seg,
                     float* __restrict__ o, float* __restrict__ lse, int S, int H, int KVH,
                     float scale_log2, int causal) {
  constexpr int E = sizeof(T), W = 128 / E;  // a column block: 128 bytes
  constexpr int kThreads = 2 * BQ * DSPLIT;  // BQ / 16 warps along the rows, DSPLIT along d
  constexpr int RG = BQ / 16, DACC = D / DSPLIT;  // row groups; O columns a warp owns
  constexpr int NB = BK / 8, ND = DACC / 8;  // n8 blocks of S and of O
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && D % W == 0, "tile shapes");
  static_assert(sizeof(T) * BK * D % 1024 == 0, "each tile 1024-byte aligned");
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
    mbar_expect_tx(&sm.q_full, BQ * D * E);
    for (int c = 0; c < D / W; ++c)
      tma_load_3d(sm.q + c * BQ * W, &tq, &sm.q_full, c * W, h, b * S + q0);
    for (int kt = 0; kt < kStages && kt < nk; ++kt) load_kv(kt);
  }
  __syncthreads();

  // warp w: query rows r0 + [0, 16) (row group w % RG), O columns
  // dc0 + [0, DACC); this thread rows `row` and row + 8, columns 2c, 2c + 1
  // of every n8 block. The DSPLIT warps of a row group compute the same S
  // and softmax state.
  const int warp = tid / 32, lane = tid % 32, c = lane % 4;
  const int wr = (DSPLIT == 1 ? warp : warp % RG) * 16, r0 = q0 + wr;
  const int dc0 = DSPLIT == 1 ? 0 : (warp / RG) * DACC;
  const int row = r0 + lane / 4;

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
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
    // skipped when every key of the tile follows every query of the warp
    if (!causal || k0 <= r0 + 15) {
      float s[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
      warp_mma_abt<T, D, BQ, BK, BK>(s, sm.q, wr, sm.k[st], lane);

      // online softmax in base 2; s[j][i] is row (i & 2 ? row + 8 : row),
      // column k0 + 8j + 2c + (i & 1); masked where the key follows the
      // query, on the tiles that cross the warp's diagonal
      const bool diag = causal && k0 + BK - 1 > r0;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 8 * j + 2 * c + (i & 1);
          float x = __fmul_rn(s[j][i], scale_log2);
          if (diag && k0 + col > row + (i & 2 ? 8 : 0)) x = -INFINITY;
          if constexpr (kSeg)
            if (sm.kseg[st][col] != (i & 2 ? qs1 : qs0)) x = -INFINITY;
          s[j][i] = x;
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
      // without segments a warp's first tile leaves every row a finite max
      // (key 0 is never masked); with them a row's max is -inf until a key
      // of its own segment: the reference 0 then gives a = p = 0, not NaN
      float ref0 = mx0, ref1 = mx1;
      if constexpr (kSeg) {
        ref0 = mx0 == -INFINITY ? 0.f : mx0;
        ref1 = mx1 == -INFINITY ? 0.f : mx1;
      }
      const float a0 = exp2_approx(__fsub_rn(m0, ref0)), a1 = exp2_approx(__fsub_rn(m1, ref1));
      m0 = mx0;
      m1 = mx1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = exp2_approx(__fsub_rn(s[j][i], i & 2 ? ref1 : ref0));
          s[j][i] = p;
          if (i & 2)
            rs1 = __fadd_rn(rs1, p);
          else
            rs0 = __fadd_rn(rs0, p);
        }
      l0 = __fmaf_rn(l0, a0, rs0);
      l1 = __fmaf_rn(l1, a1, rs1);
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = __fmul_rn(acc[j][i], i & 2 ? a1 : a0);

      warp_mma_pv<T, BK, DACC>(acc, s, sm.v[st], dc0, lane);
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
    l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, off));
    l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, off));
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  float* o0 = o + ((int64_t)(b * S + row) * H + h) * D + dc0 + 2 * c;
  float* o1 = o0 + (int64_t)8 * H * D;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    *reinterpret_cast<float2*>(o0 + 8 * j) =
        make_float2(__fmul_rn(acc[j][0], inv0), __fmul_rn(acc[j][1], inv0));
    *reinterpret_cast<float2*>(o1 + 8 * j) =
        make_float2(__fmul_rn(acc[j][2], inv1), __fmul_rn(acc[j][3], inv1));
  }
  if (c == 0 && dc0 == 0) {
    float* L = lse + (int64_t)(b * H + h) * S + row;
    L[0] = __fmul_rn(__fadd_rn(m0, log2f(l0)), kLn2);
    L[8] = __fmul_rn(__fadd_rn(m1, log2f(l1)), kLn2);
  }
}

}  // namespace fwd_mma

template <typename T, int D, int BQ, int BK, bool kSeg>
cudaError_t flash_fwd_mma_tile(const FwdMmaArgs& a) {
  constexpr size_t smem = sizeof(fwd_mma::Smem<T, D, BQ, BK>) + 1024;
  static_assert(smem <= 232448, "the tile's shared memory exceeds a block's 227 KB");
  constexpr int eb = sizeof(T);
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  const int64_t rows = (int64_t)a.B * a.S;
  if ((err = make_row_map(&tq, a.q, D, a.H, rows, BQ, eb)) != cudaSuccess) return err;
  if ((err = make_row_map(&tk, a.k, D, a.KVH, rows, BK, eb)) != cudaSuccess) return err;
  if ((err = make_row_map(&tv, a.v, D, a.KVH, rows, BK, eb)) != cudaSuccess) return err;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  constexpr int dsplit = fwd_mma::dsplit<T, D>();
  return launch(fwd_mma::flash_fwd_mma_kernel<T, D, BQ, BK, dsplit, kSeg>,
                dim3(a.B * a.H, a.S / BQ), 2 * BQ * dsplit, smem, a.stream, tq, tk, tv,
                (const int*)a.seg, (float*)a.o, (float*)a.lse, a.S, a.H, a.KVH, scale_log2,
                a.causal);
}

}  // namespace tpx
