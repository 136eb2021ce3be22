// Flash-attention dq on Hopper's tensor cores (sm_90a): wgmma fed by TMA.
// bf16 q, k, v, do at head_dim 64 and 128; f32 lse, delta and dq.
//
// Replaces the Pallas TPU kernel torchx_tpu/ops/fused.py _flash_dq_kernel
// (in _flash_bwd) for bf16, with the contract of the CUDA-core
// flash_dq_kernel in flash_attn.cu, which keeps f32 and head_dim 256:
//   P = exp(Q K^T * scale - lse),  dS = P (dO V^T - delta),  dQ = dS K * scale.
//
// What bounds it on an H100: operations. Three products (Q K^T, dO V^T,
// dS K) of 3 * 2 * b*h*s*(s+1)/2 * d = 103 GFLOP at the llama3_1b shapes
// over ~80 MB, far above the card's ridge, so all three run on wgmma. The
// design is flash_dkv_wgmma.cu's turned round:
//
//   * a CTA owns 128 query rows of one (batch, head): two warpgroups of 64
//     rows. One thread TMA-loads Q and dO once (128-byte swizzle) and the
//     CTA's lse and delta rows once by bulk copy, then streams the K and V
//     tiles of KV head h / n_rep through a two-stage ring, refilling a
//     stage as soon as both warpgroups have released it. There is no
//     producer warpgroup: beside one, with setmaxnreg, ptxas serialised
//     the wgmmas and spilled (flash_fwd_wgmma.cu, flash_dkv_wgmma.cu);
//   * kv tiles are 128 rows at head_dim 64 and 64 at head_dim 128: per
//     thread the S and dP accumulators take kv_rows / 2 registers each, dQ
//     head_dim / 2 and the dS hi and lo fragments kv_rows / 4 each.
//     ptxas -v: 194 registers a thread at head_dim 64, 155 at 128, no
//     spills, no wgmma serialisation (chip_smoke.py's build phase);
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
// Causal kv tiles above a warpgroup's diagonal are skipped, and only the
// tiles that cross it are masked; the grid puts the longest q tiles first,
// and the CTAs of one q tile, whose heads share KV heads, run together, so
// K and V come from L2. dq is owned by one CTA: no atomics, the result is
// bitwise repeatable. Layouts as flash_attn.cu: q, do [b, s, h, d]; k, v
// [b, s, kvh, d]; lse, delta f32 [b, h, s]; dq f32 [b, s, h, d]; s a
// multiple of 128.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace tpx;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;  // query rows per CTA (two warpgroups of 64)
constexpr int kStages = 2;
constexpr int kThreads = 2 * 128;  // two warpgroups
constexpr float kLog2e = 1.4426950408889634f;

// kv rows per tile (see the register note above)
template <int D>
constexpr int kKVRows = D == 64 ? 128 : 64;

template <int D, int kBK = kKVRows<D>>
struct DqSmem {
  bf16 q[kBQ * D];  // [D/64][kBQ][64], swizzled; every tile 1024-byte aligned
  bf16 dout[kBQ * D];
  bf16 k[kStages][kBK * D];  // [D/64][kBK][64]
  bf16 v[kStages][kBK * D];
  float lse[kBQ];
  float delta[kBQ];
  uint64_t q_full, full[kStages], empty[kStages];
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq, int S, int H,
                      int KVH, float scale, float scale_log2, int causal) {
  constexpr int kBK = kKVRows<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(align_1024(smem_raw));
  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // the longest causal rows first
  const int nk = causal ? (q0 + kBQ) / kBK : S / kBK;

  // thread 0 issues every load; a stage is refilled once both warpgroups
  // have released it (empty), and the products wait for it to land (full)
  auto load_kv = [&](int kt) {
    const int st = kt % kStages;
    mbar_expect_tx(&sm.full[st], 2 * kBK * D * 2);
    for (int c = 0; c < D / 64; ++c) {
      tma_load_3d(sm.k[st] + c * kBK * 64, &tk, &sm.full[st], c * 64, hk, b * S + kt * kBK);
      tma_load_3d(sm.v[st] + c * kBK * 64, &tv, &sm.full[st], c * 64, hk, b * S + kt * kBK);
    }
  };
  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kThreads);
    }
    mbar_fence_init();
    mbar_expect_tx(&sm.q_full, 2 * kBQ * D * 2 + 2 * kBQ * 4);
    for (int c = 0; c < D / 64; ++c) {
      tma_load_3d(sm.q + c * kBQ * 64, &tq, &sm.q_full, c * 64, h, b * S + q0);
      tma_load_3d(sm.dout + c * kBQ * 64, &tdo, &sm.q_full, c * 64, h, b * S + q0);
    }
    const int64_t rows = (int64_t)(b * H + h) * S + q0;
    bulk_load(sm.lse, lse + rows, kBQ * 4, &sm.q_full);
    bulk_load(sm.delta, delta + rows, kBQ * 4, &sm.q_full);
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
  mbar_wait(&sm.q_full, 0);
  const float lse0 = sm.lse[local] * kLog2e, lse1 = sm.lse[local + 8] * kLog2e;
  const float delta0 = sm.delta[local], delta1 = sm.delta[local + 8];

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kStages;
    const int k0 = kt * kBK;
    mbar_wait(&sm.full[st], (kt / kStages) & 1);
    // skipped when every key of the tile follows every query of the warpgroup
    if (!causal || k0 <= r0 + 63) {
      float s[kBK / 2], dp[kBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a_off = (kk / 4) * kBQ * 64 + (kk % 4) * 16;
        const int b_off = (kk / 4) * kBK * 64 + (kk % 4) * 16;
        wgmma_ss(s, desc_sw128(q_wg + a_off, 16, 1024), desc_sw128(sm.k[st] + b_off, 16, 1024),
                 kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a_off = (kk / 4) * kBQ * 64 + (kk % 4) * 16;
        const int b_off = (kk / 4) * kBK * 64 + (kk % 4) * 16;
        wgmma_ss(dp, desc_sw128(do_wg + a_off, 16, 1024), desc_sw128(sm.v[st] + b_off, 16, 1024),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // s[i], dp[i]: query row (i & 2 ? row + 8 : row), key k0 + kc with
      // kc = 8 * (i / 4) + col + (i & 1); masked where the key follows the query
      const bool diag = causal && k0 + kBK - 1 > r0;
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const bool low = i & 2;
        float p = exp2_approx(s[i] * scale_log2 - (low ? lse1 : lse0));
        if (diag && k0 + 8 * (i / 4) + col + (i & 1) > row + (low ? 8 : 0)) p = 0.f;
        dp[i] = p * (dp[i] - (low ? delta1 : delta0));
      }

      uint32_t hi[kBK / 16][4], lo[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16x2(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t kd = desc_sw128(sm.k[st] + kk * 16 * 64, kBK * 128, 1024);
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

template <int D>
cudaError_t dq_d(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dq, int B, int S, int H, int KVH, int causal,
                 cudaStream_t stream) {
  constexpr int kBK = kKVRows<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = make_row_map(&tq, q, D, H, (int64_t)B * S, kBQ)) != cudaSuccess) return err;
  if ((err = make_row_map(&tk, k, D, KVH, (int64_t)B * S, kBK)) != cudaSuccess) return err;
  if ((err = make_row_map(&tv, v, D, KVH, (int64_t)B * S, kBK)) != cudaSuccess) return err;
  if ((err = make_row_map(&tdo, dout, D, H, (int64_t)B * S, kBQ)) != cudaSuccess) return err;
  const double scale = 1.0 / sqrt((double)D);
  return launch(flash_dq_wgmma_kernel<D>, dim3(B * H, S / kBQ), kThreads,
                sizeof(DqSmem<D>) + 1024, stream, tq, tk, tv, tdo, (const float*)lse,
                (const float*)delta, (float*)dq, S, H, KVH, (float)scale,
                (float)(scale * 1.4426950408889634), causal);
}

}  // namespace

extern "C" {

// bf16 only (dtype 1), head_dim 64 or 128, S a multiple of 128, H a
// multiple of KVH, every pointer 16-byte aligned; the wrapper checks.
int tpx_flash_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq, int B, int S, int H, int KVH,
                       int D, int causal, int dtype, void* stream) {
  if (dtype != 1 || S % kBQ) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return (int)dq_d<64>(q, k, v, dout, lse, delta, dq, B, S, H, KVH, causal,
                           (cudaStream_t)stream);
    case 128:
      return (int)dq_d<128>(q, k, v, dout, lse, delta, dq, B, S, H, KVH, causal,
                            (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
