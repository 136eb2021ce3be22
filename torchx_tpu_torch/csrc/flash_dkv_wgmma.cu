// Flash-attention dk/dv on Hopper's tensor cores (sm_90a): wgmma fed by
// TMA. bf16 q, k, v, do at head_dim 64 and 128; f32 lse, delta, dk, dv.
//
// Replaces the Pallas TPU kernel torchx_tpu/ops/fused.py _flash_dkv_kernel
// (in _flash_bwd) for bf16, with the contract of the CUDA-core
// flash_dkv_kernel in flash_attn.cu, which keeps f32 and head_dim 256:
// dk and dv per KV head, summed over the n_rep query heads that share it.
//
// What bounds it on an H100: operations. Four products (K Q^T, V dO^T,
// P^T dO, dS^T Q) of 4 * 2 * b*h*s*(s+1)/2 * d = 138 GFLOP at the llama3_1b
// shapes over ~90 MB, far above the card's ridge, so all four run on wgmma:
//
//   * a CTA owns 128 kv rows of one (batch, KV head): two warpgroups of
//     64 rows, each thread with up to 255 registers (195 at head_dim 64,
//     203 at 128, no spills: ptxas -v); K and V are loaded once;
//   * it walks its n_rep query heads and their q tiles in a fixed order, so
//     dk and dv are summed in registers without atomics and the result is
//     deterministic; one thread streams Q, dO (TMA, 128-byte swizzle), lse
//     and delta (bulk copies) through a two-stage ring, refilling a stage
//     as soon as both warpgroups have released it;
//   * q tiles are 64 rows at head_dim 64 and 32 at head_dim 128, where the
//     dk and dv accumulators alone take 128 registers a thread: with 64-row
//     tiles S^T, dP^T and their fragments no longer fit beside them;
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
// Layouts as flash_attn.cu: q, do [b, s, h, d]; k, v [b, s, kvh, d]; lse,
// delta f32 [b, h, s]; dk, dv f32 [b, s, kvh, d]; s a multiple of 128.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace tpx;
using bf16 = __nv_bfloat16;

constexpr int kBKV = 128;  // kv rows per CTA (two warpgroups of 64)
constexpr int kStages = 2;
constexpr int kThreads = 2 * 128;  // two warpgroups

// query rows per tile (see the register note above)
template <int D>
constexpr int kQRows = D == 64 ? 64 : 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int kBQ = kQRows<D>>
struct DkvSmem {
  bf16 k[kBKV * D];  // [D/64][kBKV][64], swizzled; every tile 1024-byte aligned
  bf16 v[kBKV * D];
  bf16 q[kStages][kBQ * D];  // [D/64][kBQ][64]
  bf16 dout[kStages][kBQ * D];
  float lse[kStages][kBQ];
  float delta[kStages][kBQ];
  uint64_t kv_full, full[kStages], empty[kStages];
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dk,
                       float* __restrict__ dv, int S, int H, int KVH, float scale,
                       float scale_log2, int causal) {
  constexpr int kBQ = kQRows<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(align_1024(smem_raw));
  const int tid = threadIdx.x;
  const int b = blockIdx.x / KVH, hk = blockIdx.x % KVH;
  const int kt = blockIdx.y;  // low kv tiles see the most causal q tiles: they go first
  const int n_rep = H / KVH;
  const int q_begin = causal ? kt * (kBKV / kBQ) : 0;
  const int nq = S / kBQ - q_begin;  // q tiles per query head
  const int n_iter = n_rep * nq;

  // thread 0 issues every load; a stage is refilled once both warpgroups
  // have released it (empty), and the products wait for it to land (full).
  // Iteration it covers query head hk * n_rep + it / nq, q tile q_begin + it % nq.
  auto load_q = [&](int it) {
    const int st = it % kStages;
    const int h = hk * n_rep + it / nq, q0 = (q_begin + it % nq) * kBQ;
    mbar_expect_tx(&sm.full[st], 2 * kBQ * D * 2 + 2 * kBQ * 4);
    for (int c = 0; c < D / 64; ++c) {
      tma_load_3d(sm.q[st] + c * kBQ * 64, &tq, &sm.full[st], c * 64, h, b * S + q0);
      tma_load_3d(sm.dout[st] + c * kBQ * 64, &tdo, &sm.full[st], c * 64, h, b * S + q0);
    }
    const int64_t rows = (int64_t)(b * H + h) * S + q0;
    bulk_load(sm.lse[st], lse + rows, kBQ * 4, &sm.full[st]);
    bulk_load(sm.delta[st], delta + rows, kBQ * 4, &sm.full[st]);
  };
  if (tid == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kThreads);
    }
    mbar_fence_init();
    mbar_expect_tx(&sm.kv_full, 2 * kBKV * D * 2);
    for (int c = 0; c < D / 64; ++c) {
      tma_load_3d(sm.k + c * kBKV * 64, &tk, &sm.kv_full, c * 64, hk, b * S + kt * kBKV);
      tma_load_3d(sm.v + c * kBKV * 64, &tv, &sm.kv_full, c * 64, hk, b * S + kt * kBKV);
    }
    for (int it = 0; it < kStages && it < n_iter; ++it) load_q(it);
  }
  __syncthreads();

  // warpgroup wg: kv rows kv0 + [0, 64)
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int kv0 = kt * kBKV + wg * 64;
  const int row = kv0 + warp * 16 + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);
  const bf16* k_wg = sm.k + wg * 64 * 64;
  const bf16* v_wg = sm.v + wg * 64 * 64;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(&sm.kv_full, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int st = it % kStages;
    const int q0 = (q_begin + it % nq) * kBQ;
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    // skipped when every query of the tile precedes every key
    if (!causal || q0 + kBQ > kv0) {
      float s[kBQ / 2], dp[kBQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a_off = (kk / 4) * kBKV * 64 + (kk % 4) * 16;
        const int b_off = (kk / 4) * kBQ * 64 + (kk % 4) * 16;
        wgmma_ss(s, desc_sw128(k_wg + a_off, 16, 1024), desc_sw128(sm.q[st] + b_off, 16, 1024),
                 kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a_off = (kk / 4) * kBKV * 64 + (kk % 4) * 16;
        const int b_off = (kk / 4) * kBQ * 64 + (kk % 4) * 16;
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
      for (int i = 0; i < kBQ / 2; ++i) {
        const int qc = 8 * (i / 4) + col + (i & 1);
        float p = exp2_approx(s[i] * scale_log2 - sm.lse[st][qc] * kLog2e);
        if (diag && q0 + qc < row + (i & 2 ? 8 : 0)) p = 0.f;
        s[i] = p;
        dp[i] = p * (dp[i] - sm.delta[st][qc]);
      }

      uint32_t hi[kBQ / 16][4], lo[kBQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        const uint64_t dod = desc_sw128(sm.dout[st] + kk * 16 * 64, kBQ * 128, 1024);
        wgmma_rs(dv_acc, hi[kk], dod);
        wgmma_rs(dv_acc, lo[kk], dod);
      }
      wgmma_commit();
      // at D = 128 the accumulators take 128 registers: let the P^T fragments
      // go before the dS^T ones are made
      if (D > 64) wgmma_wait<0>();

      uint32_t dhi[kBQ / 16][4], dlo[kBQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16x2(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1], dhi[kk][r], dlo[kk][r]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        const uint64_t qd = desc_sw128(sm.q[st] + kk * 16 * 64, kBQ * 128, 1024);
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

template <int D>
cudaError_t dkv_d(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dk, void* dv, int B, int S, int H,
                  int KVH, int causal, cudaStream_t stream) {
  constexpr int kBQ = kQRows<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = make_row_map(&tq, q, D, H, (int64_t)B * S, kBQ)) != cudaSuccess) return err;
  if ((err = make_row_map(&tk, k, D, KVH, (int64_t)B * S, kBKV)) != cudaSuccess) return err;
  if ((err = make_row_map(&tv, v, D, KVH, (int64_t)B * S, kBKV)) != cudaSuccess) return err;
  if ((err = make_row_map(&tdo, dout, D, H, (int64_t)B * S, kBQ)) != cudaSuccess) return err;
  const double scale = 1.0 / sqrt((double)D);
  return launch(flash_dkv_wgmma_kernel<D>, dim3(B * KVH, S / kBKV), kThreads,
                sizeof(DkvSmem<D>) + 1024, stream, tq, tk, tv, tdo, (const float*)lse,
                (const float*)delta, (float*)dk, (float*)dv, S, H, KVH, (float)scale,
                (float)(scale * 1.4426950408889634), causal);
}

}  // namespace

extern "C" {

// bf16 only (dtype 1), head_dim 64 or 128, S a multiple of 128, H a
// multiple of KVH, every pointer 16-byte aligned; the wrapper checks.
int tpx_flash_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int B, int S,
                        int H, int KVH, int D, int causal, int dtype, void* stream) {
  if (dtype != 1 || S % kBKV) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return (int)dkv_d<64>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KVH, causal,
                            (cudaStream_t)stream);
    case 128:
      return (int)dkv_d<128>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KVH, causal,
                             (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
