// Flash-attention forward on Hopper's tensor cores (sm_90a): wgmma fed by
// TMA. bf16 q, k, v at head_dim 64 and 128; f32 o and lse.
//
// Replaces the Pallas TPU kernel torchx_tpu/ops/fused.py _flash_fwd_kernel
// (launched by _flash_fwd) for bf16, with the contract of the CUDA-core
// flash_fwd_kernel in flash_attn.cu, which keeps f32 and head_dim 256.
//
// What bounds it on an H100: operations. At the llama3_1b shapes (b=4,
// s=2048, 32 query over 8 KV heads, head_dim 64, causal) QK^T and PV are
// 69 GFLOP over ~70 MB of q/k/v/o, ~1000 operations per byte against the
// card's ridge of ~295. Only the tensor cores (989 TFLOP/s bf16 against
// 67 TFLOP/s of f32 FMAs) reach that neighbourhood, so both products run on
// wgmma and every other step is kept off their path:
//
//   * a CTA owns 128 query rows of one (batch, head): two warpgroups of
//     64 rows, each thread with up to 255 registers: S, O, the softmax
//     state and the P fragments take 208 at head_dim 64 and 215 at 128
//     (ptxas -v). Beside a producer warpgroup and setmaxnreg, ptxas
//     serialised the wgmmas and spilled at 128;
//   * one thread loads Q once and streams 128-row K/V tiles through a
//     two-stage ring by TMA (128-byte swizzle, the layout wgmma reads):
//     it refills a stage as soon as both warpgroups have released it,
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
// Causal tiles above the diagonal are never loaded, and the CTAs with the
// longest rows are scheduled first. GQA reads KV head h / n_rep in place.
//
// Segment ids (packed documents; the SegmentIds(q=seg, kv=seg) that
// torchx_tpu/ops/attention.py splash_attention hands the library kernel):
// with seg [b, s] int32 given, a query sees only keys of its own segment.
// The kernel is instantiated twice (kSeg), so launches without ids keep
// their code. With ids, each K/V stage also brings the tile's 128 ids by
// bulk copy, a thread keeps its two rows' ids in registers, and every tile
// is masked per element (a tile whose segments never meet is still
// computed: skipping it is later work). A row may then see a whole tile
// masked before any key of its own: its running max stays -inf, and the
// softmax takes 0 as its reference so that exp2 yields 0, not NaN.
// Layouts as flash_attn.cu: q [b, s, h, d]; k, v [b, s, kvh, d]; o f32
// [b, s, h, d]; lse f32 [b, h, s]; s a multiple of 128.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace tpx;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;  // query rows per CTA (two warpgroups of 64)
constexpr int kBK = 128;  // kv rows per tile
constexpr int kStages = 2;
constexpr int kThreads = 2 * 128;  // two warpgroups
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct FwdSmem {
  bf16 q[kBQ * D];  // [D/64][kBQ][64], swizzled; every array 1024-byte aligned
  bf16 k[kStages][kBK * D];
  bf16 v[kStages][kBK * D];
  int kseg[kStages][kBK];  // the K/V tile's segment ids (kSeg only)
  uint64_t q_full, full[kStages], empty[kStages];
};

template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const int* __restrict__ seg,
                       float* __restrict__ o, float* __restrict__ lse, int S, int H, int KVH,
                       float scale_log2, int causal) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(align_1024(smem_raw));
  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / KVH);
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest causal rows first
  const int nk = causal ? qt + 1 : S / kBK;   // kBQ == kBK: tile qt is the diagonal

  // thread 0 issues every load; a stage is refilled once both warpgroups
  // have released it (empty), and the products wait for it to land (full)
  auto load_kv = [&](int kt) {
    const int st = kt % kStages;
    mbar_expect_tx(&sm.full[st], 2 * kBK * D * 2 + (kSeg ? kBK * 4 : 0));
    for (int c = 0; c < D / 64; ++c) {
      tma_load_3d(sm.k[st] + c * kBK * 64, &tk, &sm.full[st], c * 64, hk, b * S + kt * kBK);
      tma_load_3d(sm.v[st] + c * kBK * 64, &tv, &sm.full[st], c * 64, hk, b * S + kt * kBK);
    }
    if constexpr (kSeg)
      bulk_load(sm.kseg[st], seg + (int64_t)b * S + kt * kBK, kBK * 4, &sm.full[st]);
  };
  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kThreads);
    }
    mbar_fence_init();
    mbar_expect_tx(&sm.q_full, kBQ * D * 2);
    for (int c = 0; c < D / 64; ++c)
      tma_load_3d(sm.q + c * kBQ * 64, &tq, &sm.q_full, c * 64, h, b * S + qt * kBQ);
    for (int kt = 0; kt < kStages && kt < nk; ++kt) load_kv(kt);
  }
  __syncthreads();

  // warpgroup wg: query rows qt * kBQ + wg * 64 + [0, 64)
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row = qt * kBQ + wg * 64 + warp * 16 + lane / 4;  // and row + 8
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
    mbar_wait(&sm.full[st], (kt / kStages) & 1);

    float s[kBK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * kBQ * 64 + (kk % 4) * 16;
      wgmma_ss(s, desc_sw128(q_wg + off, 16, 1024),
               desc_sw128(sm.k[st] + (kk / 4) * kBK * 64 + (kk % 4) * 16, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // online softmax in base 2; s[i] is row (i & 2 ? row + 8 : row),
    // column kt * kBK + 8 * (i / 4) + col + (i & 1)
    const bool diag = causal && kt == nk - 1;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      float x = s[i] * scale_log2;
      if (diag && kt * kBK + 8 * (i / 4) + col + (i & 1) > row + (i & 2 ? 8 : 0)) x = -INFINITY;
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
    for (int i = 0; i < kBK / 2; ++i) {
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

    uint32_t ph[kBK / 16][4], pl[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], ph[kk][r], pl[kk][r]);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t vd = desc_sw128(sm.v[st] + kk * 16 * 64, kBK * 128, 1024);
      wgmma_rs(acc, ph[kk], vd);
      wgmma_rs(acc, pl[kk], vd);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
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

template <int D, bool kSeg>
cudaError_t fwd_d(const void* q, const void* k, const void* v, const void* seg, void* o,
                  void* lse, int B, int S, int H, int KVH, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_row_map(&tq, q, D, H, (int64_t)B * S, kBQ)) != cudaSuccess) return err;
  if ((err = make_row_map(&tk, k, D, KVH, (int64_t)B * S, kBK)) != cudaSuccess) return err;
  if ((err = make_row_map(&tv, v, D, KVH, (int64_t)B * S, kBK)) != cudaSuccess) return err;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  return launch(flash_fwd_wgmma_kernel<D, kSeg>, dim3(B * H, S / kBQ), kThreads,
                sizeof(FwdSmem<D>) + 1024, stream, tq, tk, tv, (const int*)seg, (float*)o,
                (float*)lse, S, H, KVH, scale_log2, causal);
}

}  // namespace

extern "C" {

// bf16 only (dtype 1), head_dim 64 or 128, S a multiple of 128, H a
// multiple of KVH, every pointer 16-byte aligned; the wrapper checks. seg:
// int32 [B, S] segment ids, or null for none.
int tpx_flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                        const void* seg, int B, int S, int H, int KVH, int D, int causal,
                        int dtype, void* stream) {
  if (dtype != 1 || S % kBQ) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return (int)(seg ? fwd_d<64, true>(q, k, v, seg, o, lse, B, S, H, KVH, causal, st)
                       : fwd_d<64, false>(q, k, v, seg, o, lse, B, S, H, KVH, causal, st));
    case 128:
      return (int)(seg ? fwd_d<128, true>(q, k, v, seg, o, lse, B, S, H, KVH, causal, st)
                       : fwd_d<128, false>(q, k, v, seg, o, lse, B, S, H, KVH, causal, st));
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
