// The int8-weight matmul of weight-only serving, for Hopper (sm_90a):
//
//     y[m, n] = (sum_k x[m, k] * q[k, n]) * scale[n]
//
// x bf16 or f32 [M, K] row-major; q int8 [K, N] row-major (the JAX layout,
// [in, out]); scale f32 [N], applied after the f32 sum (never folded into
// the weights); y in x's dtype or f32 (the lm head's logits).
//
// Replaces torchx_tpu/ops/quant.py int8_matmul, which is no Pallas kernel:
// the JAX package writes dot_general(x, q, preferred_element_type=f32) *
// scale and XLA lowers it to a mixed-input product. PyTorch has no int8 x
// bf16 product on CUDA, and widening q to bf16 before cuBLAS would write and
// reread a bf16 copy of every weight.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s):
// * decode, M = the busy slots (8): bytes. A llama3_8b step reads 7.5 GB of
//   int8 projections, 2.2 ms at 3.35 TB/s, and does 2 operations per weight
//   byte and row, far below the ~295 the tensor cores need per byte.
// * prefill, M = a chunk's rows (up to a few thousand): operations.
// What the design does about it:
// * every int8 weight is read from device memory once per block row of
//   outputs, as 16-byte cp.async loads, neighbouring threads on neighbouring
//   n, several k stages in flight (a 4-stage ring of 64-row tiles at M <= 16,
//   3 stages at larger M);
// * where the output tiles alone would leave SMs idle (decode), the k range
//   is split across blocks (the wrapper picks the split, about two blocks an
//   SM); each split writes its f32 partial sums to a workspace and a second
//   pass adds them in split order, then scales and casts: no atomics, so
//   the result is deterministic;
// * bf16 x: the int8 tile is widened to bf16 in registers (exact, |q| <= 127)
//   and multiplied on the tensor cores by mma.sync m16n8k16 with f32
//   accumulators; 16-row blocks of 8 warps each 16 x 16 at M <= 16, 128-row
//   blocks of 8 warps each 64 x 32 above;
// * f32 x (small checks only): a CUDA-core kernel, 16 x 128 outputs a block.
// wgmma with TMA-fed tiles and a persistent schedule are later work.
//
// Offsets are 64-bit: the lm head's K * N (525 M) and a prefill's M * N
// (2048 x 128256) come close to int32's range. K needs no multiple of the
// tile (rows past the end are zero-filled); the wrapper checks K % 8 == 0
// and N % 16 == 0 (16-byte rows) and 16-byte aligned pointers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;            // output columns per block
constexpr int kBK = 64;             // k rows per stage
constexpr int kThreads = 256;       // 8 warps
constexpr int kQStride = kBN + 16;  // bytes per q tile row in shared memory
constexpr int kXStride = kBK + 8;   // elements per bf16 x tile row (144 bytes)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src then unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two int8 (low k first) -> a bf16x2 register, exactly
__device__ __forceinline__ uint32_t widen2(uint8_t lo, uint8_t hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(static_cast<int8_t>(lo)),
                                           static_cast<float>(static_cast<int8_t>(hi)));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7},"
      " {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One stage: q rows [k0, k0 + kBK) x columns [n0, n0 + kBN), and x rows
// [m0, m0 + BM) x the same k, each as 16-byte chunks; rows at or past k_end
// (the split's end) or M, and columns past N, are zero-filled.
template <int BM>
__device__ __forceinline__ void load_stage(uint8_t* sq, __nv_bfloat16* sx,
                                           const __nv_bfloat16* __restrict__ x,
                                           const int8_t* __restrict__ q, int M, int N, int K,
                                           int k_end, int m0, int n0, int k0, int tid) {
#pragma unroll
  for (int c = tid; c < kBK * kBN / 16; c += kThreads) {
    const int r = c / (kBN / 16), col = (c % (kBN / 16)) * 16;
    const int k = k0 + r, n = n0 + col;
    const bool ok = k < k_end && n < N;
    cp_async16(sq + r * kQStride + col, ok ? q + (size_t)k * N + n : q, ok);
  }
#pragma unroll
  for (int c = tid; c < BM * kBK / 8; c += kThreads) {
    const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
    const int m = m0 + r, k = k0 + col;
    const bool ok = m < M && k < k_end;
    cp_async16(sx + r * kXStride + col, ok ? x + (size_t)m * K + k : x, ok);
  }
}

// Stores a pair of outputs (columns n, n + 1 of row m): the final value
// (sum * scale, cast) or, when the k range is split, the f32 partial sum.
template <bool OUT_F32>
__device__ __forceinline__ void store_pair(void* __restrict__ y, float* __restrict__ work,
                                           const float* __restrict__ scale, int M, int N, int m,
                                           int n, float v0, float v1) {
  const size_t off = (size_t)m * N + n;
  if (work != nullptr) {
    *reinterpret_cast<float2*>(work + (size_t)blockIdx.z * M * N + off) = make_float2(v0, v1);
  } else if (OUT_F32) {
    *reinterpret_cast<float2*>(static_cast<float*>(y) + off) =
        make_float2(v0 * scale[n], v1 * scale[n + 1]);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) + off) =
        __floats2bfloat162_rn(v0 * scale[n], v1 * scale[n + 1]);
  }
}

// bf16 x on the tensor cores. Block: BM rows x kBN columns over k steps
// [blockIdx.z * kps, ...) of kBK rows; warps laid out WARPS_M x WARPS_N,
// each WM m16 tiles x WN n8 tiles.
template <int BM, int STAGES, bool OUT_F32>
__global__ void __launch_bounds__(kThreads)
    int8_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, void* __restrict__ y,
                    float* __restrict__ work, int M, int N, int K, int kps) {
  constexpr int WM = BM == 16 ? 1 : 4;
  constexpr int WARPS_M = BM / (16 * WM);
  constexpr int WARPS_N = (kThreads / 32) / WARPS_M;
  constexpr int WN = kBN / (WARPS_N * 8);
  static_assert(WARPS_M * 16 * WM == BM && WARPS_N * WN * 8 == kBN, "warp tiling");

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sq = smem;
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * kBK * kQStride);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * kps * kBK;
  const int k_end = min(K, k_begin + kps * kBK);
  const int nk = (k_end - k_begin + kBK - 1) / kBK;

  // f32 outputs (the lm head's logits) keep the tensor cores' sums of one
  // stage apart and add them into acc with CUDA-core adds: the tensor
  // cores' own f32 accumulation over a long k chain loses precision that
  // an f32 output would show (bf16 outputs round it away)
  float acc[WM][WN][4], part[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<BM>(sq + s * kBK * kQStride, sx + s * BM * kXStride, x, q, M, N, K, k_end, m0,
                     n0, k_begin + s * kBK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt arrived; stage kt - 1 is free again
    const int pf = kt + STAGES - 1;
    if (pf < nk) {
      const int st = pf % STAGES;
      load_stage<BM>(sq + st * kBK * kQStride, sx + st * BM * kXStride, x, q, M, N, K, k_end,
                     m0, n0, k_begin + pf * kBK, tid);
    }
    cp_async_commit();
    const uint8_t* tq = sq + (kt % STAGES) * kBK * kQStride;
    const __nv_bfloat16* tx = sx + (kt % STAGES) * BM * kXStride;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[WM][4];
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        const __nv_bfloat16* p = tx + ((wm * WM + i) * 16 + g) * kXStride + kk + 2 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kXStride);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kXStride + 8);
      }
      uint32_t b[WN][2];
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const uint8_t* p = tq + (kk + 2 * t) * kQStride + (wn * WN + j) * 8 + g;
        b[j][0] = widen2(p[0], p[kQStride]);
        b[j][1] = widen2(p[8 * kQStride], p[9 * kQStride]);
      }
#pragma unroll
      for (int i = 0; i < WM; ++i)
#pragma unroll
        for (int j = 0; j < WN; ++j) mma_bf16(OUT_F32 ? part[i][j] : acc[i][j], a[i], b[j]);
    }
    if constexpr (OUT_F32) {
#pragma unroll
      for (int i = 0; i < WM; ++i)
#pragma unroll
        for (int j = 0; j < WN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][j][e] += part[i][j][e];
            part[i][j][e] = 0.f;
          }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      const int m = m0 + (wm * WM + i) * 16 + g;
      const int n = n0 + (wn * WN + j) * 8 + 2 * t;
      if (n >= N) continue;  // N % 16 == 0: n + 1 < N too
      if (m < M) store_pair<OUT_F32>(y, work, scale, M, N, m, n, acc[i][j][0], acc[i][j][1]);
      if (m + 8 < M)
        store_pair<OUT_F32>(y, work, scale, M, N, m + 8, n, acc[i][j][2], acc[i][j][3]);
    }
}

// f32 x on the CUDA cores: 16 rows x kBN columns a block, each thread one
// column and 8 rows, k in order within the block's range.
__global__ void __launch_bounds__(kThreads)
    int8_simt_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                     const float* __restrict__ scale, float* __restrict__ y,
                     float* __restrict__ work, int M, int N, int K, int kps) {
  constexpr int BM = 16, RPT = 8;
  __shared__ __align__(16) float sx[BM][kBK];
  __shared__ __align__(16) int8_t sq[kBK][kBN];
  const int tid = threadIdx.x, col = tid % kBN, r0 = (tid / kBN) * RPT;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * kps * kBK;
  const int k_end = min(K, k_begin + kps * kBK);
  float acc[RPT] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    for (int c = tid; c < kBK * kBN / 16; c += kThreads) {
      const int r = c / (kBN / 16), cc = (c % (kBN / 16)) * 16;
      const int k = k0 + r, n = n0 + cc;
      int4 v = make_int4(0, 0, 0, 0);
      if (k < k_end && n < N) v = *reinterpret_cast<const int4*>(q + (size_t)k * N + n);
      *reinterpret_cast<int4*>(&sq[r][cc]) = v;
    }
    for (int c = tid; c < BM * kBK / 4; c += kThreads) {
      const int r = c / (kBK / 4), cc = (c % (kBK / 4)) * 4;
      const int m = m0 + r, k = k0 + cc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M && k < k_end) v = *reinterpret_cast<const float4*>(x + (size_t)m * K + k);
      *reinterpret_cast<float4*>(&sx[r][cc]) = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float w = static_cast<float>(sq[kk][col]);
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] = fmaf(sx[r0 + r][kk], w, acc[r]);
    }
    __syncthreads();
  }
  const int n = n0 + col;
  if (n >= N) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int m = m0 + r0 + r;
    if (m >= M) break;
    const size_t off = (size_t)m * N + n;
    if (work != nullptr) work[(size_t)blockIdx.z * M * N + off] = acc[r];
    else y[off] = acc[r] * scale[n];
  }
}

// The split-k sum: partial sums added in split order, then scaled and cast.
template <bool OUT_F32>
__global__ void splitk_sum_kernel(const float* __restrict__ work, const float* __restrict__ scale,
                                  void* __restrict__ y, int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += work[(size_t)z * total + i];
    s *= scale[i % N];
    if (OUT_F32) static_cast<float*>(y)[i] = s;
    else static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(s);
  }
}

template <int BM, int STAGES, bool OUT_F32>
cudaError_t launch_mma(const void* x, const void* q, const float* scale, void* y, float* work,
                       int M, int N, int K, int splits, int kps, cudaStream_t stream) {
  constexpr int smem = STAGES * kBK * kQStride + STAGES * BM * kXStride * 2;
  auto kernel = int8_mma_kernel<BM, STAGES, OUT_F32>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                           static_cast<const int8_t*>(q), scale, y, work, M, N,
                                           K, kps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_dtype: 0 f32 (block_m 16, f32 output), 1 bf16 (block_m 16 or 128).
// work: f32 [splits, M, N] when splits > 1, else null. The wrapper checks
// shapes, dtypes, contiguity and alignment.
int tpx_int8_matmul(const void* x, const void* q, const void* scale, void* y, void* work, int M,
                    int N, int K, int x_dtype, int out_f32, int block_m, int splits, int kps,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* wk = splits > 1 ? static_cast<float*>(work) : nullptr;
  cudaError_t err;
  if (x_dtype == 0) {
    if (!out_f32 || block_m != 16) return (int)cudaErrorInvalidValue;
    dim3 grid((N + kBN - 1) / kBN, (M + 15) / 16, splits);
    int8_simt_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                              static_cast<const int8_t*>(q), sc,
                                              static_cast<float*>(y), wk, M, N, K, kps);
    err = cudaGetLastError();
  } else if (x_dtype == 1 && block_m == 16) {
    err = out_f32 ? launch_mma<16, 4, true>(x, q, sc, y, wk, M, N, K, splits, kps, s)
                  : launch_mma<16, 4, false>(x, q, sc, y, wk, M, N, K, splits, kps, s);
  } else if (x_dtype == 1 && block_m == 128) {
    err = out_f32 ? launch_mma<128, 3, true>(x, q, sc, y, wk, M, N, K, splits, kps, s)
                  : launch_mma<128, 3, false>(x, q, sc, y, wk, M, N, K, splits, kps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || wk == nullptr) return (int)err;
  const size_t chunks = ((size_t)M * N + kThreads - 1) / kThreads;
  const int blocks = (int)(chunks < 4096 ? chunks : 4096);
  if (out_f32) splitk_sum_kernel<true><<<blocks, kThreads, 0, s>>>(wk, sc, y, M, N, splits);
  else splitk_sum_kernel<false><<<blocks, kThreads, 0, s>>>(wk, sc, y, M, N, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
