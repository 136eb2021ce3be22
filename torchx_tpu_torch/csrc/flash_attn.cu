// Flash-attention dq on Hopper's CUDA cores (sm_90a), written by hand in
// CUDA C++: the dq kernel of the two-kernel backward where the wgmma one
// does not reach, f32 at head_dim 64, 128 and 256 and bf16 at 256.
//
// Replaces the Pallas TPU kernel of torchx_tpu/ops/fused.py
//   flash_dq_kernel   <- _flash_dq_kernel  (in _flash_bwd)
// on those routes, and the role of the library splash kernel
// (torchx_tpu/ops/attention.py splash_attention) there: GQA is native, and
// optional segment ids mask packed documents. The forward and dk/dv of these
// routes run on the tensor cores (flash_fwd_mma.cuh, flash_dkv_mma.cuh).
//
// What bounds it on an H100: operations. At the llama3_1b shapes (b=4,
// s=2048, 32 query heads over 8 KV heads, head_dim 64, causal) dq does
// 3*2*b*h*s*s*d/2 = 103 GFLOP over ~90 MB, far above the card's ridge point.
// The bound is the tensor-core rate.
//
// What this design does about it, for now: it keeps the score matrix out of
// device memory (64-wide kv tiles held in shared memory, scores in
// registers), skips fully masked causal tiles, and reads each KV head in
// place at h // n_rep instead of repeating it. The products are plain f32
// FMAs from shared memory (each thread a 4x4 micro-tile, operands stored
// contraction-major so every read is a float4), so the kernel runs at the
// CUDA-core rate, not the tensor-core rate: the mma.sync design of the
// forward and dk/dv is its next step, ordered by the numbers in PERF.md.
//
// Layouts: q, do [b, s, h, d]; k, v [b, s, kvh, d]; dq f32 [b, s, h, d];
// lse, delta f32 [b, h, s]. All contiguous. Element types: float or bf16
// (one type for q, k, v, do); every sum in f32.
//
// Segment ids: seg is int32 [b, s] or null. Given, a query sees only keys
// of its own segment: each kv tile's ids are loaded into shared memory
// beside the tile, a thread's own rows' ids are kept in registers, and every
// element whose ids differ gets kNegInf, on every tile, so its probability
// exp(kNegInf - lse) is 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The "already softmax-dead" logit of torchx_tpu/ops/fused.py NEG_INF.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Square tiles of B query rows by B kv rows. B=64 keeps head_dim 64 and
// 128 inside the 227 KB of shared memory a CTA may use; head_dim 256 takes
// B=32.
template <int D> struct Tile;
template <> struct Tile<64> { static constexpr int B = 64; };
template <> struct Tile<128> { static constexpr int B = 64; };
template <> struct Tile<256> { static constexpr int B = 32; };

template <int D> constexpr int threads() { return (Tile<D>::B / 4) * (Tile<D>::B / 4); }

// Load B rows of D values (rows `stride` elements apart) into shared memory
// transposed, dst[c][r] with row stride B+4, each value times `mul`.
template <typename T, int D, int B, int NT>
__device__ __forceinline__ void load_t(float* dst, const T* src, int stride, float mul, int tid) {
  for (int idx = tid; idx < B * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    dst[c * (B + 4) + r] = to_f(src[(int64_t)r * stride + c]) * mul;
  }
}

// Load B rows of D values into shared memory as they are, dst[r][c].
template <typename T, int D, int B, int NT>
__device__ __forceinline__ void load_n(float* dst, const T* src, int stride, int tid) {
  for (int idx = tid; idx < B * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    dst[r * D + c] = to_f(src[(int64_t)r * stride + c]);
  }
}

// acc[i][j] += sum_k A[k][r0+i] * Bm[k][c0+j] for k < K; A and Bm have row
// stride B+4 (contraction-major, so both reads are float4).
template <int B, int K>
__device__ __forceinline__ void mm_tile(float (&acc)[4][4], const float* A, const float* Bm,
                                        int r0, int c0) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(A + k * (B + 4) + r0);
    const float4 b = *reinterpret_cast<const float4*>(Bm + k * (B + 4) + c0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][m*4+j] += sum_k A[k][r0+i] * V[k][c0 + m*B + j] for k < B, where A
// has row stride B+4 and V row stride ldv: the accumulation of a [B, B]
// probability-like tile into a thread's 4 rows x (NCH*4) columns of output.
template <int B, int NCH>
__device__ __forceinline__ void mm_acc(float (&acc)[4][NCH * 4], const float* A, const float* V,
                                       int ldv, int r0, int c0) {
#pragma unroll 4
  for (int k = 0; k < B; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(A + k * (B + 4) + r0);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int m = 0; m < NCH; ++m) {
      const float4 v = *reinterpret_cast<const float4*>(V + k * ldv + c0 + m * B);
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][m * 4 + j] = fmaf(av[i], vv[j], acc[i][m * 4 + j]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq: one CTA per (q tile, batch*head); kv tiles in a loop.
//   p = exp(q k^T * scale - lse), ds = p * (do v^T - delta), dq = ds k * scale
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(threads<D>())
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ seg,
                float* __restrict__ dq, int S, int H, int KVH, float scale, int causal) {
  constexpr int B = Tile<D>::B, TX = B / 4, NT = TX * TX, P = B + 4, NCH = D / B;
  extern __shared__ __align__(16) float smem[];
  float* QT = smem;          // [D][P]  q * scale, transposed
  float* DOT = QT + D * P;   // [D][P]  do, transposed
  float* KT = DOT + D * P;   // [D][P]  k, transposed
  float* VT = KT + D * P;    // [D][P]  v, transposed
  float* Kn = VT + D * P;    // [B][D]  k
  float* DST = Kn + B * D;   // [B][P]  ds, transposed
  int* KS = reinterpret_cast<int*>(DST + B * P);  // [B] the kv tile's segment ids

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int r0 = ty * 4, c0 = tx * 4;
  const int nq = S / B;
  const int qt = nq - 1 - blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / (H / KVH);
  const int qs = H * D, ks = KVH * D;

  const int64_t q_off = ((int64_t)b * S + qt * B) * qs + h * D;
  load_t<T, D, B, NT>(QT, q + q_off, qs, scale, tid);
  load_t<T, D, B, NT>(DOT, dout + q_off, qs, 1.f, tid);
  float lse_r[4], delta_r[4], acc[4][NCH * 4];
  int qid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = ((int64_t)b * H + h) * S + qt * B + r0 + i;
    qid[i] = seg ? seg[(int64_t)b * S + qt * B + r0 + i] : 0;
    lse_r[i] = lse[row];
    delta_r[i] = delta[row];
#pragma unroll
    for (int c = 0; c < NCH * 4; ++c) acc[i][c] = 0.f;
  }

  const int nk = causal ? qt + 1 : S / B;
  for (int kt = 0; kt < nk; ++kt) {
    const int64_t kv_off = ((int64_t)b * S + kt * B) * ks + hk * D;
    load_t<T, D, B, NT>(KT, k + kv_off, ks, 1.f, tid);
    load_t<T, D, B, NT>(VT, v + kv_off, ks, 1.f, tid);
    load_n<T, D, B, NT>(Kn, k + kv_off, ks, tid);
    if (seg)
      for (int r = tid; r < B; r += NT) KS[r] = seg[(int64_t)b * S + kt * B + r];
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    mm_tile<B, D>(s, QT, KT, r0, c0);
    mm_tile<B, D>(dp, DOT, VT, r0, c0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool masked =
            (causal && kt == qt && c0 + j > r0 + i) || (seg && KS[c0 + j] != qid[i]);
        const float sij = masked ? kNegInf : s[i][j];
        const float p = expf(sij - lse_r[i]);
        DST[(c0 + j) * P + r0 + i] = p * (dp[i][j] - delta_r[i]);
      }
    __syncthreads();
    mm_acc<B, NCH>(acc, DST, Kn, D, r0, c0);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = dq + ((int64_t)b * S + qt * B + r0 + i) * qs + h * D;
#pragma unroll
    for (int mm = 0; mm < NCH; ++mm)
#pragma unroll
      for (int j = 0; j < 4; ++j) row[c0 + mm * B + j] = acc[i][mm * 4 + j] * scale;
  }
}

template <int D> constexpr size_t dq_smem() {
  constexpr int B = Tile<D>::B, P = B + 4;
  return sizeof(float) * (4 * D * P + B * D + B * P) + sizeof(int) * B;
}

// Raise the dynamic shared-memory cap of a kernel once, then launch it.
template <typename K, typename... Args>
cudaError_t launch(K kernel, dim3 grid, int nthreads, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, nthreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dq_d(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dq, const void* seg, int B, int S, int H, int KVH,
                 int causal, cudaStream_t st) {
  dim3 grid(S / Tile<D>::B, B * H);
  return launch(flash_dq_kernel<T, D>, grid, threads<D>(), dq_smem<D>(), st, (const T*)q,
                (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
                (const float*)delta, (const int*)seg, (float*)dq, S, H, KVH,
                (float)(1.0 / sqrt((double)D)),
                causal);
}

// dtype: 0 = float32, 1 = bfloat16
#define TPX_DISPATCH(FN, ...)                                              \
  switch (dtype * 1000 + D) {                                              \
    case 64: return (int)FN<float, 64>(__VA_ARGS__);                       \
    case 128: return (int)FN<float, 128>(__VA_ARGS__);                     \
    case 256: return (int)FN<float, 256>(__VA_ARGS__);                     \
    case 1064: return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__);             \
    case 1128: return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__);            \
    case 1256: return (int)FN<__nv_bfloat16, 256>(__VA_ARGS__);            \
    default: return (int)cudaErrorInvalidValue;                            \
  }

}  // namespace

extern "C" {

// The wrapper checks shapes, dtypes and contiguity; S must be a multiple of
// 64 (of 32 at head_dim 256) and H a multiple of KVH. seg: int32 [B, S]
// segment ids, or null for none.
int tpx_flash_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dq, const void* seg, int B, int S, int H, int KVH,
                 int D, int causal, int dtype, void* stream) {
  TPX_DISPATCH(dq_d, q, k, v, dout, lse, delta, dq, seg, B, S, H, KVH, causal,
               (cudaStream_t)stream)
}

const char* tpx_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
