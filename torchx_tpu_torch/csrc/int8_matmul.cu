// The int8-weight matmul of weight-only serving, for Hopper (sm_90a):
//
//     y[m, n] = (sum_k x[m, k] * q[k, n]) * scale[n]
//
// x bf16 or f32 [M, K] row-major; q int8 [K, N] row-major (the JAX layout,
// [in, out]); scale f32 [N], applied after the f32 sum (never folded into
// the weights); y in x's dtype or f32 (the lm head's logits; always f32 for
// f32 x).
//
// Replaces torchx_tpu/ops/quant.py int8_matmul, which is no Pallas kernel:
// the JAX package writes dot_general(x, q, preferred_element_type=f32) *
// scale and XLA lowers it to a mixed-input product. PyTorch has no int8 x
// bf16 product on CUDA, and widening q to bf16 before cuBLAS would write and
// reread a bf16 copy of every weight.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s), and the two
// paths the wrapper (ops/quant.py launch_plan) picks between by the call's
// shape (above 16 rows the wgmma kernel, unless its k splits would be
// short):
//
// * prefill, M = a chunk's rows: operations, but the tiles' reads from L2
//   come close: every x tile is read once per column tile and every q tile
//   once per row tile (at 256 x 128 tiles a 2048 x 4096 x 4096 call moves
//   640 MB from L2 into shared memory for 0.07 ms of operations).
//   int8_wgmma_kernel: 256 x 128 output tiles (128 x 128 for f32 outputs
//   and for calls of 128 rows or fewer), a producer warp that keeps a
//   4-stage TMA ring full (x [256 x 64] bf16 in the 128-byte swizzle wgmma
//   reads, q [64 x 128] int8, full / empty mbarriers) and four consumer
//   warpgroups of 64 rows (two for 128-row tiles). The consumers widen each int8 tile once per
//   block, not once per warp: into bf16 in shared memory, in the MN-major
//   128-byte-swizzled layout that wgmma reads as B, with packed conversions
//   (widen_pair: a byte permute, two masks, one bf16x2 fma per pair, no
//   cvt), then run m64n128k16 wgmma with both operands in shared memory.
//   Four warpgroups share one widened tile, which halves both the widening
//   per product and q's reads from L2 against 128-row tiles. Three widened
//   tiles rotate, so that one stage's wgmma runs while the next stage is
//   widened. bf16 outputs accumulate in the tensor cores; f32 outputs (the
//   lm head) take each stage's products in a fresh accumulator and add it
//   to the running sum with CUDA-core adds: the tensor cores' own f32
//   accumulation over a long k chain (14336) loses precision that an f32
//   output would show.
// * decode, M = the busy slots: bytes. A llama3_8b step reads 7.5 GB of
//   int8 projections, 2.2 ms at 3.35 TB/s, at 2 operations per weight byte
//   and row. int8_decode_kernel: 16-row blocks, 8 warps on mma.sync
//   m16n8k16, a 4-stage ring of 16-byte cp.async loads (neighbouring
//   threads on neighbouring n). The output tiles alone would leave most of
//   the 132 SMs idle, so the k range is split across blocks (the wrapper
//   picks the split, about two blocks an SM).
// * f32 x (a config whose activations are f32, served --int8): bytes, as
//   the bf16 decode path. int8_tf32_kernel: the decode kernel's structure
//   (16-row blocks, 8 warps, the 4-stage cp.async ring, split k) on
//   mma.sync m16n8k8 TF32. An int8 weight is exact in TF32 (|q| <= 127
//   needs 7 of its 11 significant bits), so only x is split, into TF32
//   hi + lo (hopper.cuh split_tf32): x_hi q + x_lo q, two products, give
//   what the three of an f32 x f32 product would (lo * lo and lo's
//   rounding cost ~2**-21 of each product). The block splits each stage's
//   x tile once in shared memory (the eight warps read the same A
//   fragments), and a weight byte becomes its float by an integer add and
//   a float subtract (no conversion instruction). Each stage's products go
//   into a fresh accumulator added to the running sum with CUDA-core adds,
//   as for the decode kernel's f32 outputs.
//
// Split k, on every path, in one launch: each split writes its f32
// partial sums to a workspace ([splits, M, N]) and counts itself in on its
// tile's counter (__threadfence, then atomicAdd on an int); the last block
// of the tile adds the partials in split order 0..S-1, scales, casts,
// stores and sets the counter back to 0 for the next call on the stream.
// No float atomics: the result is bitwise the same in every run. The
// wrapper holds the workspace and counters per (device, stream).
//
// A persistent schedule and thread-block clusters (one TMA load of x
// feeding two N tiles) are later work.
//
// TPX_INT8_ABLATE, for timing the wgmma kernel's parts only (chip_smoke.py
// --phases build,int8parts builds this file apart with it): 1 skips the
// widening, 2 the products, 3 both. The library the port loads never sets
// it, and an ablated kernel's output is meaningless.
//
// Offsets are 64-bit: the lm head's K * N (525 M) and a prefill's M * N
// (2048 x 128256) come close to int32's range. K needs no multiple of the
// tile (rows past the end read as zero); the wrapper checks K % 8 == 0 and
// N % 16 == 0 (16-byte rows) and 16-byte aligned pointers.

#include <map>
#include <mutex>
#include <tuple>

#include "hopper.cuh"

#ifndef TPX_INT8_ABLATE
#define TPX_INT8_ABLATE 0
#endif

namespace {

using namespace tpx;
using bf16 = __nv_bfloat16;

constexpr int kBN = 128;  // output columns per block, every path
constexpr int kBK = 64;   // k rows per stage

// ---------------------------------------------------------------------------
// int8 -> bf16, packed
// ---------------------------------------------------------------------------

// p holds two int8 values in bytes 0 and 2 (bytes 1 and 3 are ignored).
// -> their bf16x2, exactly. Under the exponent of 128 each 16-bit lane
// makes a = 128 + (q & 127) and c = 128 + (q & 128) (256 when the sign bit
// is set); a - c is q in two's complement, and one packed fma computes it
// exactly (|q| <= 128 is a bf16 number).
__device__ __forceinline__ uint32_t widen_pair(uint32_t p) {
  const uint32_t a = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (p & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(c), "r"(0xBF80BF80u), "r"(a));
  return d;
}

// 4 int8 (one 32-bit word, lowest byte first) -> 2 bf16x2 in order.
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  lo = widen_pair(__byte_perm(w, 0, 0x0100));
  hi = widen_pair(__byte_perm(w, 0, 0x0302));
}

// ---------------------------------------------------------------------------
// the split-k tail
// ---------------------------------------------------------------------------

// The final value of a pair (columns n, n + 1 of row m): sum * scale, cast.
template <bool OUT_F32>
__device__ __forceinline__ void store_out2(void* __restrict__ y, const float* __restrict__ scale,
                                           int N, int m, int n, float v0, float v1) {
  const float2 s = *reinterpret_cast<const float2*>(scale + n);
  const size_t off = (size_t)m * N + n;
  if (OUT_F32)
    *reinterpret_cast<float2*>(static_cast<float*>(y) + off) = make_float2(v0 * s.x, v1 * s.y);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(y) + off) =
        __floats2bfloat162_rn(v0 * s.x, v1 * s.y);
}

// A pair of partial sums of split blockIdx.z.
__device__ __forceinline__ void store_part2(float* __restrict__ work, int M, int N, int m, int n,
                                            float v0, float v1) {
  *reinterpret_cast<float2*>(work + (size_t)blockIdx.z * M * N + (size_t)m * N + n) =
      make_float2(v0, v1);
}

// Called by every thread that stored partials, sync() being a barrier over
// exactly those threads. -> whether this block is the last of its tile's
// splits to arrive; that block resets the tile's counter.
template <typename Sync>
__device__ __forceinline__ bool arrive_last(int* __restrict__ counters, int tile, bool leader,
                                            int* flag, Sync sync) {
  __threadfence();  // this thread's partials before the count
  sync();
  if (leader) {
    *flag = atomicAdd(counters + tile, 1) == (int)gridDim.z - 1;
    if (*flag) counters[tile] = 0;  // no other block of this launch touches it again
  }
  sync();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// The last block's sum over the splits, in split order, for rows
// [m0, m0 + rows) x columns [n0, n0 + kBN): read past L1 (ld.cg), scaled,
// cast, stored four columns at a time.
template <bool OUT_F32>
__device__ void reduce_tile(const float* __restrict__ work, const float* __restrict__ scale,
                            void* __restrict__ y, int M, int N, int m0, int rows, int n0, int tid,
                            int nthreads) {
  const size_t mn = (size_t)M * N;
  const int splits = gridDim.z;
  for (int i = tid; i < rows * (kBN / 4); i += nthreads) {
    const int m = m0 + i / (kBN / 4), n = n0 + (i % (kBN / 4)) * 4;
    if (m >= M || n >= N) continue;  // N % 16 == 0: all four columns or none
    const float* w = work + (size_t)m * N + n;
    float4 s = __ldcg(reinterpret_cast<const float4*>(w));
#pragma unroll 4
    for (int z = 1; z < splits; ++z) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(w + z * mn));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const float4 c = *reinterpret_cast<const float4*>(scale + n);
    s = make_float4(s.x * c.x, s.y * c.y, s.z * c.z, s.w * c.w);
    const size_t off = (size_t)m * N + n;
    if (OUT_F32) {
      *reinterpret_cast<float4*>(static_cast<float*>(y) + off) = s;
    } else {
      const __nv_bfloat162 a = __floats2bfloat162_rn(s.x, s.y), b = __floats2bfloat162_rn(s.z, s.w);
      *reinterpret_cast<uint2*>(static_cast<bf16*>(y) + off) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
    }
  }
}

// ---------------------------------------------------------------------------
// decode: mma.sync on 16-row blocks
// ---------------------------------------------------------------------------

constexpr int kDecBM = 16;
constexpr int kDecStages = 4;
constexpr int kDecThreads = 256;    // 8 warps side by side, 16 columns each
constexpr int kQStride = kBN + 16;  // bytes per q tile row in shared memory
constexpr int kXStride = kBK + 8;   // elements per bf16 x tile row (144 bytes)
constexpr int kDecSmem = kDecStages * kBK * kQStride + kDecStages * kDecBM * kXStride * 2;
static_assert(kDecSmem <= 48 * 1024, "the decode ring fits the default shared-memory cap");
// f32 x rows of 68 floats (272 bytes): the TF32 A fragment's reads, rows g
// and columns c of a k8 block, fall on 32 distinct banks. The ring's x
// tiles, then one tile for the lo half of the stage in use.
constexpr int kTfStride = kBK + 4;
constexpr int kTfSmem = kDecStages * kBK * kQStride + (kDecStages + 1) * kDecBM * kTfStride * 4;
static_assert(3 * (kTfSmem + 1024) <= 228 * 1024, "three TF32 blocks an SM (ops/quant.py)");

// 16 bytes global -> shared, zero-filled when !valid (src then unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7},"
      " {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One stage: q rows [k0, k0 + kBK) x columns [n0, n0 + kBN), and x rows
// [m0, m0 + kDecBM) x the same k (bf16 or f32, XS elements a row in
// shared memory), each as 16-byte chunks; rows at or past k_end (the
// split's end) or M, and columns past N, are zero-filled.
template <typename X, int XS>
__device__ __forceinline__ void load_stage(uint8_t* sq, X* sx, const X* __restrict__ x,
                                           const int8_t* __restrict__ q, int M, int N, int K,
                                           int k_end, int m0, int n0, int k0, int tid) {
  constexpr int kPer = 16 / sizeof(X);  // x elements a chunk
#pragma unroll
  for (int c = tid; c < kBK * kBN / 16; c += kDecThreads) {
    const int r = c / (kBN / 16), col = (c % (kBN / 16)) * 16;
    const int k = k0 + r, n = n0 + col;
    const bool ok = k < k_end && n < N;
    cp_async16(sq + r * kQStride + col, ok ? q + (size_t)k * N + n : q, ok);
  }
  for (int c = tid; c < kDecBM * kBK / kPer; c += kDecThreads) {
    const int r = c / (kBK / kPer), col = (c % (kBK / kPer)) * kPer;
    const int m = m0 + r, k = k0 + col;
    const bool ok = m < M && k < k_end;
    cp_async16(sx + r * XS + col, ok ? x + (size_t)m * K + k : x, ok);
  }
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z): rows 16 blockIdx.x, columns
// kBN blockIdx.y, k steps [blockIdx.z * kps, ...) of kBK rows. Warp w owns
// columns 16w..16w+15 (two n8 tiles).
template <bool OUT_F32>
__global__ void __launch_bounds__(kDecThreads)
    int8_decode_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ scale, void* __restrict__ y,
                       float* __restrict__ work, int* __restrict__ counters, int M, int N, int K,
                       int kps) {
  constexpr int WN = 2;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last_flag;
  uint8_t* sq = smem;
  bf16* sx = reinterpret_cast<bf16*>(smem + kDecStages * kBK * kQStride);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * kDecBM, n0 = blockIdx.y * kBN;
  const int k_begin = blockIdx.z * kps * kBK;
  const int k_end = min(K, k_begin + kps * kBK);
  const int nk = (k_end - k_begin + kBK - 1) / kBK;

  // f32 outputs keep one stage's tensor-core sums apart (part) and add
  // them into acc with CUDA-core adds (see the note at the top)
  float acc[WN][4], part[WN][4];
#pragma unroll
  for (int j = 0; j < WN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < nk)
      load_stage<bf16, kXStride>(sq + s * kBK * kQStride, sx + s * kDecBM * kXStride, x, q, M,
                                 N, K, k_end, m0, n0, k_begin + s * kBK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();  // stage kt arrived; stage kt - 1 is free again
    const int pf = kt + kDecStages - 1;
    if (pf < nk) {
      const int st = pf % kDecStages;
      load_stage<bf16, kXStride>(sq + st * kBK * kQStride, sx + st * kDecBM * kXStride, x, q, M,
                                 N, K, k_end, m0, n0, k_begin + pf * kBK, tid);
    }
    cp_async_commit();
    const uint8_t* tq = sq + (kt % kDecStages) * kBK * kQStride;
    const bf16* tx = sx + (kt % kDecStages) * kDecBM * kXStride;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4];
      const bf16* p = tx + g * kXStride + kk + 2 * t;
      a[0] = *reinterpret_cast<const uint32_t*>(p);
      a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * kXStride);
      a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * kXStride + 8);
      uint32_t b[WN][2];
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        // rows k, k + 1 (and k + 8, k + 9) of column n: one byte each,
        // permuted into a pair's lanes, then widened together
        const uint8_t* r = tq + (kk + 2 * t) * kQStride + (warp * WN + j) * 8 + g;
        b[j][0] = widen_pair(__byte_perm(r[0], r[kQStride], 0x0400));
        b[j][1] = widen_pair(__byte_perm(r[8 * kQStride], r[9 * kQStride], 0x0400));
      }
#pragma unroll
      for (int j = 0; j < WN; ++j) mma_bf16(OUT_F32 ? part[j] : acc[j], a, b[j]);
    }
    if constexpr (OUT_F32) {
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j][e] += part[j][e];
          part[j][e] = 0.f;
        }
    }
  }
  cp_async_wait<0>();

  const bool split = gridDim.z > 1;
  const int m = m0 + g;
#pragma unroll
  for (int j = 0; j < WN; ++j) {
    const int n = n0 + (warp * WN + j) * 8 + 2 * t;
    if (n >= N) continue;  // N % 16 == 0: n + 1 < N too
    if (split) {
      if (m < M) store_part2(work, M, N, m, n, acc[j][0], acc[j][1]);
      if (m + 8 < M) store_part2(work, M, N, m + 8, n, acc[j][2], acc[j][3]);
    } else {
      if (m < M) store_out2<OUT_F32>(y, scale, N, m, n, acc[j][0], acc[j][1]);
      if (m + 8 < M) store_out2<OUT_F32>(y, scale, N, m + 8, n, acc[j][2], acc[j][3]);
    }
  }
  if (split && arrive_last(counters, blockIdx.x + gridDim.x * blockIdx.y, tid == 0, &last_flag,
                           [] { __syncthreads(); }))
    reduce_tile<OUT_F32>(work, scale, y, M, N, m0, kDecBM, n0, tid, kDecThreads);
}

// ---------------------------------------------------------------------------
// f32 x: TF32 mma.sync on 16-row blocks
// ---------------------------------------------------------------------------

// An int8 value as its float, exactly: 1.5 * 2**23 + q has the float bits
// 0x4B400000 + q (its unit in the last place is 1), less 1.5 * 2**23.
__device__ __forceinline__ uint32_t int8_as_tf32(int8_t q) {
  return __float_as_uint(__int_as_float(0x4B400000 + q) - 12582912.f);
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z) as int8_decode_kernel's; warp
// w owns columns 16w..16w+15 (two n8 tiles). Per k8 step the A fragment
// is x rows g and g + 8 at columns c and c + 4, as TF32 hi and lo; the B
// fragment, q rows c and c + 4 of column g, is the int8 value as a float,
// exact in TF32.
__global__ void __launch_bounds__(kDecThreads, 3)
    int8_tf32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                     const float* __restrict__ scale, float* __restrict__ y,
                     float* __restrict__ work, int* __restrict__ counters, int M, int N, int K,
                     int kps) {
  constexpr int WN = 2;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last_flag;
  uint8_t* sq = smem;
  float* sx = reinterpret_cast<float*>(smem + kDecStages * kBK * kQStride);
  float* sx_lo = sx + kDecStages * kDecBM * kTfStride;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * kDecBM, n0 = blockIdx.y * kBN;
  const int k_begin = blockIdx.z * kps * kBK;
  const int k_end = min(K, k_begin + kps * kBK);
  const int nk = (k_end - k_begin + kBK - 1) / kBK;
  static_assert(kDecBM * kBK == 4 * kDecThreads, "a thread splits four x values a stage");
  const int xr = tid / (kBK / 4), xc = (tid % (kBK / 4)) * 4;  // this thread's four

  float acc[WN][4], part[WN][4];
#pragma unroll
  for (int j = 0; j < WN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < nk)
      load_stage<float, kTfStride>(sq + s * kBK * kQStride, sx + s * kDecBM * kTfStride, x, q,
                                   M, N, K, k_end, m0, n0, k_begin + s * kBK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();  // stage kt arrived; stage kt - 1 is free again
    const int pf = kt + kDecStages - 1;
    if (pf < nk) {
      const int st = pf % kDecStages;
      load_stage<float, kTfStride>(sq + st * kBK * kQStride, sx + st * kDecBM * kTfStride, x, q,
                                   M, N, K, k_end, m0, n0, k_begin + pf * kBK, tid);
    }
    cp_async_commit();
    const uint8_t* tq = sq + (kt % kDecStages) * kBK * kQStride;
    float* tx = sx + (kt % kDecStages) * kDecBM * kTfStride;
    {
      // split the stage's x tile: hi in place, lo into sx_lo (the warps
      // left the last stage's sx_lo before the barrier above)
      float4* hi = reinterpret_cast<float4*>(tx + xr * kTfStride + xc);
      const float4 v = *hi;
      uint32_t h[4], l[4];
      split_tf32(v.x, h[0], l[0]);
      split_tf32(v.y, h[1], l[1]);
      split_tf32(v.z, h[2], l[2]);
      split_tf32(v.w, h[3], l[3]);
      *hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                        __uint_as_float(h[3]));
      *reinterpret_cast<float4*>(sx_lo + xr * kTfStride + xc) =
          make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                      __uint_as_float(l[3]));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      const int o = g * kTfStride + kk + t;  // rows g, g + 8; columns t, t + 4
      const uint32_t ah[4] = {__float_as_uint(tx[o]), __float_as_uint(tx[o + 8 * kTfStride]),
                              __float_as_uint(tx[o + 4]),
                              __float_as_uint(tx[o + 8 * kTfStride + 4])};
      const uint32_t al[4] = {__float_as_uint(sx_lo[o]),
                              __float_as_uint(sx_lo[o + 8 * kTfStride]),
                              __float_as_uint(sx_lo[o + 4]),
                              __float_as_uint(sx_lo[o + 8 * kTfStride + 4])};
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const int8_t* r =
            reinterpret_cast<const int8_t*>(tq + (kk + t) * kQStride + (warp * WN + j) * 8 + g);
        const uint32_t b[2] = {int8_as_tf32(r[0]), int8_as_tf32(r[4 * kQStride])};
        mma_m16n8k8_tf32(part[j], al, b);
        mma_m16n8k8_tf32(part[j], ah, b);
      }
    }
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][e] += part[j][e];
        part[j][e] = 0.f;
      }
  }
  cp_async_wait<0>();

  const bool split = gridDim.z > 1;
  const int m = m0 + g;
#pragma unroll
  for (int j = 0; j < WN; ++j) {
    const int n = n0 + (warp * WN + j) * 8 + 2 * t;
    if (n >= N) continue;  // N % 16 == 0: n + 1 < N too
    if (split) {
      if (m < M) store_part2(work, M, N, m, n, acc[j][0], acc[j][1]);
      if (m + 8 < M) store_part2(work, M, N, m + 8, n, acc[j][2], acc[j][3]);
    } else {
      if (m < M) store_out2<true>(y, scale, N, m, n, acc[j][0], acc[j][1]);
      if (m + 8 < M) store_out2<true>(y, scale, N, m + 8, n, acc[j][2], acc[j][3]);
    }
  }
  if (split && arrive_last(counters, blockIdx.x + gridDim.x * blockIdx.y, tid == 0, &last_flag,
                           [] { __syncthreads(); }))
    reduce_tile<true>(work, scale, y, M, N, m0, kDecBM, n0, tid, kDecThreads);
}

// ---------------------------------------------------------------------------
// prefill: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kStages = 4;
constexpr int kWide = 3;  // widened tiles: stage kt writes kt % 3 while kt - 1's wgmma reads

// WGS consumer warpgroups of 64 rows each: 4 (256-row tiles) for bf16
// outputs of more than 128 rows (64 accumulator registers a thread; 544
// threads leave 120 each), else 2 (f32 outputs hold a second accumulator;
// at 128 rows or fewer a 256-row tile would compute as many padding rows).
template <int WGS>
struct PrefillSmem {
  static constexpr int kBM = 64 * WGS;
  bf16 x[kStages][kBM * kBK];    // [BM][64], 128-byte swizzle (TMA); 1024-aligned
  int8_t q[kStages][kBK * kBN];  // [64][128], plain rows (TMA); 8 KB
  bf16 w[kWide][kBK * kBN];      // widened q: [2][64][64], 128-byte swizzle; 16 KB
  uint64_t full[kStages], empty[kStages];
};

// Block (blockIdx.x, blockIdx.y, blockIdx.z): rows BM blockIdx.x (the
// fastest index, so that the blocks in flight share q's columns in L2),
// columns kBN blockIdx.y, k steps [blockIdx.z * kps, ...) of kBK rows.
template <int WGS, bool OUT_F32>
__global__ void __launch_bounds__(128 * WGS + 32, 1)
    int8_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tq,
                      const float* __restrict__ scale, void* __restrict__ y,
                      float* __restrict__ work, int* __restrict__ counters, int M, int N, int K,
                      int kps) {
  static_assert(WGS == 2 || (WGS == 4 && !OUT_F32), "f32 outputs fit two warpgroups");
  constexpr int kBM = 64 * WGS;
  constexpr int kConsumers = 128 * WGS;
  using Smem = PrefillSmem<WGS>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1024(smem_raw));
  __shared__ int last_flag;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int k_begin = blockIdx.z * kps * kBK;
  const int nk = (min(K, k_begin + kps * kBK) - k_begin + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warp: one lane refills a stage once every consumer
    // thread has released it (empty); TMA completes on the stage's full
    // barrier, counting the whole box (rows past M or K read as zero)
    if (tid == kConsumers) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) mbar_wait(&sm.empty[st], (kt / kStages - 1) & 1);
        mbar_expect_tx(&sm.full[st], kBM * kBK * 2 + kBK * kBN);
        const int k0 = k_begin + kt * kBK;
        tma_load_2d(sm.x[st], &tx, &sm.full[st], k0, m0);
        tma_load_2d(sm.q[st], &tq, &sm.full[st], n0, k0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg + [0, 64)
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  float acc[64];
  float part[OUT_F32 ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kStages;
    bf16* wt = sm.w[kt % kWide];
    mbar_wait(&sm.full[st], (kt / kStages) & 1);

    // widen: this thread's 16-byte int8 chunks c = tid + i * kConsumers of
    // the stage's 512 (row k = c / 8, columns 16 j.. with j = c % 8) into
    // column block j / 4, row k, 16-byte chunks 2 (j % 4) and 2 (j % 4) + 1,
    // each swizzled to chunk ^ (k % 8). The upper column block stores its
    // odd chunk first, so that the 8 threads of a row hit 8 bank groups.
#pragma unroll
    for (int h = 0; h < (TPX_INT8_ABLATE & 1 ? 0 : kBK * kBN / 16 / kConsumers); ++h) {
      const int c = tid + h * kConsumers, k = c >> 3, j = c & 7;
      const uint4 v = *reinterpret_cast<const uint4*>(sm.q[st] + k * kBN + 16 * j);
      uint4 lo, hi;
      widen4(v.x, lo.x, lo.y);
      widen4(v.y, lo.z, lo.w);
      widen4(v.z, hi.x, hi.y);
      widen4(v.w, hi.z, hi.w);
      uint8_t* row = reinterpret_cast<uint8_t*>(wt) + (j >> 2) * (kBK * 128) + k * 128;
      const int c0 = 2 * (j & 3), f = j >> 2;
      *reinterpret_cast<uint4*>(row + (((c0 + f) ^ (k & 7)) << 4)) = f ? hi : lo;
      *reinterpret_cast<uint4*>(row + (((c0 + 1 - f) ^ (k & 7)) << 4)) = f ? lo : hi;
    }
    fence_proxy_async();
    named_barrier(1, kConsumers);

    const bf16* xt = sm.x[st] + wg * 64 * kBK;
    if constexpr (OUT_F32) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss_bt(part, desc_sw128(xt + kk * 16, 16, 1024),
                    desc_sw128(wt + kk * 16 * 64, kBK * 128, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
      mbar_arrive(&sm.empty[st]);
    } else {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < (TPX_INT8_ABLATE & 2 ? 0 : kBK / 16); ++kk)
        wgmma_ss_bt(acc, desc_sw128(xt + kk * 16, 16, 1024),
                    desc_sw128(wt + kk * 16 * 64, kBK * 128, 1024), 1);
      wgmma_commit();
      // keep this stage's products in flight while the next is widened;
      // the stage before is done: release its x and q tiles
      wgmma_wait<1>();
      fence_regs(acc);
      if (kt > 0) mbar_arrive(&sm.empty[(kt - 1) % kStages]);
    }
  }
  if constexpr (!OUT_F32) {
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // acc[4j + {0, 1}]: row `row`, columns col + 8j + {0, 1}; acc[4j + {2, 3}]: row + 8
  const int row = m0 + wg * 64 + warp * 16 + lane / 4;
  const int col = n0 + 2 * (lane % 4);
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int n = col + 8 * j;
    if (n >= N) continue;  // N % 16 == 0: n + 1 < N too
    if (split) {
      if (row < M) store_part2(work, M, N, row, n, acc[4 * j], acc[4 * j + 1]);
      if (row + 8 < M) store_part2(work, M, N, row + 8, n, acc[4 * j + 2], acc[4 * j + 3]);
    } else {
      if (row < M) store_out2<OUT_F32>(y, scale, N, row, n, acc[4 * j], acc[4 * j + 1]);
      if (row + 8 < M) store_out2<OUT_F32>(y, scale, N, row + 8, n, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  if (split && arrive_last(counters, blockIdx.x + gridDim.x * blockIdx.y, tid == 0, &last_flag,
                           [] { named_barrier(1, kConsumers); }))
    reduce_tile<OUT_F32>(work, scale, y, M, N, m0, kBM, n0, tid, kConsumers);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// The weight's tensor map, cached by (pointer, K, N): a map holds nothing
// else, so a pointer reused at the same shape finds a map that is right.
cudaError_t weight_map(CUtensorMap* out, const void* q, int K, int N) {
  static std::mutex mu;
  static std::map<std::tuple<uintptr_t, int, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(reinterpret_cast<uintptr_t>(q), K, N);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it == cache.end()) {
    CUtensorMap map;
    const cudaError_t err = make_2d_map(&map, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, kBK, kBN,
                                        CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
    if (cache.size() >= 4096) cache.clear();
    it = cache.emplace(key, map).first;
  }
  *out = it->second;
  return cudaSuccess;
}

// Raise a kernel's shared-memory cap once per (kernel, device).
cudaError_t smem_cap(const void* kernel, int smem) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, bool> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({kernel, dev})) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done[{kernel, dev}] = true;
  return err;
}

template <int WGS, bool OUT_F32>
cudaError_t launch_wgmma(const void* x, const void* q, const float* scale, void* y, float* work,
                         int* counters, int M, int N, int K, int splits, int kps,
                         cudaStream_t stream) {
  constexpr int kBM = 64 * WGS;
  CUtensorMap tx, tq;
  cudaError_t err = make_2d_map(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, kBM, kBK,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  if ((err = weight_map(&tq, q, K, N)) != cudaSuccess) return err;
  constexpr int smem = sizeof(PrefillSmem<WGS>) + 1024;
  if ((err = smem_cap((const void*)int8_wgmma_kernel<WGS, OUT_F32>, smem)) != cudaSuccess)
    return err;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, splits);
  int8_wgmma_kernel<WGS, OUT_F32><<<grid, 128 * WGS + 32, smem, stream>>>(
      tx, tq, scale, y, work, counters, M, N, K, kps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// path: 0 f32 x (TF32 mma.sync, f32 output, 16-row blocks), 1 bf16 x on the
// decode kernel (16-row blocks), 2 bf16 x on the wgmma kernel (block_m 128,
// or 256 for bf16 output). work: f32 [splits, M, N] and counters: int32,
// one per output tile, all 0, when splits > 1 (else may be null). The
// wrapper checks shapes, dtypes, contiguity and alignment.
int tpx_int8_matmul(const void* x, const void* q, const void* scale, void* y, void* work,
                    void* counters, int M, int N, int K, int path, int block_m, int out_f32,
                    int splits, int kps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* wk = static_cast<float*>(work);
  int* ct = static_cast<int*>(counters);
  if (splits < 1 || (splits > 1 && (wk == nullptr || ct == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto xb = static_cast<const bf16*>(x);
  const auto qb = static_cast<const int8_t*>(q);
  if (path == 0) {
    if (!out_f32 || block_m != kDecBM) return (int)cudaErrorInvalidValue;
    const cudaError_t err = smem_cap((const void*)int8_tf32_kernel, kTfSmem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((M + kDecBM - 1) / kDecBM, (N + kBN - 1) / kBN, splits);
    int8_tf32_kernel<<<grid, kDecThreads, kTfSmem, s>>>(static_cast<const float*>(x), qb, sc,
                                                        static_cast<float*>(y), wk, ct, M, N,
                                                        K, kps);
  } else if (path == 1) {
    if (block_m != kDecBM) return (int)cudaErrorInvalidValue;
    const dim3 grid((M + kDecBM - 1) / kDecBM, (N + kBN - 1) / kBN, splits);
    if (out_f32)
      int8_decode_kernel<true><<<grid, kDecThreads, kDecSmem, s>>>(xb, qb, sc, y, wk, ct, M, N, K,
                                                                   kps);
    else
      int8_decode_kernel<false><<<grid, kDecThreads, kDecSmem, s>>>(xb, qb, sc, y, wk, ct, M, N,
                                                                    K, kps);
  } else if (path == 2 && block_m == 128) {
    return (int)(out_f32 ? launch_wgmma<2, true>(x, q, sc, y, wk, ct, M, N, K, splits, kps, s)
                         : launch_wgmma<2, false>(x, q, sc, y, wk, ct, M, N, K, splits, kps, s));
  } else if (path == 2 && block_m == 256 && !out_f32) {
    return (int)launch_wgmma<4, false>(x, q, sc, y, wk, ct, M, N, K, splits, kps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
