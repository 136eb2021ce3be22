// Hopper (sm_90a) building blocks of the tensor-core kernels (the flash
// kernels flash_fwd_wgmma.cu, flash_dq_wgmma.cu, flash_dkv_wgmma.cu,
// flash_fwd_mma.cuh, flash_dq_mma.cuh, flash_dkv_mma.cuh, and the prefill
// and f32 paths of int8_matmul.cu), in raw PTX:
//
//   * mbarriers: init, arrive, arrive with an expected transaction count,
//     and a parity wait; a named barrier over part of a block;
//   * TMA: 2-D and 3-D tiled loads of a tensor map, and a plain bulk copy,
//     all completing on an mbarrier; the proxy fence that makes threads'
//     shared-memory writes visible to wgmma;
//   * wgmma: the shared-memory matrix descriptor for the 128-byte swizzle
//     that TMA writes, fence / commit / wait, and the m64nNk16 bf16 products
//     the kernels issue (A and B from shared memory, K-major or B MN-major,
//     or A from registers);
//   * mma.sync: the m16n8k8 TF32 and m16n8k16 bf16 warp products, ldmatrix
//     (plain and transposed) and the byte offset of an element in a
//     128-byte-swizzled tile of any element size;
//   * the register math around them: the bf16 and TF32 hi + lo splits and
//     exp2;
//   * the host side: 128-byte-swizzled tensor maps over a [rows, heads, d]
//     bf16 or f32 tensor, and 2-D maps over a row-major matrix, encoded through
//     the CUDA driver's entry point, which the runtime hands out, so the
//     library links nothing but the CUDA runtime.
//
// Tile layout shared by every kernel: a tile of R rows by d bf16 columns is
// stored as d / 64 column blocks of [R][64], each block R * 128 bytes and
// 1024-byte aligned, rows 128 bytes apart, swizzled by TMA in 8-row atoms of
// 1024 bytes. Read K-major (d contiguous, the contraction over d), a k16
// step moves 32 bytes along the row and the 8-row groups are 1024 bytes
// apart (SBO). Read MN-major (the contraction over rows), a k16 step moves
// 16 rows (2048 bytes), the 8-row groups are 1024 bytes apart (SBO) and
// the column blocks R * 128 bytes apart (LBO).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no CUDA driver symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpx {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (the 128-byte swizzle repeats
// every 1024 bytes, and the descriptors assume tiles start on it).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive once and expect `bytes` of TMA transactions before the phase ends.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase with the given parity has completed. A wait that
// outlasts ~2**34 cycles (seconds; a real one takes microseconds) can only
// be a deadlock: trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

// Synchronise the `count` threads (a multiple of 32) that take part in
// barrier `id` (1-15; 0 is __syncthreads').
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// Load the box at coordinates (c0, c1) of a 2-D tensor map into dst.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Load the box at coordinates (c0, c1, c2) of a 3-D tensor map into dst.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) to dst.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Order this thread's earlier shared-memory writes (the generic proxy)
// before later reads by wgmma or TMA (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand tile in shared memory; offsets
// in bytes (see the layout note at the top).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence / wait that bounds it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2**x by the special-function unit (relative error ~2**-22; 0 for -inf
// and flushed below 2**-126, far under what a probability can carry here).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x0, x1) ~= hi + lo as two bf16 pairs: hi = bf16(x), lo = bf16(x - hi).
// One bf16 rounding of a probability costs the product ~2**-9 relative;
// the pair keeps ~16 bits, so the f32 plain version is met to ~1e-6.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// (x0, x1) ~= hi + lo as TF32 values (f32 bit patterns whose low 13 bits
// are 0): hi = tf32(x) rounded to nearest, ties away (cvt.rna), lo =
// tf32(x - hi), where x - hi is exact. hi keeps 11 significant bits, the
// pair ~22: hi*hi + hi*lo + lo*hi leaves out lo*lo and the roundings of lo,
// ~2**-21 of each product, where hi*hi alone misses by ~2**-11.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// ---------------------------------------------------------------------------
// mma.sync: one warp's 16 x 8 products. Thread t (g = t / 4, c = t % 4):
//   accumulator d[4]: rows g (d0, d1) and g + 8 (d2, d3), columns 2c, 2c + 1;
//   TF32 m16n8k8: A a[4] = (g, c) (g + 8, c) (g, c + 4) (g + 8, c + 4),
//                 B b[2] = (k c, n g) (k c + 4, n g);
//   bf16 m16n8k16: A a[4] = rows g, g + 8, g, g + 8 at columns 2c, 2c + 1
//                 (a0, a1) and 2c + 8, 2c + 9 (a2, a3), two bf16 a register;
//                 B b[2] = (k 2c, 2c + 1, n g) (k 2c + 8, 2c + 9, n g).
// ---------------------------------------------------------------------------

// D[16 x 8] += A[16 x 8] * B[8 x 8], TF32 operands, f32 sums.
__device__ __forceinline__ void mma_m16n8k8_tf32(float (&d)[4], const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7},"
      " {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D[16 x 8] += A[16 x 16] * B[16 x 8], bf16 operands, f32 sums.
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&d)[4], const uint32_t (&a)[4],
                                                  const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7},"
      " {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8 (16 bytes); r[i] holds matrix i as thread t
// reads it: row t / 4, columns 2(t % 4), 2(t % 4) + 1 (plain), or the
// transpose, rows 2(t % 4), 2(t % 4) + 1 of column t / 4 (trans).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// Byte offset of element (r, c) in a tile of R rows of E-byte elements as
// TMA writes it with the 128-byte swizzle: column blocks of 128 / E
// elements, each [R][128 bytes], the 16-byte chunk of row r XORed with
// r % 8 (R a multiple of 8, the tile 1024-byte aligned).
template <int R, int E>
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  constexpr int W = 128 / E;
  const uint32_t cb = c / W, byte = (c % W) * E;
  return cb * R * 128 + r * 128 + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15));
}

// One warp's tile products for the flash kernels that run on mma.sync
// (flash_fwd_mma.cuh, flash_dq_mma.cuh, flash_dkv_mma.cuh), on
// 128-byte-swizzled tiles of float or bf16 elements in shared memory (R
// rows each, as TMA writes them).
// For float every operand is split into TF32 hi + lo once it is in
// registers and each product issued three times (lo*hi, hi*lo, hi*hi: f32
// accuracy, split_tf32); bf16 operands are exact, read by ldmatrix.

// f32 element (r, c) of a swizzled tile of R rows.
template <int R>
__device__ __forceinline__ float ld_sw_f32(const float* tile, int r, int c) {
  return *reinterpret_cast<const float*>(reinterpret_cast<const uint8_t*>(tile) + sw128<R, 4>(r, c));
}

// acc[16 x N] += A[a0 .. a0 + 16, 0 .. D) * B[0 .. N, 0 .. D)^T, both read
// K-major (their rows contiguous along D): A a tile of RA rows, B of RB.
template <typename T, int D, int RA, int RB, int N>
__device__ __forceinline__ void warp_mma_abt(float (&acc)[N / 8][4], const T* A, int a0,
                                             const T* B, int lane) {
  const int g = lane / 4, c = lane % 4;
  if constexpr (sizeof(T) == 4) {
#pragma unroll 4
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(ld_sw_f32<RA>(A, a0 + g, 8 * kk + c), ah[0], al[0]);
      split_tf32(ld_sw_f32<RA>(A, a0 + g + 8, 8 * kk + c), ah[1], al[1]);
      split_tf32(ld_sw_f32<RA>(A, a0 + g, 8 * kk + c + 4), ah[2], al[2]);
      split_tf32(ld_sw_f32<RA>(A, a0 + g + 8, 8 * kk + c + 4), ah[3], al[3]);
#pragma unroll
      for (int nb = 0; nb < N / 8; ++nb) {
        uint32_t bh[2], bl[2];
        split_tf32(ld_sw_f32<RB>(B, 8 * nb + g, 8 * kk + c), bh[0], bl[0]);
        split_tf32(ld_sw_f32<RB>(B, 8 * nb + g, 8 * kk + c + 4), bh[1], bl[1]);
        mma_m16n8k8_tf32(acc[nb], al, bh);
        mma_m16n8k8_tf32(acc[nb], ah, bl);
        mma_m16n8k8_tf32(acc[nb], ah, bh);
      }
    }
  } else {
    static_assert(N % 16 == 0, "bf16 B fragments come two n8 blocks at a time");
    const uint8_t* a_bytes = reinterpret_cast<const uint8_t*>(A);
    const uint8_t* b_bytes = reinterpret_cast<const uint8_t*>(B);
    const int mi = lane / 8, ri = lane % 8;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, a_bytes + sw128<RA, 2>(a0 + (mi & 1) * 8 + ri, 16 * kk + (mi >> 1) * 8));
#pragma unroll
      for (int nb = 0; nb < N / 8; nb += 2) {
        uint32_t bb[4];
        ldmatrix_x4(bb, b_bytes + sw128<RB, 2>(8 * nb + (mi >> 1) * 8 + ri, 16 * kk + (mi & 1) * 8));
        const uint32_t b0[2] = {bb[0], bb[1]}, b1[2] = {bb[2], bb[3]};
        mma_m16n8k16_bf16(acc[nb], a, b0);
        mma_m16n8k16_bf16(acc[nb + 1], a, b1);
      }
    }
  }
}

// acc[16 x DN] += P[16 x K] * Y[0 .. K, y0 .. y0 + DN): P in registers as
// the accumulators of a 16 x K product (p[K / 8][4]), Y a tile of K rows
// read MN-major. f32: the TF32 A fragment of k8 block j takes the thread's
// own columns 8j + 2c, 8j + 2c + 1 of P as its k c and c + 4, and Y's rows
// are read in that order, so P needs no shuffle. bf16: P split into bf16
// hi + lo (split_bf16x2), two products, Y by ldmatrix.trans.
template <typename T, int K, int DN>
__device__ __forceinline__ void warp_mma_pv(float (&acc)[DN / 8][4], const float (&p)[K / 8][4],
                                            const T* Y, int y0, int lane) {
  const int g = lane / 4, c = lane % 4;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < K / 8; ++j) {
      uint32_t ah[4], al[4];
      split_tf32(p[j][0], ah[0], al[0]);
      split_tf32(p[j][2], ah[1], al[1]);
      split_tf32(p[j][1], ah[2], al[2]);
      split_tf32(p[j][3], ah[3], al[3]);
#pragma unroll
      for (int nb = 0; nb < DN / 8; ++nb) {
        uint32_t bh[2], bl[2];
        split_tf32(ld_sw_f32<K>(Y, 8 * j + 2 * c, y0 + 8 * nb + g), bh[0], bl[0]);
        split_tf32(ld_sw_f32<K>(Y, 8 * j + 2 * c + 1, y0 + 8 * nb + g), bh[1], bl[1]);
        mma_m16n8k8_tf32(acc[nb], al, bh);
        mma_m16n8k8_tf32(acc[nb], ah, bl);
        mma_m16n8k8_tf32(acc[nb], ah, bh);
      }
    }
  } else {
    static_assert(K % 16 == 0 && DN % 16 == 0, "bf16 fragments come in pairs of n8 blocks");
    const uint8_t* y_bytes = reinterpret_cast<const uint8_t*>(Y);
    const int mi = lane / 8, ri = lane % 8;
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16x2(p[2 * kk][0], p[2 * kk][1], ph[0], pl[0]);
      split_bf16x2(p[2 * kk][2], p[2 * kk][3], ph[1], pl[1]);
      split_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int nb = 0; nb < DN / 8; nb += 2) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, y_bytes + sw128<K, 2>(16 * kk + (mi & 1) * 8 + ri,
                                                    y0 + 8 * nb + (mi >> 1) * 8));
        const uint32_t b0[2] = {bb[0], bb[1]}, b1[2] = {bb[2], bb[3]};
        mma_m16n8k16_bf16(acc[nb], ph, b0);
        mma_m16n8k16_bf16(acc[nb], pl, b0);
        mma_m16n8k16_bf16(acc[nb + 1], ph, b1);
        mma_m16n8k16_bf16(acc[nb + 1], pl, b1);
      }
    }
  }
}

// The products. An accumulator d[N/2] of a warpgroup's 64 x N tile holds, in
// thread t (warp w = t / 32 of the warpgroup, lane l), for n8 block j:
//   d[4j + 0, 1] = row 16w + l/4,     columns 8j + 2(l%4) + {0, 1}
//   d[4j + 2, 3] = row 16w + l/4 + 8, the same columns.
// The A fragment of a 64 x 16 register operand is the same layout packed to
// bf16 pairs: columns 16k..16k+15 of an accumulator are
//   a = {d[8k] d[8k+1], d[8k+2] d[8k+3], d[8k+4] d[8k+5], d[8k+6] d[8k+7]}.

// D[64 x 32] (+)= A[64 x 16] * B[16 x 32], A and B in shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B in shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B in shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A in shared memory K-major, B
// in shared memory MN-major (the transpose bit of B).
__device__ __forceinline__ void wgmma_ss_bt(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A in registers (wgmma fragment),
// B in shared memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A in registers (wgmma fragment),
// B in shared memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a contiguous bf16 (elem_bytes 2) or f32 (4) tensor
// [rows, heads, d] whose box is 128 bytes of columns (64 bf16 or 32 f32)
// of one head by box_rows rows, 128-byte swizzled. Coordinates are
// (column, head, row). -> a CUDA error code.
inline cudaError_t make_row_map(CUtensorMap* map, const void* base, int d, int heads,
                                int64_t rows, int box_rows, int elem_bytes = 2) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t eb = elem_bytes;
  cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)rows};
  cuuint64_t strides[2] = {(cuuint64_t)d * eb, (cuuint64_t)heads * d * eb};
  cuuint32_t box[3] = {(cuuint32_t)(128 / eb), 1, (cuuint32_t)box_rows};
  cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = fn(map, type, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A tensor map over a row-major matrix [rows, cols] of `elem_bytes`-byte
// elements (bf16 or int8; the row pitch a multiple of 16 bytes) whose box
// is box_rows x box_cols, with the given swizzle; elements outside the
// matrix read as zero. Coordinates are (column, row). -> a CUDA error code.
inline cudaError_t make_2d_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                               int elem_bytes, int64_t rows, int64_t cols, int box_rows,
                               int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Raise a kernel's dynamic shared-memory cap, then launch it.
template <typename K, typename... Args>
cudaError_t launch(K kernel, dim3 grid, int nthreads, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, nthreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace tpx
