// Flash-attention dq by mma.sync: the entry point. The kernel, its design
// and the compiled tiles are in flash_dq_mma.cuh; the flash_dq_mma_*.cu
// files instantiate the tiles. Built with -DTPX_FLASH_DQ_MMA_GRID=<group>
// (chip_smoke.py --phases build,dqgrid), this file instead instantiates one
// group of the candidate tiles and exports only the grid's entry points.

#include "flash_dq_mma.cuh"

#ifdef TPX_FLASH_DQ_MMA_GRID

#define TPX_GRID_LIST_(n) TPX_FLASH_DQ_MMA_GRID_##n
#define TPX_GRID_LIST(n) TPX_GRID_LIST_(n)
#define TPX_GRID TPX_GRID_LIST(TPX_FLASH_DQ_MMA_GRID)

// Each candidate's masked instance too, for ptxas's report (only the
// unmasked one is launched).
namespace tpx {
#define TPX_SEG_INSTANCE(T_, D_, BQ_, BK_, DS_)                                      \
  template cudaError_t flash_dq_mma_launch<T_, D_, BQ_, BK_, DS_, true>(const DqMmaArgs&);
TPX_GRID(TPX_SEG_INSTANCE)
#undef TPX_SEG_INSTANCE
}  // namespace tpx

extern "C" {

// The group's candidates.
int tpx_flash_dq_mma_grid_size() {
  int n = 0;
#define TPX_COUNT(T_, D_, BQ_, BK_, DS_) ++n;
  TPX_GRID(TPX_COUNT)
#undef TPX_COUNT
  return n;
}

// Candidate i: dtype (0 f32, 1 bf16), head_dim, block_q, block_kv, warps
// along d, in out[0..4]. -> 0, or an error where i is out of range.
int tpx_flash_dq_mma_grid_tile(int i, int* out) {
  int at = 0;
#define TPX_TILE(T_, D_, BQ_, BK_, DS_)                                              \
  if (at++ == i) {                                                                   \
    const int t[5] = {sizeof(T_) == 4 ? 0 : 1, D_, BQ_, BK_, DS_};                   \
    for (int j = 0; j < 5; ++j) out[j] = t[j];                                       \
    return 0;                                                                        \
  }
  TPX_GRID(TPX_TILE)
#undef TPX_TILE
  return (int)cudaErrorInvalidValue;
}

// tpx_flash_dq_mma's arguments, without segment ids or a tile: candidate i
// of the group.
int tpx_flash_dq_mma_grid(int i, const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, int B, int S, int H,
                          int KVH, int causal, void* stream) {
  const tpx::DqMmaArgs a{q, k, v, dout, lse, delta, nullptr, dq, B, S, H, KVH, causal,
                         (cudaStream_t)stream};
  int at = 0;
#define TPX_CASE(T_, D_, BQ_, BK_, DS_)                                              \
  if (at++ == i) {                                                                   \
    if (S % BQ_ || S % BK_) return (int)cudaErrorInvalidValue;                       \
    return (int)tpx::flash_dq_mma_launch<T_, D_, BQ_, BK_, DS_, false>(a);           \
  }
  TPX_GRID(TPX_CASE)
#undef TPX_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

#else

namespace tpx {
TPX_FLASH_DQ_MMA_TILES(TPX_FLASH_DQ_MMA_EXTERN)
}  // namespace tpx

extern "C" {

// f32 (dtype 0) at head_dim 64, 128 or 256, or bf16 (dtype 1) at 256, at
// the compiled tile (block_q: the q rows a CTA owns, block_kv: the kv rows
// a step streams) of that dtype and head dim, S a multiple of both, H a
// multiple of KVH, every pointer 16-byte aligned; the wrapper checks and
// picks the tile (ops/fused.py fit_tile). seg: int32 [B, S] segment ids, or
// null for none. Anything else is refused: nothing falls back to another
// kernel.
int tpx_flash_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, const void* seg, int B, int S,
                     int H, int KVH, int D, int causal, int dtype, int block_q, int block_kv,
                     void* stream) {
  if (block_q <= 0 || block_kv <= 0 || S % block_q || S % block_kv)
    return (int)cudaErrorInvalidValue;
  const tpx::DqMmaArgs a{q, k, v, dout, lse, delta, seg, dq, B, S, H, KVH, causal,
                         (cudaStream_t)stream};
#define TPX_CASE(T_, D_, BQ_, BK_)                                                 \
  if (dtype == (sizeof(T_) == 4 ? 0 : 1) && D == D_ && block_q == BQ_ && block_kv == BK_) \
    return (int)(seg ? tpx::flash_dq_mma_tile<T_, D_, BQ_, BK_, true>(a)           \
                     : tpx::flash_dq_mma_tile<T_, D_, BQ_, BK_, false>(a));
  TPX_FLASH_DQ_MMA_TILES(TPX_CASE)
#undef TPX_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

#endif
