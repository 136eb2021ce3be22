// Flash-attention forward by mma.sync: the entry point. The kernel, its
// design and the compiled tiles are in flash_fwd_mma.cuh; the
// flash_fwd_mma_*.cu files instantiate the tiles.

#include "flash_fwd_mma.cuh"

namespace tpx {
TPX_FLASH_FWD_MMA_TILES(TPX_FLASH_FWD_MMA_EXTERN)
}  // namespace tpx

extern "C" {

// f32 (dtype 0) at head_dim 64, 128 or 256, or bf16 (dtype 1) at 256, at
// the compiled tile (block_q, block_kv) of that dtype and head dim, S a
// multiple of both, H a multiple of KVH, every pointer 16-byte aligned; the
// wrapper checks and picks the tile (ops/fused.py fit_tile). seg: int32
// [B, S] segment ids, or null for none. Anything else is refused: nothing
// falls back to another kernel.
int tpx_flash_fwd_mma(const void* q, const void* k, const void* v, void* o, void* lse,
                      const void* seg, int B, int S, int H, int KVH, int D, int causal,
                      int dtype, int block_q, int block_kv, void* stream) {
  if (block_q <= 0 || block_kv <= 0 || S % block_q || S % block_kv)
    return (int)cudaErrorInvalidValue;
  const tpx::FwdMmaArgs a{q, k, v, seg, o, lse, B, S, H, KVH, causal, (cudaStream_t)stream};
#define TPX_CASE(T_, D_, BQ_, BK_)                                                 \
  if (dtype == (sizeof(T_) == 4 ? 0 : 1) && D == D_ && block_q == BQ_ && block_kv == BK_) \
    return (int)(seg ? tpx::flash_fwd_mma_tile<T_, D_, BQ_, BK_, true>(a)          \
                     : tpx::flash_fwd_mma_tile<T_, D_, BQ_, BK_, false>(a));
  TPX_FLASH_FWD_MMA_TILES(TPX_CASE)
#undef TPX_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
