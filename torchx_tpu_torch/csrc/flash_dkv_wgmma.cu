// Flash-attention dk/dv on Hopper's tensor cores: the entry point. The
// kernel, its design and the compiled tiles are in flash_dkv_wgmma.cuh; the
// flash_dkv_wgmma_d*.cu files instantiate the tiles.

#include "flash_dkv_wgmma.cuh"

namespace tpx {
TPX_FLASH_DKV_TILES(TPX_FLASH_DKV_EXTERN)
}  // namespace tpx

extern "C" {

// bf16 only (dtype 1), head_dim 64 or 128, one of the compiled tiles
// (block_q: the q rows a step streams, block_kv: the kv rows a CTA owns),
// S a multiple of both, H a multiple of KVH, every pointer 16-byte aligned;
// the wrapper checks and picks the tile (ops/fused.py fit_tile). seg:
// int32 [B, S] segment ids, or null for none. Any other tile is refused:
// nothing falls back to another.
int tpx_flash_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, const void* seg,
                        int B, int S, int H, int KVH, int D, int causal, int dtype, int block_q,
                        int block_kv, void* stream) {
  if (dtype != 1 || block_q <= 0 || block_kv <= 0 || S % block_q || S % block_kv)
    return (int)cudaErrorInvalidValue;
  const tpx::DkvArgs a{q, k, v, dout, lse, delta, seg, dk, dv, B, S, H, KVH, causal,
                       (cudaStream_t)stream};
#define TPX_CASE(D_, BQ_, BKV_)                                                 \
  if (D == D_ && block_q == BQ_ && block_kv == BKV_)                            \
    return (int)(seg ? tpx::flash_dkv_tile<D_, BQ_, BKV_, true>(a)              \
                     : tpx::flash_dkv_tile<D_, BQ_, BKV_, false>(a));
  TPX_FLASH_DKV_TILES(TPX_CASE)
#undef TPX_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
