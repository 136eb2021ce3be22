// The flash dk/dv's tiles at head_dim 64 with block_kv 128
// (flash_dkv_wgmma.cuh).

#include "flash_dkv_wgmma.cuh"

namespace tpx {
TPX_FLASH_DKV_TILES_D64_KV128(TPX_FLASH_DKV_INSTANCE)
}  // namespace tpx
