// The flash dk/dv's tiles at head_dim 128 with block_kv 128
// (flash_dkv_wgmma.cuh).

#include "flash_dkv_wgmma.cuh"

namespace tpx {
TPX_FLASH_DKV_TILES_D128_KV128(TPX_FLASH_DKV_INSTANCE)
}  // namespace tpx
