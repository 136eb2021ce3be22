// The mma.sync flash dk/dv's tile for bf16 at head_dim 256
// (flash_dkv_mma.cuh).

#include "flash_dkv_mma.cuh"

namespace tpx {
TPX_FLASH_DKV_MMA_TILES_BF16_D256(TPX_FLASH_DKV_MMA_INSTANCE)
}  // namespace tpx
