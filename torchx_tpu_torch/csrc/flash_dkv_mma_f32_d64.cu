// The mma.sync flash dk/dv's tile for f32 at head_dim 64
// (flash_dkv_mma.cuh).

#include "flash_dkv_mma.cuh"

namespace tpx {
TPX_FLASH_DKV_MMA_TILES_F32_D64(TPX_FLASH_DKV_MMA_INSTANCE)
}  // namespace tpx
