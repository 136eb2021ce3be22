// The mma.sync flash forward's tile for f32 at head_dim 128
// (flash_fwd_mma.cuh).

#include "flash_fwd_mma.cuh"

namespace tpx {
TPX_FLASH_FWD_MMA_TILES_F32_D128(TPX_FLASH_FWD_MMA_INSTANCE)
}  // namespace tpx
