// The mma.sync flash dq's tile for f32 at head_dim 128
// (flash_dq_mma.cuh).

#include "flash_dq_mma.cuh"

namespace tpx {
TPX_FLASH_DQ_MMA_TILES_F32_D128(TPX_FLASH_DQ_MMA_INSTANCE)
}  // namespace tpx
