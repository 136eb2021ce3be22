// The mma.sync flash dq's tile for bf16 at head_dim 256
// (flash_dq_mma.cuh).

#include "flash_dq_mma.cuh"

namespace tpx {
TPX_FLASH_DQ_MMA_TILES_BF16_D256(TPX_FLASH_DQ_MMA_INSTANCE)
}  // namespace tpx
