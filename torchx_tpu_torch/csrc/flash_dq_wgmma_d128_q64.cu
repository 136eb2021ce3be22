// The flash dq's tiles at head_dim 128 with block_q 64 (flash_dq_wgmma.cuh).

#include "flash_dq_wgmma.cuh"

namespace tpx {
TPX_FLASH_DQ_TILES_D128_Q64(TPX_FLASH_DQ_INSTANCE)
}  // namespace tpx
