// The flash forward's tiles at head_dim 64 with block_q 128
// (flash_fwd_wgmma.cuh).

#include "flash_fwd_wgmma.cuh"

namespace tpx {
TPX_FLASH_FWD_TILES_D64_Q128(TPX_FLASH_FWD_INSTANCE)
}  // namespace tpx
