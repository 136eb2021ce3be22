// The CUDA runtime's message for an error code that a kernel's C entry
// point returned (_build.check reads it).

#include <cuda_runtime.h>

extern "C" const char* tpx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
