// The message of a CUDA error code returned by the other entries.
#include <cuda_runtime.h>

extern "C" const char* cbim_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
