// Shared C entry points of the kernel library.

#include <cuda_runtime.h>

// Text of a CUDA error code returned by the other entry points.
extern "C" const char* vlt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
