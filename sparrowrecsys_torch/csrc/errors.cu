// Error text for the C entry points of the kernel library.
//
// Every entry point returns the cudaError_t of its launch
// (cudaGetLastError() right after it) as an int; the Python wrapper
// raises with this text when it is not 0.

#include <cuda_runtime.h>

extern "C" const char* sparrow_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
