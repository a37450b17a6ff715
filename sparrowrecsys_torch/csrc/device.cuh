// Host-side helper shared by the C entry points of the kernel library.

#pragma once

#include <cuda_runtime.h>

// Make `device` the calling thread's current device where it is not
// already. cudaGetDevice reads a thread-local; cudaSetDevice costs more,
// and every launch would pay it.
inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}
