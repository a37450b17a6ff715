// Host-side helper shared by the C entry points of the kernel library.

#pragma once

#include <cuda_runtime.h>

// Makes `device` the calling thread's current device for the guard's
// lifetime and sets the caller's device back when it goes out of scope,
// on every return path. PyTorch reads its current device from the same
// thread-local, so an entry point must leave it as it found it. Where the
// device is already current (every call on one card) it costs one
// cudaGetDevice, a thread-local read, and sets nothing.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    status_ = cudaGetDevice(&previous_);
    if (status_ == cudaSuccess && previous_ != device) {
      status_ = cudaSetDevice(device);
      restore_ = status_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (restore_) cudaSetDevice(previous_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t status() const { return status_; }

 private:
  int previous_ = -1;
  bool restore_ = false;
  cudaError_t status_ = cudaSuccess;
};
