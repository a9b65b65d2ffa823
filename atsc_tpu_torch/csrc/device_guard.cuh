// Scoped current device for the C entry points of the port's kernels.
//
// Each entry point takes the device of its tensors and makes it current
// for its runtime calls. DeviceGuard saves the caller's current device
// first and restores it when the entry point returns, on every return
// path, so a call never moves the calling thread's current device (what
// torch.cuda.current_device() and resolve_device("cuda") read).

#pragma once

#include <cuda_runtime.h>

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess) {
      saved_ = true;
      err_ = cudaSetDevice(device);
    }
  }
  ~DeviceGuard() {
    if (saved_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  // cudaSuccess once `device` is current; else the error that prevented it
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool saved_ = false;
  cudaError_t err_;
};
