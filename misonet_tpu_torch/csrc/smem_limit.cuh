// The dynamic shared-memory limit of a kernel, raised once.
//
// A block takes more than 48 KB of dynamic shared memory only after
// cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
// bytes).  Setting that per call, to the call's own size, races: another
// thread's smaller setting can land between this thread's setting and its
// launch, which the card then refuses, and a node of a CUDA graph replays
// its captured size against whatever limit was set last.  So each kernel
// (each template instantiation, through a function-local static in its
// launcher) has its limit raised once per device, to the most that any of
// its launches can take: the card's opt-in maximum for a block
// (cudaDevAttrMaxSharedMemoryPerBlockOptin, 227 KB on an H100) less the
// kernel's static shared memory.  Nothing is set per call.  The limit is a
// ceiling only: a launch still reserves its own size, so occupancy is as
// before.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace misonet {

class SmemLimit {
 public:
  // Raise `kernel`'s limit on the current device the first time only;
  // returns that first call's error (cudaSuccess once it succeeded).
  template <typename K>
  cudaError_t raise(K* kernel) {
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
    std::call_once(once_[dev], [&] {
      int most = 0;
      cudaFuncAttributes attr = {};
      cudaError_t r = cudaDeviceGetAttribute(
          &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (r == cudaSuccess) r = cudaFuncGetAttributes(&attr, kernel);
      if (r == cudaSuccess)
        r = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            most - (int)attr.sharedSizeBytes);
      err_[dev] = r;
    });
    return err_[dev];
  }

 private:
  static constexpr int kDevices = 64;
  std::once_flag once_[kDevices];
  cudaError_t err_[kDevices] = {};
};

}  // namespace misonet
