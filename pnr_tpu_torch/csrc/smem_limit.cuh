// A kernel's dynamic shared memory limit (cudaFuncAttributeMaxDynamic-
// SharedMemorySize), raised to what a launch needs and never lowered,
// shared by K1 (frangi_fused.cu), K2 (zncc_exact.cu) and K4 (conv.cu).
//
// The attribute belongs to the kernel, not to the launch. Two host threads
// that launch one kernel with different shared memory (the batch driver's
// prefetch workers and its tracing thread) must not set it in turn: a
// thread that lowered it between another thread's setting and that
// thread's launch would make the launch fail. So each limit only grows,
// under a mutex, per device.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kSmemLimitDevices = 16;

struct SmemLimit {
  std::mutex mu;
  size_t set[kSmemLimitDevices] = {};
};

// Raise `kernel`'s limit on the current device to at least `smem` bytes.
template <typename Kernel>
cudaError_t raise_smem_limit(SmemLimit& lim, Kernel kernel, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kSmemLimitDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(lim.mu);
  if (smem <= lim.set[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) lim.set[dev] = smem;
  return err;
}

}  // namespace
