// Shared helpers for the port's hand-written kernels.
//
// Every kernel library exports a plain C interface (loaded with ctypes by
// mxnet_tpu_torch/kernels/_build.py).  Each C entry point returns the
// cudaError_t of its launch as an int; mxt_error_string turns it into text.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

#define MXT_DEFINE_ERROR_STRING                                     \
  extern "C" const char* mxt_error_string(int err) {                \
    return cudaGetErrorString(static_cast<cudaError_t>(err));       \
  }

// Raises a kernel's dynamic shared memory limit to `bytes` on the current
// device, once per device: `done` (one static per kernel instantiation)
// keeps a bit for each device already set, so a launch pays for the call
// only the first time.
template <typename Kernel>
cudaError_t mxt_max_dynamic_smem_once(Kernel kernel, int bytes,
                                      std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}
