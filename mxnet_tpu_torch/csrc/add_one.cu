// Toolchain probe: o = x + 1 on a float32 buffer.
//
// Replaces experiments/flash_probe.py:add_one, the (8, 128) Pallas probe that
// tells a dead toolchain apart from a bad kernel.  It is built and launched
// before any real kernel, so that a compiler, runtime or loader fault is named
// as one.
#include "common.cuh"

__global__ void add_one_kernel(const float* __restrict__ x,
                               float* __restrict__ o, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + 1.0f;
}

extern "C" int mxt_add_one(const void* x, void* o, int n, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  add_one_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return static_cast<int>(cudaGetLastError());
}

MXT_DEFINE_ERROR_STRING
