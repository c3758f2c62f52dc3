// Shared helpers for the port's hand-written kernels.
//
// Every kernel library exports a plain C interface (loaded with ctypes by
// mxnet_tpu_torch/kernels/_build.py).  Each C entry point returns the
// cudaError_t of its launch as an int; mxt_error_string turns it into text.
#pragma once

#include <cuda_runtime.h>

#define MXT_DEFINE_ERROR_STRING                                     \
  extern "C" const char* mxt_error_string(int err) {                \
    return cudaGetErrorString(static_cast<cudaError_t>(err));       \
  }
