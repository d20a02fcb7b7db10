// Shared declarations for the port's kernels.
//
// Each .cu file in this directory is compiled on its own by nvcc into a
// shared library with a plain C interface (dyglib_tpu_torch/ops/_build.py)
// and loaded with ctypes. Every entry point takes raw device pointers and
// the CUDA stream to launch on, allocates nothing, does not synchronise,
// and returns cudaGetLastError() right after its launch.
#pragma once

#include <cuda_runtime.h>

#define DYGLIB_API extern "C" __attribute__((visibility("default")))

// Message for a code returned by an entry point (one copy per library).
DYGLIB_API const char* dyglib_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
