// Shared helpers of the port's CUDA kernels. Each kernel source is
// compiled on its own into a shared library with a plain C interface
// (gofr_tpu_torch/ops/kernels.py); every exported launcher returns its
// cudaError_t as an int.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gofr {

constexpr float kNegInf = -1e30f;  // finite, so exp(kNegInf - kNegInf) = 1

}  // namespace gofr

extern "C" const char* gofr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
