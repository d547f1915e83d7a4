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

// 8 consecutive bf16 values <-> floats through one 16-byte access.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

}  // namespace gofr

extern "C" const char* gofr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
