// Shared pieces of the port's CUDA kernels (built per source by
// navc_tpu_torch/ops/_build.py into one shared library each, loaded with
// ctypes). Every C entry returns cudaGetLastError() after its launch as an
// int; navc_error_string turns that code into CUDA's message.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

#define NAVC_EXPORT extern "C" __attribute__((visibility("default")))

NAVC_EXPORT const char* navc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
