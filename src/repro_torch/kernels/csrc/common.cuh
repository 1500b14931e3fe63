// Shared helpers of the port's CUDA kernels: dtype codes and conversions.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed from Python (repro_torch.kernels._build.DTYPE_CODES)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// which kernel an entry point launches, chosen by the Python wrapper and
// passed as its `path` argument (repro_torch.kernels._build.PATHS)
enum Path : int {
  kPathSimt = 0, kPathWgmma = 1, kPathWmma = 2, kPathSplit = 3, kPathVector = 4
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sum16(float v) {   // over aligned 16-lane groups
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sum32(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

#define EXPORT_ERROR_STRING                                   \
  extern "C" const char* error_string(int err) {              \
    return cudaGetErrorString(static_cast<cudaError_t>(err)); \
  }
