// Shared helpers of the port's hand-written Hopper kernels: element access
// in float or bfloat16 storage, rounding through the storage type, and the
// launch-error convention of the plain C interface (every entry point
// returns cudaGetLastError() after its launch, 0 on success).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace ei {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// jax's TPU flash attention's DEFAULT_MASK_VALUE, rounded to float32 as a
// Python float is: finite, so a fully masked row stays finite (uniform).
// Kernel G adds it after the scale where the segment ids differ.
constexpr float kMaskValue = -0.7 * (double)FLT_MAX;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// Round a float result through the storage type T, as an eager PyTorch op
// on T tensors rounds each result (identity for float).
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

}  // namespace ei
