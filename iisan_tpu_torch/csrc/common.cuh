// Shared device helpers for the port's kernels.
//
// Every kernel computes in fp32 and stores in the compute type T (float or
// __nv_bfloat16).  `round_to<T>` is the cast chain's "astype(dtype)": it
// rounds an fp32 value to T (round to nearest even, as XLA does) and widens
// it back, so intermediate values carry exactly the precision the JAX
// reference gives them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace iisan {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sets the dynamic shared-memory limit when a launch needs more than the
// default 48 KB; returns the CUDA error of the attribute call.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace iisan
