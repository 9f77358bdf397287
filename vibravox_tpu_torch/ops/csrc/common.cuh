// Helpers shared by the hand-written kernels of this directory: conversions
// between a storage type and the float32 the kernels compute in, and torch's
// reflect index.  Each kernel source is its own translation unit, so these
// live in an unnamed namespace.
#pragma once

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// f32 value rounded to the precision of the storage type T
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

// torch's reflect index, exact for an overhang smaller than t_len
__device__ __forceinline__ int reflect(int g, int t_len) {
  if (g < 0) g = -g;
  if (g > t_len - 1) g = 2 * (t_len - 1) - g;
  return g;
}

}  // namespace
