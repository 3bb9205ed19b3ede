// Helpers shared by the port's kernels: f32 / bf16 loads widened to f32,
// bf16 rounding of stored values, and a warp-wide sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// Same value as kernels/ref.py MASKED_DIST.
constexpr float kMaskedDist = 1e30f;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Round an f32 value to what the storage type can hold (identity for f32).
template <typename T>
__device__ __forceinline__ float round_store(float v);
template <>
__device__ __forceinline__ float round_store<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_store<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Butterfly sum: every lane ends with the total of the warp.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace repro_torch
