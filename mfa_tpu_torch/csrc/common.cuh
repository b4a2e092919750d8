// Helpers shared by the port's kernels.
#pragma once

#include <cfloat>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace mfa {

// Large-finite mask sentinel: (masked - masked) never produces NaN, and a
// row whose running max is still this value has seen no visible key.
constexpr float kMaskValue = -0.5f * FLT_MAX;
constexpr float kLn2 = 0.69314718055994530942f;   // 1 / log2(e)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

}  // namespace mfa
