// Pieces shared by the matrix-product kernels (K7 gemm.cu, K8
// quant_matmul.cu): the fp16 mma.sync and the fp32 FMA main loop that both
// kernels use for fp32 operands (cp.async and ldmatrix are in common.cuh).
#pragma once

#include <cuda_fp16.h>

#include "common.cuh"

namespace mfa {

// D (16x8, fp32) += A (16x16, fp16, row) * B (16x8, fp16, col).
__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a,
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element types as the wrappers number them: 0 fp32, 1 bf16, 2 fp16.
__device__ __forceinline__ float load_as_float(const void* base, size_t at,
                                               int type) {
  if (type == 0) return static_cast<const float*>(base)[at];
  if (type == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[at]);
  return __half2float(static_cast<const __half*>(base)[at]);
}

__device__ __forceinline__ void store_from_float(void* base, size_t at,
                                                 int type, float v) {
  if (type == 0)
    static_cast<float*>(base)[at] = v;
  else if (type == 1)
    static_cast<__nv_bfloat16*>(base)[at] = __float2bfloat16(v);
  else
    static_cast<__half*>(base)[at] = __float2half(v);
}

// ---------------------------------------------------------------------------
// fp32 FMA main loop: a 64 x 64 block of C from A(m, k) and B(k, n)
// functors (each returns 0 outside the problem), 256 threads of 4 x 4
// outputs, K in steps of 16. The next step's elements are loaded into
// registers while the current step computes. ROWSUM also sums A's rows
// (K8's biased layout subtracts 8 * rowsum(x)).
// ---------------------------------------------------------------------------
constexpr int kFfmaBM = 64, kFfmaBN = 64, kFfmaBK = 16, kFfmaThreads = 256;
constexpr int kFfmaAS = kFfmaBM + 4;   // k-major A rows, padded (banks)

template <bool ROWSUM, class ALoad, class BLoad>
__device__ __forceinline__ void ffma_mainloop(const ALoad& A, const BLoad& B,
                                              int m0, int n0, int K,
                                              float (&acc)[4][4],
                                              float (&rs)[4]) {
  __shared__ __align__(16) float sA[kFfmaBK * kFfmaAS];
  __shared__ __align__(16) float sB[kFfmaBK * kFfmaBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rs[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  float ra[4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + kFfmaThreads * e;
      ra[e] = A(m0 + idx / kFfmaBK, k0 + idx % kFfmaBK);
      rb[e] = B(k0 + idx / kFfmaBN, n0 + idx % kFfmaBN);
    }
  };
  const int nk = (K + kFfmaBK - 1) / kFfmaBK;
  fetch(0);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();   // the previous step's tiles are consumed
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + kFfmaThreads * e;
      sA[(idx % kFfmaBK) * kFfmaAS + idx / kFfmaBK] = ra[e];
      sB[idx] = rb[e];
    }
    __syncthreads();
    if (kt + 1 < nk) fetch((kt + 1) * kFfmaBK);
#pragma unroll
    for (int kk = 0; kk < kFfmaBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(
          sA + kk * kFfmaAS + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(
          sB + kk * kFfmaBN + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ROWSUM) rs[i] += av[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
}

}  // namespace mfa
