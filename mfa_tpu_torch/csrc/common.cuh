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
constexpr float kLog2e = 1.44269504088896340736f;
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

// Column col is visible to row row: the diagonal is aligned to the
// sequence ends (offset = C - R); a window keeps the W keys ending there.
__device__ __forceinline__ bool visible_rc(int row, int col, int R, int C,
                                           int causal, int window) {
  if (col >= C) return false;
  if (causal || window > 0) {
    const int diag = row + C - R;
    if (col > diag) return false;
    if (window > 0 && col < diag - (window - 1)) return false;
  }
  return true;
}

// Live kv blocks [lo, hi] of q-block i of bq rows (hi < lo: none), the
// bounds mfa_tpu's causal_pair_tables computes; P is a kernel's params
// (R, C, causal, window).
template <typename P>
__device__ __forceinline__ void kv_range(const P& p, int i, int bq, int bkv,
                                         int& lo, int& hi) {
  const int nkv = (p.C + bkv - 1) / bkv;
  const int offset = p.C - p.R;
  lo = 0;
  hi = nkv - 1;
  if (p.causal || p.window > 0) {
    hi = min(floor_div((i + 1) * bq - 1 + offset, bkv), nkv - 1);
    if (p.window > 0)
      lo = min(max(floor_div(i * bq + offset - (p.window - 1), bkv), 0),
               nkv - 1);
  }
}

// The wgmma kernels' 128-row q-block i: the kv blocks of its 64-row half
// w (empty when those rows lie past R), and of the whole block, the
// union of its two halves.
template <typename P>
__device__ __forceinline__ void half_kv_range(const P& p, int i, int w,
                                              int bkv, int& lo, int& hi) {
  if ((2 * i + w) * 64 >= p.R) {
    lo = 1;
    hi = 0;
    return;
  }
  kv_range(p, 2 * i + w, 64, bkv, lo, hi);
}

template <typename P>
__device__ __forceinline__ void pair_kv_range(const P& p, int i, int bkv,
                                              int& lo, int& hi) {
  int lo0, hi0, lo1, hi1;
  half_kv_range(p, i, 0, bkv, lo0, hi0);
  half_kv_range(p, i, 1, bkv, lo1, hi1);
  if (lo0 > hi0) {
    lo = lo1;
    hi = hi1;
  } else if (lo1 > hi1) {
    lo = lo0;
    hi = hi0;
  } else {
    lo = min(lo0, lo1);
    hi = max(hi0, hi1);
  }
}

// tanh soft-cap in the log2 domain (cap2 = cap * log2e; <= 0: none).
__device__ __forceinline__ float cap_score(float x, float cap2) {
  return cap2 > 0.f ? cap2 * tanhf(x / cap2) : x;
}

// D (16x8, fp32) += A (16x16, bf16, row) * B (16x8, bf16, col).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The accumulators of n-tiles 2kc and 2kc+1 as one A fragment (rounded).
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* lo,
                                         const float* hi) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// KV-cache storage formats, as the decode wrappers number them:
// 0 bf16, 1 int8, 2 fp8-e4m3, 3 fp8-e5m2.
// One chunk of 8 stored values: 16 bytes of bf16 or 8 of int8 / fp8.
template <int KVF>
struct Chunk {
  using type = typename std::conditional<KVF == 0, uint4, uint2>::type;
};

template <int KVF>
__device__ __forceinline__ typename Chunk<KVF>::type load_chunk(
    const void* base, size_t at) {
  using T = typename Chunk<KVF>::type;
  const char* b = static_cast<const char*>(base);
  return *reinterpret_cast<const T*>(b + at * (KVF == 0 ? 2 : 1));
}

// Widen a chunk to fp32 (Hopper's native conversions; exact).
template <int KVF>
__device__ __forceinline__ void to_float8(const typename Chunk<KVF>::type& c,
                                          float* x) {
  if constexpr (KVF == 0) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else if constexpr (KVF == 1) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&c);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(b[i]);
  } else if constexpr (KVF == 2) {
    const __nv_fp8_e4m3* b = reinterpret_cast<const __nv_fp8_e4m3*>(&c);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(b[i]);
  } else {
    const __nv_fp8_e5m2* b = reinterpret_cast<const __nv_fp8_e5m2*>(&c);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(b[i]);
  }
}

// N-byte global -> shared copy (N = 4, 8 or 16), asynchronous until
// cp_async_wait; 16-byte copies bypass L1.
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(N));
}

// 16-byte global -> shared copy; src_bytes = 0 writes zeros (the ragged
// edge of a tile) and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// Four 8x8 16-bit matrices from shared memory, one row address a lane
// (lanes 8q .. 8q + 7 give matrix q's rows); r[q] holds the lane's part of
// matrix q as an mma fragment. Rows must be 16-byte aligned.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for every cp.async this thread has issued, committed or not.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A flash entry's `panels` argument: ceil(D / block_d) for the D-blocked
// kernels (kernel code 2, and 3: the cluster kernels, one CTA of a cluster
// a panel), 1 for the others, and D fits them.
inline bool panels_ok(int kernel, int D, int block_d, int panels) {
  const bool blocked = kernel == 2 || kernel == 3;
  return panels == (blocked ? (D + block_d - 1) / block_d : 1) &&
         D <= block_d * panels;
}

// Programmatic dependent launch (sm_90): a kernel lets the next kernel on
// its stream be scheduled, and that kernel waits for this one's memory
// before it reads what this one wrote (a no-op without the launch
// attribute).
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The D-blocked flash kernels' panel loader: rows [row0, row0 + ROWS) x
// columns [col0, col0 + DP) of a bf16 [nrows, D] matrix into shared
// memory, zero padded: row-major into rm (stride DP + 8; scaled by
// `scale` and rounded when scale != 0) and/or transposed into tr (stride
// ROWS + 8); col0 is a multiple of 8; vec: 16-byte loads (D % 8 == 0, a
// 16-byte-aligned base). A row-major, unscaled tile with vec goes by cp.async,
// consecutive threads on consecutive chunks of a row: the caller waits
// (cp_async_wait_all) before the barrier that publishes it. Otherwise
// each thread holds kBatch 16-byte chunks (without vec, one chunk of
// eight 2-byte loads) in flight at once, consecutive threads on
// consecutive rows so the scattered 2-byte transposed stores stay
// conflict-free.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void load_panel(const __nv_bfloat16* src,
                                           int row0, int nrows, int D,
                                           int col0, int vec, float scale,
                                           __nv_bfloat16* rm,
                                           __nv_bfloat16* tr, int tid) {
  constexpr int kChunks = ROWS * (DP / 8);
  if (vec && tr == nullptr && scale == 0.f) {
    for (int c = tid; c < kChunks; c += NT) {
      const int r = c / (DP / 8), d0 = (c % (DP / 8)) * 8;
      const bool in = row0 + r < nrows && col0 + d0 < D;
      cp_async16(rm + r * (DP + 8) + d0,
                 in ? src + (size_t)(row0 + r) * D + col0 + d0 : src,
                 in ? 16 : 0);
    }
    return;
  }
  // One chunk into shared memory: transposed and/or row-major, scaled.
  auto put = [&](uint4 val, int c) {
    const int r = c % ROWS, d0 = (c / ROWS) * 8;
    __nv_bfloat16* e8 = reinterpret_cast<__nv_bfloat16*>(&val);
    if (tr != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) tr[(d0 + e) * (ROWS + 8) + r] = e8[e];
    }
    if (rm != nullptr) {
      if (scale != 0.f) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          e8[e] = __float2bfloat16(__bfloat162float(e8[e]) * scale);
      }
      *reinterpret_cast<uint4*>(rm + r * (DP + 8) + d0) = val;
    }
  };
  if (vec) {
    // 4 beat 2 and 1 for K4 on the H100, spills and all (bwd_tuning sweep
    // at D 384 and 512, N 4096).
    constexpr int kBatch = 4;
    for (int c0 = tid; c0 < kChunks; c0 += kBatch * NT) {
      uint4 vals[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int c = c0 + b * NT, r = c % ROWS, d0 = (c / ROWS) * 8;
        vals[b] = make_uint4(0, 0, 0, 0);
        if (c < kChunks && row0 + r < nrows && col0 + d0 < D)
          vals[b] = *reinterpret_cast<const uint4*>(
              src + (size_t)(row0 + r) * D + col0 + d0);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (c0 + b * NT < kChunks) put(vals[b], c0 + b * NT);
    }
    return;
  }
  for (int c = tid; c < kChunks; c += NT) {
    const int r = c % ROWS, d0 = (c / ROWS) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    __nv_bfloat16* e8 = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (row0 + r < nrows && col0 + d0 + e < D)
        e8[e] = src[(size_t)(row0 + r) * D + col0 + d0 + e];
    put(val, c);
  }
}

// The same for an fp32 matrix at row stride S, by 4-byte cp.async (the
// caller waits as for load_panel).
template <int ROWS, int DP, int S, int NT>
__device__ __forceinline__ void load_panel_f32(const float* src, int row0,
                                               int nrows, int D, int col0,
                                               float* dst, int tid) {
  for (int idx = tid; idx < ROWS * DP; idx += NT) {
    const int r = idx / DP, d = idx % DP;
    if (row0 + r < nrows && col0 + d < D)
      cp_async<4>(dst + r * S + d, src + (size_t)(row0 + r) * D + col0 + d);
    else
      dst[r * S + d] = 0.f;
  }
}

// One element of a bf16 (is_bf16) or fp32 tensor, as fp32.
__device__ __forceinline__ float load_q(const void* base, size_t at,
                                        int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[at])
                 : static_cast<const float*>(base)[at];
}

}  // namespace mfa
