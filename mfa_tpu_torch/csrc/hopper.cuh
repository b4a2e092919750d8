// Hopper (sm_90a) building blocks: mbarriers, TMA tile loads, wgmma
// descriptors and instructions, warpgroup register hand-off, the layout
// of the warp-specialised kernels (two consumer warpgroups and a
// producer, rings of swizzled tiles sized to shared memory), and the
// host-side tensor-map encoder, the persistent grid and its tile walk.
// Used by flash_fwd.cu's K1, flash_bwd.cu's K3/K4, gemm.cu's K7 and
// quant_matmul.cu's K8.
//
// Shared-memory tiles are 128-byte-swizzled panels of 64 bf16 columns:
// a [rows x D] tile is D/64 panels of [rows x 64], each row 128 bytes,
// each group of 8 rows one 1024-byte swizzle atom; TMA writes them (box
// {64, rows, 1}, CU_TENSOR_MAP_SWIZZLE_128B) and wgmma reads them through
// descriptors of layout type 1 (B128). Panels must be 1024-byte aligned.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mfa {
namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive and expect `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// counts parity 1 as completed, so a producer's first wait on an empty
// slot, parity 1, passes). A wait that never completes (a fault in a
// pipeline) traps after ~2^26 tries instead of hanging the card. The
// loop is one asm block, with no call (a printf here made ptxas
// serialise every wgmma of the kernels that wait).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 0x4000000;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// Thread-block clusters
// ---------------------------------------------------------------------------
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of every CTA of the cluster: shared-memory writes and
// mbarrier initialisations before it are visible to the whole cluster
// after it, and no CTA leaves while another may still reach its shared
// memory.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of shared::cta address `addr` in the CTA of
// rank `rank` (every CTA of a kernel lays its shared memory out alike).
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// An arrival on an mbarrier of another CTA of the cluster (plain: a
// .release.cluster arrival costs a cluster-wide fence; ClusterSum's
// arrivals only follow reads whose values this thread has already used).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t cluster_bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                   cluster_bar)
               : "memory");
}

// A 16-byte store into the shared memory of a CTA of the cluster that
// counts its bytes on that CTA's mbarrier `cluster_bar` (as TMA does).
__device__ __forceinline__ void st_async_v4(uint32_t cluster_addr,
                                            const float (&v)[4],
                                            uint32_t cluster_bar) {
  asm volatile(
      "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(cluster_addr),
      "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])),
      "r"(__float_as_uint(v[2])), "r"(__float_as_uint(v[3])),
      "r"(cluster_bar)
      : "memory");
}

// mbar_wait with acquire at cluster scope: what other CTAs of the cluster
// wrote before their arrivals (or stored by st_async_v4) is visible after.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 0x4000000;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------
// The box of a 3-D map at (c0, c1, c2) (innermost first) into dst;
// elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// G bytes global -> shared, asynchronous (G = 4 or 8; src and dst G-byte
// aligned); in == false writes zeros and reads nothing.
template <int G>
__device__ __forceinline__ void cp_async_g(void* dst, const void* src,
                                           bool in) {
  static_assert(G == 4 || G == 8, "cp.async.ca copies 4 or 8 bytes here");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(G), "r"(in ? G : 0)
               : "memory");
}

// An arrival on `bar` once this thread's earlier cp.async copies have
// landed (counted in the barrier's expected arrivals: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Generic-proxy writes to shared memory become visible to wgmma / TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Warpgroups
// ---------------------------------------------------------------------------
// The warpgroup of this thread, as a value the compiler knows to be the
// same across the warp (a shuffle from lane 0): branches on it do not
// count as divergent, so ptxas need not serialise the wgmma inside them.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// An arrival on barrier `id` that does not wait: `threads` counts both the
// arriving threads and those that wait in named_barrier.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// x, hidden from the optimiser: descriptors built from it inside a loop
// stay there (a 64-bit descriptor hoisted for every k-step of every
// product costs two registers each).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// Descriptor of a B128-swizzled operand at shared address `addr`:
// K-major (rows along M/N, 64 contiguous K values a panel row): SBO =
// 1024 (the next 8 rows), LBO unused (1); a k-step of 16 adds 32 bytes.
// MN-major (rows along K, 64 contiguous M/N values a panel row): SBO =
// 1024 (the next 8 K rows), LBO = the byte stride between panels (the
// next 64 M/N values); a k-step of 16 adds 2048 bytes.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to accumulator registers across
// the asynchronous wgmma that writes them.
template <int NT>
__device__ __forceinline__ void fence_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// m64nNk16, bf16 x bf16 -> fp32. The accumulator d[j][e] of a thread
// (warp w of the warpgroup, lane = 4 g + t) holds row 16 w + g + 8 (e / 2),
// column 8 j + 2 t + e % 2: each warp's 16 rows laid out as mma.sync's
// m16n8 tiles side by side, so an accumulator pair (2 kc, 2 kc + 1) packs
// into the register A fragment of k-step kc. TA / TB: 0 K-major, 1
// MN-major.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // D (64 x 32) += A (smem) * B (smem); scale_d = 0 overwrites D.
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[4][4],
                                            uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
  // D (64 x 32) += A (registers, an mma.sync-style fragment) * B (smem).
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[4][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  // D (64 x 64) += A (smem) * B (smem); scale_d = 0 overwrites D.
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[8][4],
                                            uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
  // D (64 x 64) += A (registers, an mma.sync-style fragment) * B (smem).
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  // D (64 x 128) += A (smem) * B (smem); scale_d = 0 overwrites D.
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[16][4],
                                            uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
  // D (64 x 128) += A (registers, an mma.sync-style fragment) * B (smem).
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[16][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};

template <>
struct Wgmma<256> {
  // D (64 x 256) += A (smem) * B (smem); scale_d = 0 overwrites D.
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[32][4],
                                            uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
  // D (64 x 256) += A (registers, an mma.sync-style fragment) * B (smem).
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};

template <>
struct Wgmma<192> {
  // D (64 x 192) += A (registers, an mma.sync-style fragment) * B (smem).
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[24][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};

// Keeps register A fragments of an asynchronous wgmma alive (and
// unchanged) until this point: the compiler sees them read here, so it
// neither reuses their registers nor rewrites them before the wait.
template <int NK>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[NK][4]) {
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// ---------------------------------------------------------------------------
// Warp-specialised kernels: layout and helpers
// ---------------------------------------------------------------------------
constexpr int kWgThreads = 128;
constexpr int kWgmmaThreads = 3 * kWgThreads;   // 2 consumer WGs + producer
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kPanelBytes = 128;   // one swizzled panel row: 64 bf16
constexpr int kSmemOptin = 232448;   // shared memory a block may use
constexpr int kAlignSlack = 1024;    // to align to the 1024-byte atom

// The dynamic shared memory, aligned to the 1024-byte swizzle atom.
__device__ __forceinline__ unsigned char* align_atom(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Bytes of a [rows x DP] bf16 tile (DP / 64 panels of [rows x 64]).
__host__ __device__ constexpr int tile_bytes(int rows, int dp) {
  return rows * dp * 2;
}

// Stages of a ring: as many as fit beside `fixed` bytes, at most `most`,
// rounded down to a multiple of `mult` (ops/params.py mirrors this).
__host__ __device__ constexpr int ring_stages(int fixed, int per_stage,
                                              int most, int mult) {
  return ((kSmemOptin - fixed) / per_stage < most
              ? (kSmemOptin - fixed) / per_stage
              : most) / mult * mult;
}

// Descriptor of k-step kk (16 values of the head dim) of a K-major tile
// of `rows` rows at shared address base.
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int rows, int kk) {
  return desc_b128(base + (kk >> 2) * rows * kPanelBytes + (kk & 3) * 32, 16);
}

// Descriptor of k-step kc (16 rows) of an MN-major tile of `rows` rows.
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int rows, int kc) {
  return desc_b128(base + kc * 2048, rows * kPanelBytes);
}

// Multiplies a bf16 tile by `scale` in place or into dst, rounding to
// bf16 (the swizzle is a permutation of 16-byte chunks, so the chunk at
// one offset keeps its place).
__device__ __forceinline__ void scale_chunks(const unsigned char* src,
                                             unsigned char* dst, int bytes,
                                             float scale, int tid,
                                             int nthreads) {
  for (int c = tid * 16; c < bytes; c += nthreads * 16) {
    uint4 v = *reinterpret_cast<const uint4*>(src + c);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      h[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(dst + c) = v;
  }
}

// Byte c of row r of a [rows x DP] bf16 tile of B128-swizzled panels (the
// layout TMA's 64-column boxes give): panel c / 128, 16-byte chunk
// (c / 16) % 8 XOR r % 8 of the panel's row r.
__device__ __forceinline__ int swizzled(int rows, int r, int c) {
  return (c >> 7) * rows * kPanelBytes + r * kPanelBytes +
         ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// The G-byte granules of a swizzled [rows x DP] tile (rows a multiple of
// 8) of rows of `row_bytes` bytes, thread t of n, in runs that keep the
// swizzle fixed: run p is byte c = (p / 8) G of rows r0 = p % 8, r0 + 8,
// ..., so along a run the shared address steps by 8 panel rows (1024
// bytes) and the global one by 8 rows, with no address arithmetic but
// two adds a granule. f(r0, c, at) is called once a run with the byte
// offset `at` of its first granule in the tile; it walks the run.
template <int G, typename F>
__device__ __forceinline__ void for_runs(int rows, int row_bytes, int t,
                                         int n, F&& f) {
  for (int p = t; p < 8 * (row_bytes / G); p += n) {
    const int r0 = p & 7, c = (p >> 3) * G;
    f(r0, c, swizzled(rows, r0, c));
  }
}

// How a warp-specialised flash kernel's producer warpgroup fills its
// tiles: kTma, one thread issuing TMA boxes (rows TMA maps: D % 8 == 0,
// 16-byte-aligned bases); kCopy, its 128 threads issuing cp.async of the
// granule every base and row shares (4 or 8 bytes) straight into the
// swizzled tiles (copy_rows), each thread's copies counted on the tile's
// full barrier (cp.async.mbarrier.arrive.noinc, 128 arrivals).
enum Producer : int { kTma = 0, kCopy = 1 };

// The largest of 16, 8, 4 (else 2) bytes that the bases OR-ed into
// `ptr_or` and the bf16 row stride 2 D are multiples of: the copying
// producer's granule (ops/descriptors.py copy_granule).
inline int copy_granule(int D, uintptr_t ptr_or) {
  int g = 16;
  while (g > 2 && (ptr_or % g || (2 * D) % g)) g /= 2;
  return g;
}

// Rows [row0, row0 + ROWS) of a bf16 tensor of `limit` rows of
// `row_bytes` bytes at `src` into a swizzled [ROWS x DP] tile by cp.async,
// G bytes a copy (the granule every row shares), thread t of n along
// for_runs: rows at or past `limit` arrive as zeros (as TMA gives them),
// by copies that read nothing; columns past row_bytes / 2 are not
// written. (16-byte copies where a run's rows start 16-byte aligned, and
// none for the chunk's other granules, made K1 slower at D 100 and 250.)
template <int ROWS, int G>
__device__ __forceinline__ void copy_rows(unsigned char* tile,
                                          const unsigned char* src, int row0,
                                          int limit, int row_bytes, int t,
                                          int n) {
  const size_t step = 8 * (size_t)row_bytes;
  for_runs<G>(ROWS, row_bytes, t, n, [&](int r0, int c, int at) {
    const unsigned char* s = src + (size_t)(row0 + r0) * row_bytes + c;
    unsigned char* d = tile + at;
    const int left = limit - row0 - r0;   // rows r0 + 8 k < left are in
    if (left >= ROWS) {
#pragma unroll
      for (int k = 0; k < ROWS / 8; ++k, s += step)
        cp_async_g<G>(d + k * 8 * kPanelBytes, s, true);
    } else {
#pragma unroll
      for (int k = 0; k < ROWS / 8; ++k, s += step)
        cp_async_g<G>(d + k * 8 * kPanelBytes, 8 * k < left ? s : src,
                      8 * k < left);
    }
  });
}

// Zeroes 16-byte chunks [c0, DP / 8) of every row of a swizzled [rows x
// DP] tile: the columns past D that a copying producer never writes.
__device__ __forceinline__ void zero_chunks(unsigned char* tile, int rows,
                                            int dp, int c0, int t, int n) {
  const int per = dp / 8 - c0;
  for (int idx = t; idx < rows * per; idx += n) {
    const int r = idx / per, c = (c0 + idx % per) * 16;
    *reinterpret_cast<uint4*>(tile + swizzled(rows, r, c)) =
        make_uint4(0, 0, 0, 0);
  }
}

// Output tile t of a persistent matrix-product walk over `batch` products
// of tiles_m x tiles_n tiles: bands of `group` tile rows, each band walked
// column by column (so the CTAs in flight share their A rows and B
// columns in L2), then the next band, then the next product.
__device__ __forceinline__ void tile_walk(int t, int tiles_m, int tiles_n,
                                          int group, int& z, int& mi,
                                          int& ni) {
  const int per = tiles_m * tiles_n;
  z = t / per;
  t -= z * per;
  const int band = t / (group * tiles_n);
  const int first = band * group;
  const int rows = tiles_m - first < group ? tiles_m - first : group;
  t -= band * group * tiles_n;
  mi = first + t % rows;
  ni = t / rows;
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
}

// The head-dim-split kernels (K1 and K4 past D = 256): a cluster of
// `size` CTAs, CTA p holding a consumer warpgroup's partial accumulator
// over head-dim panel p; ClusterSum gives each the sum over the cluster
// in rank order 0, 1, ..., so every CTA holds the same bits. A consumer
// warpgroup's area has one slot for each other CTA, NCH 16-byte chunks a
// thread, laid out [slot][chunk][thread] (a warp's 16-byte accesses are
// conflict-free). Each CTA pushes its chunks into its slot of every
// other CTA by st.async, which counts the bytes on that CTA's `full`
// mbarrier (one arrival: the local arming with the bytes expected);
// `empty` takes four arrivals of each other CTA (its warps have read the
// slot this CTA fills). No atomics; one exchange in flight.
template <int NCH>
struct ClusterSum {
  uint32_t slots;   // shared::cta address of this warpgroup's area
  uint64_t* full;
  uint64_t* empty;
  int rank, size, wt, lane;
  int step = 0;     // exchanges begun

  static constexpr int kSlotBytes = NCH * kWgThreads * 16;

  __device__ __forceinline__ uint32_t chunk(int slot, int c) const {
    return slots + ((slot * NCH + c) * kWgThreads + wt) * 16;
  }

  // The other CTAs have read this CTA's previous chunks, and `full`
  // expects this exchange's bytes.
  __device__ __forceinline__ void begin() {
    if (step > 0) mbar_wait(empty, (step - 1) & 1);
    if (wt == 0) mbar_expect_tx(full, (size - 1) * kSlotBytes);
  }

  // Chunks [c0, c0 + N) of this thread (a[k], one chunk each) into this
  // CTA's slot of every other CTA.
  template <int N>
  __device__ __forceinline__ void send(const float (&a)[N][4], int c0) {
    for (int c = 0; c < size; ++c) {
      if (c == rank) continue;
      const uint32_t bar = map_rank(smem_addr(full), c);
      const uint32_t at = map_rank(chunk(rank - (rank > c), c0), c);
#pragma unroll
      for (int k = 0; k < N; ++k)
        st_async_v4(at + k * kWgThreads * 16, a[k], bar);
    }
  }

  __device__ __forceinline__ void wait() {
    mbar_wait_cluster(full, step & 1);
  }

  // a[k] = the sum of chunk c0 + k over ranks 0, 1, ..., size - 1 in
  // that order (this CTA's own from a).
  template <int N>
  __device__ __forceinline__ void sum(float (&a)[N][4], int c0) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float acc[4];
      for (int c = 0; c < size; ++c) {
        float x[4] = {a[k][0], a[k][1], a[k][2], a[k][3]};
        if (c != rank) {
          const float4 v = *reinterpret_cast<const float4*>(
              __cvta_shared_to_generic(chunk(c - (c > rank), c0 + k)));
          x[0] = v.x;
          x[1] = v.y;
          x[2] = v.z;
          x[3] = v.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = c == 0 ? x[e] : acc[e] + x[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) a[k][e] = acc[e];
    }
  }

  // This warp has read the other CTAs' chunks.
  __device__ __forceinline__ void end() {
    __syncwarp();
    if (lane == 0)
      for (int c = 0; c < size; ++c)
        if (c != rank) mbar_arrive_remote(map_rank(smem_addr(empty), c));
    ++step;
  }
};

// f(masked, capped) with both flags as compile-time constants.
template <typename F>
__device__ __forceinline__ void with_flags(bool masked, bool capped, F&& f) {
  if (capped) {
    if (masked)
      f(std::true_type{}, std::true_type{});
    else
      f(std::false_type{}, std::true_type{});
  } else if (masked) {
    f(std::true_type{}, std::false_type{});
  } else {
    f(std::false_type{}, std::false_type{});
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// The driver's encoder needs a context current on the calling host
// thread, and binds none itself. A thread whose first CUDA call is an
// encode (an autograd worker whose first work is a TMA kernel's launch)
// has none yet, and the encode fails; a runtime call binds the one the
// thread would use (the device's primary context, or keeps the one
// already current), once a thread.
inline bool bind_context() {
  thread_local const bool bound = cudaFree(nullptr) == cudaSuccess;
  return bound;
}

// A map over a 3-D tensor of `type` with extents n0 (contiguous), n1, n2
// and byte strides s1, s2 (multiples of 16) of dims 1 and 2, loading
// boxes {b0, b1, b2} with `swizzle`; elements outside the extents arrive
// as zeros.
inline bool tile_map_3d(CUtensorMap* map, CUtensorMapDataType type,
                        const void* base, uint64_t n0, uint64_t n1,
                        uint64_t n2, uint64_t s1, uint64_t s2, uint32_t b0,
                        uint32_t b1, uint32_t b2, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || !bind_context()) return false;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, b2};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map over a bf16 [n2, n1, n0] tensor (n0 contiguous; n0 % 8 == 0) that
// loads {64, rows, 1} boxes as B128-swizzled panels.
inline bool tile_map_bf16(CUtensorMap* map, const void* base, int n0, int n1,
                          int n2, int rows) {
  return tile_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, n0, n1, n2,
                     (uint64_t)n0 * 2, (uint64_t)n0 * n1 * 2, 64, rows, 1,
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

// `kernel` over `grid` CTAs of kWgmmaThreads threads and `smem` bytes of
// dynamic shared memory, in clusters of `panels` CTAs along x. Whether
// such a cluster fits the device at all (`panels` SMs of one GPC with the
// shared memory each needs) is asked once per cluster size (`known`, the
// caller's, caches the answer: 0 not asked, 1 fits, -1 does not); a
// cluster that cannot fit is refused before the launch.
template <typename Kernel, typename... Args>
inline cudaError_t launch_clusters(Kernel kernel, int grid, int panels,
                                   int smem, cudaStream_t stream,
                                   int (&known)[9], Args... args) {
  if (panels < 1 || panels > 8) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = panels;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kWgmmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (known[panels] == 0) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    known[panels] = clusters > 0 ? 1 : -1;
  }
  if (known[panels] < 0) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// CTAs of a persistent grid over `tiles` tiles: one a streaming
// multiprocessor of the current device, fewer when there are fewer tiles.
inline int persistent_ctas(int tiles) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return tiles < sms ? tiles : sms;
}

}  // namespace hopper
}  // namespace mfa
