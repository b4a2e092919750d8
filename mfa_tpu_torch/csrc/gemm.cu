// Batched GEMM for Hopper (sm_90a): C[b] = op(A[b]) op(B[b]) (+ C0[b]),
// fp32 accumulation, all four transpose states.
//
// Replaces the TPU kernel mfa_tpu/kernels/gemm_kernel.py::_gemm_kernel
// (built by build_gemm; a grid of (batch, M, N, K) blocks with the fp32
// accumulator carried in VMEM across the sequential K axis). Here one CTA
// owns one (batch, M block, N block) and loops over K inside, in a ring of
// cp.async stages; the batch is grid.z. Transposes are read through the
// stored layout: each tile lands in shared memory as it is stored, and the
// mma fragments are read from it in the orientation the product needs
// (ldmatrix.trans where the stored contiguous dimension is not K), so no
// operand is copied. Ragged edges are masked in the kernel (zero-filled
// copies), never padded in device memory. C0, when given, is read in C's
// type and added to the fp32 sum before the one cast (mfa_tpu casts C0 to
// the output type first, too).
//
// bf16 and fp16 operands of one type run mma.sync m16n8k16 with fp32
// accumulation. fp32 and mixed fp32/bf16 operands run an FMA loop in full
// fp32 (mfa_tpu asks for Precision.HIGHEST for fp32, so TF32 tensor cores
// are out; a bf16 operand widens to fp32 exactly).
//
// What bounds it on an H100: at 4096^3 in bf16 the product is 137 GFLOP,
// 139 us at the 989 TFLOP/s tensor-core peak, against 100 MB of operands
// (30 us at 3.35 TB/s): the bound is operations. fp32 at 1536^3 is bound
// by the 67 TFLOP/s of fp32 FMA. This first cut uses warp-level mma.sync
// fed from padded shared-memory tiles (32-bit loads where a tile's rows
// run along K; ldmatrix.trans for A stored [K, M], 16-bit loads for B
// stored [K, N]); no wgmma or TMA yet. The tile (128 x 128, 64 x 64, or 16 x 64 for a decode-sized M)
// comes from ops/descriptors.py::GEMMDescriptor.kernel_descriptor.

#include "matmul.cuh"

namespace {

using namespace mfa;

struct GemmParams {
  const void* a;
  const void* b;
  const void* c0;   // nullptr: none; else [batch, M, N] in c's type
  void* c;          // [batch, M, N]
  int M, N, K;
  long long lda, a_batch;   // stored row stride and batch stride (elements)
  long long ldb, b_batch;
  int a_type, b_type, c_type;   // 0 fp32, 1 bf16, 2 fp16
  int vec;                      // 16-byte copies allowed
};

// A stored tile [ROWS, COLS] (contiguous along COLS) of a 16-bit operand
// into shared memory with row stride SS; outside [rlim, clim) reads zero.
// vec: whole 16-byte chunks by cp.async (clim % 8 == 0, so a chunk is
// either inside or outside); else element by element.
template <int ROWS, int COLS, int SS, int NT>
__device__ __forceinline__ void load_tile(uint16_t* s, const uint16_t* g,
                                          long long ld, int r0, int c0,
                                          int rlim, int clim, int vec,
                                          int tid) {
  if (vec) {
    constexpr int CH = COLS / 8;
    for (int i = tid; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      const int gr = r0 + r, gc = c0 + c;
      const bool in = gr < rlim && gc < clim;
      cp_async16(s + r * SS + c, in ? g + (long long)gr * ld + gc : g,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      const int gr = r0 + r, gc = c0 + c;
      s[r * SS + c] =
          (gr < rlim && gc < clim) ? g[(long long)gr * ld + gc] : uint16_t(0);
    }
  }
}

template <bool BF16>
__device__ __forceinline__ void mma16(float* c, const uint32_t* a,
                                      uint32_t b0, uint32_t b1) {
  if constexpr (BF16)
    mma_bf16(c, a, b0, b1);
  else
    mma_f16(c, a, b0, b1);
}

// ---------------------------------------------------------------------------
// 16-bit operands: mma.sync. TA: A stored [K, M]; TB: B stored [N, K].
// ---------------------------------------------------------------------------
template <bool BF16, int BM, int BN, int BK, int WM, int WN, int STAGES,
          bool TA, bool TB>
__global__ void __launch_bounds__(WM * WN * 32)
mfa_gemm_mma(GemmParams p) {
  constexpr int NT = WM * WN * 32;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int FM = WTM / 16, FN = WTN / 8;
  // Stored tiles: A [BM, BK] or [BK, BM]; B [BK, BN] or [BN, BK].
  constexpr int A_ROWS = TA ? BK : BM, A_COLS = TA ? BM : BK;
  constexpr int B_ROWS = TB ? BN : BK, B_COLS = TB ? BK : BN;
  constexpr int AS = A_COLS + 8, BS = B_COLS + 8;
  constexpr int A_TILE = A_ROWS * AS, B_TILE = B_ROWS * BS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sA = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sB = sA + STAGES * A_TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, z = blockIdx.z;
  const int M = p.M, N = p.N, K = p.K;
  const uint16_t* ag = static_cast<const uint16_t*>(p.a) + z * p.a_batch;
  const uint16_t* bg = static_cast<const uint16_t*>(p.b) + z * p.b_batch;

  auto load_stage = [&](int stage, int k0) {
    uint16_t* a = sA + stage * A_TILE;
    uint16_t* b = sB + stage * B_TILE;
    if (TA)
      load_tile<A_ROWS, A_COLS, AS, NT>(a, ag, p.lda, k0, m0, K, M, p.vec, tid);
    else
      load_tile<A_ROWS, A_COLS, AS, NT>(a, ag, p.lda, m0, k0, M, K, p.vec, tid);
    if (TB)
      load_tile<B_ROWS, B_COLS, BS, NT>(b, bg, p.ldb, n0, k0, N, K, p.vec, tid);
    else
      load_tile<B_ROWS, B_COLS, BS, NT>(b, bg, p.ldb, k0, n0, K, N, p.vec, tid);
  };
  float acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage kt landed; stage kt - 1 is consumed
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load_stage(nxt % STAGES, nxt * BK);
    cp_async_commit();
    const uint16_t* a = sA + (kt % STAGES) * A_TILE;
    const uint16_t* b = sB + (kt % STAGES) * B_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // Fragments from the tiles as stored. Where the stored row runs
      // along K (A as [M, K], B as [N, K]) a pair of k is one 32-bit
      // load. A stored [K, M] is read by ldmatrix.trans (four 8x8
      // matrices; lane l addresses row l & 7 of matrix l >> 3); B stored
      // [K, N] by two 16-bit loads a register, which measured faster
      // than ldmatrix.trans there on the H100.
      const int q = lane >> 3, r8 = lane & 7;
      uint32_t af[FM][4], bf[FN][2];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int mb = wm * WTM + i * 16;
        if (TA) {
          ldsm_x4_t(af[i], a + (kk + r8 + (q >> 1) * 8) * AS + mb + (q & 1) * 8);
        } else {
          const uint16_t* ar = a + (mb + g) * AS + kk + 2 * t4;
          af[i][0] = *reinterpret_cast<const uint32_t*>(ar);
          af[i][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * AS);
          af[i][2] = *reinterpret_cast<const uint32_t*>(ar + 8);
          af[i][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * AS + 8);
        }
      }
#pragma unroll
      for (int j = 0; j < FN; j += 2) {   // two n tiles at a time
        const int nb = wn * WTN + j * 8;
        if (TB) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const uint16_t* br = b + (nb + jj * 8 + g) * BS + kk + 2 * t4;
            bf[j + jj][0] = *reinterpret_cast<const uint32_t*>(br);
            bf[j + jj][1] = *reinterpret_cast<const uint32_t*>(br + 8);
          }
        } else {   // B stored [K, N]: two 16-bit loads a register
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const uint16_t* bc = b + (kk + 2 * t4) * BS + nb + jj * 8 + g;
            bf[j + jj][0] = bc[0] | (uint32_t(bc[BS]) << 16);
            bf[j + jj][1] = bc[8 * BS] | (uint32_t(bc[9 * BS]) << 16);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          mma16<BF16>(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  const size_t cbase = (size_t)z * M * N;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * WTM + i * 16 + g + 8 * (e >> 1);
        const int col = n0 + wn * WTN + j * 8 + t4 * 2 + (e & 1);
        if (row >= M || col >= N) continue;
        const size_t at = cbase + (size_t)row * N + col;
        float v = acc[i][j][e];
        if (p.c0) v += load_as_float(p.c0, at, p.c_type);
        store_from_float(p.c, at, p.c_type, v);
      }
}

// ---------------------------------------------------------------------------
// fp32 or mixed operands: fp32 FMA. Element (r, c) of a stored operand
// at r * rs + c * cs, widened from its type.
// ---------------------------------------------------------------------------
struct StridedLoad {
  const void* base;
  long long rs, cs;
  int rows, cols, type;
  __device__ __forceinline__ float operator()(int r, int c) const {
    if (r >= rows || c >= cols) return 0.f;
    return load_as_float(base, (size_t)(r * rs + c * cs), type);
  }
};

__device__ __forceinline__ const void* offset(const void* p, long long n,
                                              int type) {
  return static_cast<const char*>(p) + n * (type == 0 ? 4 : 2);
}

__global__ void __launch_bounds__(kFfmaThreads)
mfa_gemm_ffma(GemmParams p, int ta, int tb) {
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * kFfmaBM, n0 = blockIdx.x * kFfmaBN;
  // A(m, k): stored [M, K] (row stride lda) or [K, M]; B(k, n): stored
  // [K, N] or [N, K].
  const StridedLoad A{offset(p.a, z * p.a_batch, p.a_type),
                      ta ? 1 : p.lda, ta ? p.lda : 1, p.M, p.K, p.a_type};
  const StridedLoad B{offset(p.b, z * p.b_batch, p.b_type),
                      tb ? 1 : p.ldb, tb ? p.ldb : 1, p.K, p.N, p.b_type};
  float acc[4][4], rs[4];
  ffma_mainloop<false>(A, B, m0, n0, p.K, acc, rs);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t cbase = (size_t)z * p.M * p.N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty * 4 + i, col = n0 + tx * 4 + j;
      if (row >= p.M || col >= p.N) continue;
      const size_t at = cbase + (size_t)row * p.N + col;
      float v = acc[i][j];
      if (p.c0) v += load_as_float(p.c0, at, p.c_type);
      store_from_float(p.c, at, p.c_type, v);
    }
}

template <bool BF16, int BM, int BN, int BK, int WM, int WN, int STAGES,
          bool TA, bool TB>
cudaError_t launch_mma(const GemmParams& p, int batch, cudaStream_t stream) {
  constexpr int A_TILE = TA ? BK * (BM + 8) : BM * (BK + 8);
  constexpr int B_TILE = TB ? BN * (BK + 8) : BK * (BN + 8);
  const size_t smem = 2 * STAGES * (A_TILE + B_TILE);
  auto kernel = mfa_gemm_mma<BF16, BM, BN, BK, WM, WN, STAGES, TA, TB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, batch);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool BF16, bool TA, bool TB>
cudaError_t launch_tile(const GemmParams& p, int batch, int tile,
                        cudaStream_t s) {
  // Tiles as ops/params.py::GEMM_TILES numbers them: 0 m128, 1 m64, 2 m16.
  if (tile == 0) return launch_mma<BF16, 128, 128, 32, 2, 4, 3, TA, TB>(p, batch, s);
  if (tile == 1) return launch_mma<BF16, 64, 64, 32, 2, 2, 3, TA, TB>(p, batch, s);
  if (tile == 2) return launch_mma<BF16, 16, 64, 64, 1, 4, 3, TA, TB>(p, batch, s);
  return cudaErrorInvalidValue;
}

template <bool BF16>
cudaError_t launch_t(const GemmParams& p, int batch, int ta, int tb, int tile,
                     cudaStream_t s) {
  if (ta && tb) return launch_tile<BF16, true, true>(p, batch, tile, s);
  if (ta) return launch_tile<BF16, true, false>(p, batch, tile, s);
  if (tb) return launch_tile<BF16, false, true>(p, batch, tile, s);
  return launch_tile<BF16, false, false>(p, batch, tile, s);
}

}  // namespace

// Types: 0 fp32, 1 bf16, 2 fp16. tile: 0 m128, 1 m64, 2 m16 (mma.sync,
// a_type == b_type in {1, 2}), 3 ffma. c0 may be null. lda / ldb are the
// stored operands' row strides, a_batch / b_batch their batch strides, in
// elements; C and C0 are contiguous [batch, M, N].
extern "C" int mfa_gemm(const void* a, const void* b, const void* c0,
                        void* c, int batch, int M, int N, int K,
                        long long lda, long long a_batch, long long ldb,
                        long long b_batch, int a_type, int b_type,
                        int c_type, int ta, int tb, int tile, void* stream) {
  GemmParams p{a, b, c0, c, M, N, K, lda, a_batch, ldb, b_batch,
               a_type, b_type, c_type, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > 65535 || M < 1 || N < 1 || K < 1)
    return cudaErrorInvalidValue;
  if (tile == 3) {
    const dim3 grid((N + kFfmaBN - 1) / kFfmaBN, (M + kFfmaBM - 1) / kFfmaBM,
                    batch);
    mfa_gemm_ffma<<<grid, kFfmaThreads, 0, s>>>(p, ta, tb);
    return cudaGetLastError();
  }
  if (a_type != b_type || (a_type != 1 && a_type != 2))
    return cudaErrorInvalidValue;
  // 16-byte copies: aligned bases and strides, and the stored contiguous
  // extents whole chunks of 8.
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b);
  const long long strides = lda | a_batch | ldb | b_batch;
  const int a_cols = ta ? M : K, b_cols = tb ? K : N;
  p.vec = ptrs % 16 == 0 && strides % 8 == 0 && a_cols % 8 == 0 &&
          b_cols % 8 == 0;
  if (a_type == 1) return launch_t<true>(p, batch, ta, tb, tile, s);
  return launch_t<false>(p, batch, ta, tb, tile, s);
}
