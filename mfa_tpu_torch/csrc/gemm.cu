// Batched GEMM for Hopper (sm_90a): C[b] = op(A[b]) op(B[b]) (+ C0[b]),
// fp32 accumulation, all four transpose states.
//
// Replaces the TPU kernel mfa_tpu/kernels/gemm_kernel.py::_gemm_kernel
// (built by build_gemm; a grid of (batch, M, N, K) blocks with the fp32
// accumulator carried in VMEM across the sequential K axis). Here a CTA
// loops over K inside, through a ring of shared-memory stages. Transposes
// are read through the stored layout: each tile lands in shared memory as
// it is stored and is read from there in the orientation the product
// needs, so no operand is copied. Ragged edges arrive as zeros (TMA's
// fill or zero-filled copies), never padded in device memory. C0, when given, is read in C's
// type and added to the fp32 sum before the one cast (mfa_tpu casts C0 to
// the output type first, too).
//
// What bounds it on an H100: at 4096^3 in bf16 the product is 137 GFLOP,
// 139 us at the 989 TFLOP/s tensor-core peak, against 100 MB of operands
// (30 us at 3.35 TB/s): the bound is operations. fp32 at 1536^3 is bound
// by the 67 TFLOP/s of fp32 FMA.
//
// Two bf16 operands whose layout TMA can map (16-byte-aligned bases, row
// and batch strides of whole 16 bytes: kernels/gemm_kernel.py::
// tma_mappable) with M > 16 run mfa_gemm_wgmma, warp-specialised and
// persistent, 384 threads as K1, K3 and K4 (csrc/hopper.cuh):
// - One producer thread streams the A and B tiles of each 64-deep k step
//   by TMA (3-D maps over the stored [batch, rows, cols] operands, boxes
//   of 64 contiguous values, 128-byte-swizzled panels; rows and columns
//   past the problem arrive as zeros) into a ring of `stages` stages with
//   one full and one empty mbarrier a stage.
// - Two consumer warpgroups (setmaxnreg 240 / 24) own 64 rows each of a
//   128 x BN tile of C and run every product on wgmma m64nBNk16 with fp32
//   accumulators, reading each operand in the order it is stored: A
//   stored [M, K] and B stored [N, K] as K-major tiles, A stored [K, M]
//   and B stored [K, N] as MN-major ones (descriptor TA / TB = 1), so no
//   operand is copied or transposed in device memory.
// - One CTA a streaming multiprocessor walks the output tiles in bands of
//   `group` tile rows (ops/params.py::GEMM_TILE_GROUP), column by column
//   within a band, then the batch; the producer fills the ring for the
//   next tile while the consumers store this one.
// - Epilogue from registers: column pairs, C0 rounded to C's type and
//   added in fp32, one cast; rows past M, columns past N never stored.
// Tiles (ops/params.py::GEMM_TILES): w256 (128 x 256, 4 stages, 192 KB)
// and w128 (128 x 128, 6 stages), chosen by the rounds of one tile an SM
// the walk takes (ops/descriptors.py); at 4096^3 w256 makes 512 tiles,
// 3.88 waves of 132 CTAs (97% of the last wave busy). Measured on the
// H100 (utils/bwd_tuning.py sweep --only matmul): 3 and 4 stages, and
// bands of 1-16 tile rows, alike within 1%; a 2-CTA cluster sharing the
// B tile by TMA multicast, no faster (L2 does not bound it).
//
// Everything else keeps the first cut: bf16 operands TMA cannot map (odd
// strides, misaligned views), a decode-sized M (<= 16, tile m16) and fp16
// run warp-level mma.sync m16n8k16 fed by cp.async into padded tiles
// (32-bit loads where a tile's rows run along K, ldmatrix.trans for A
// stored [K, M], 16-bit loads for B stored [K, N]); one CTA per (batch,
// M block, N block), the batch on grid.z. fp32 and mixed fp32/bf16
// operands run an FMA loop in full fp32 (mfa_tpu asks for
// Precision.HIGHEST for fp32, so TF32 tensor cores are out; a bf16 operand
// widens to fp32 exactly). The tile comes from
// ops/descriptors.py::GEMMDescriptor.kernel_descriptor.

#include "hopper.cuh"
#include "matmul.cuh"

namespace {

using namespace mfa;
using namespace mfa::hopper;
using bf16 = __nv_bfloat16;

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
  int batch;
  int stages, group;            // wgmma kernel: ring depth, tile-walk band
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

// ---------------------------------------------------------------------------
// Two bf16 operands on wgmma: the warp-specialised persistent kernel (see
// the note at the top). A CTA tile is 128 rows of C (64 a consumer
// warpgroup) by BN columns; K steps by 64.
// ---------------------------------------------------------------------------
constexpr int kWgBM = 128, kWgBK = 64;

// Shared memory: `stages` stages of an A tile [128 x 64] and a B tile
// [BN x 64], each as stored (K-major: rows of 64 K values; MN-major: 64-K-
// row panels of 64 M or N values), then the mbarriers full[stages] and
// empty[stages] (ops/params.py::gemm_smem_bytes mirrors this).
__host__ __device__ constexpr int wg_stage_bytes(int bn) {
  return (kWgBM + bn) * kWgBK * 2;
}

__host__ __device__ constexpr int wg_smem_bytes(int bn, int stages) {
  return stages * (wg_stage_bytes(bn) + 16) + kAlignSlack;
}

// Pairs of C's type <-> fp32.
template <typename T>
struct Pair;

template <>
struct Pair<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  static __device__ __forceinline__ float widen(float x) { return x; }
  static __device__ __forceinline__ float narrow(float x) { return x; }
};

template <>
struct Pair<bf16> {
  static __device__ __forceinline__ float2 load(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float widen(bf16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ bf16 narrow(float x) {
    return __float2bfloat16(x);
  }
};

template <>
struct Pair<__half> {
  static __device__ __forceinline__ float2 load(const __half* p) {
    return __half22float2(*reinterpret_cast<const __half2*>(p));
  }
  static __device__ __forceinline__ void store(__half* p, float a, float b) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
  }
  static __device__ __forceinline__ float widen(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half narrow(float x) {
    return __float2half(x);
  }
};

// A warpgroup's accumulator (rows row0 and row0 + 8 of each warp's 16,
// columns col0 + 8 j + 2 t4 and + 1) into C of type T, C0 (in C's type)
// added in fp32 first, one cast; rows past M and columns past N are not
// stored. An even N makes each column pair one aligned access.
template <typename T, int NJ>
__device__ __forceinline__ void store_acc(const GemmParams& p,
                                          const float (&acc)[NJ][4],
                                          size_t cz, int row0, int col0) {
  T* c = static_cast<T*>(p.c);
  const T* c0 = static_cast<const T*>(p.c0);
  const bool pair = (p.N & 1) == 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h, col = col0 + 8 * j;
      if (row < p.M && col < p.N) {
        const size_t at = cz + (size_t)row * p.N + col;
        float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
        if (pair) {
          if (c0) {
            const float2 f = Pair<T>::load(c0 + at);
            v0 += f.x;
            v1 += f.y;
          }
          Pair<T>::store(c + at, v0, v1);
        } else {
          if (c0) v0 += Pair<T>::widen(c0[at]);
          c[at] = Pair<T>::narrow(v0);
          if (col + 1 < p.N) {
            if (c0) v1 += Pair<T>::widen(c0[at + 1]);
            c[at + 1] = Pair<T>::narrow(v1);
          }
        }
      }
    }
  }
}

// TA: A stored [K, M] (MN-major tiles); TB: B stored [N, K] (K-major).
template <int BN, bool TA, bool TB>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
mfa_gemm_wgmma(const GemmParams p, const __grid_constant__ CUtensorMap ma,
               const __grid_constant__ CUtensorMap mb) {
  constexpr int A_BYTES = kWgBM * kWgBK * 2, STAGE = wg_stage_bytes(BN);
  constexpr int PANEL = kWgBK * kPanelBytes;   // one 64-K-row panel
  const int S = p.stages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S * STAGE);
  uint64_t* empty = full + S;

  const int tiles_m = (p.M + kWgBM - 1) / kWgBM;
  const int tiles_n = (p.N + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n * p.batch;
  const int nk = (p.K + kWgBK - 1) / kWgBK;
  const int tid = threadIdx.x, wg = warpgroup_index();
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: the A and B tiles of every k step of every tile of this
    // CTA's walk, into the ring; a stage is refilled once both consumer
    // warpgroups have released it.
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 2 * kWgThreads) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int z, mi, ni;
        tile_walk(t, tiles_m, tiles_n, p.group, z, mi, ni);
        const int m0 = mi * kWgBM, n0 = ni * BN;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int st = it % S, k0 = kb * kWgBK;
          mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
          unsigned char* a = sm + st * STAGE;
          unsigned char* b = a + A_BYTES;
          mbar_expect_tx(&full[st], STAGE);
          if (TA) {
#pragma unroll
            for (int pn = 0; pn < kWgBM / 64; ++pn)
              tma_load_3d(a + pn * PANEL, &ma, &full[st], m0 + 64 * pn, k0,
                          z);
          } else {
            tma_load_3d(a, &ma, &full[st], k0, m0, z);
          }
          if (TB) {
            tma_load_3d(b, &mb, &full[st], k0, n0, z);
          } else {
#pragma unroll
            for (int pn = 0; pn < BN / 64; ++pn)
              tma_load_3d(b + pn * PANEL, &mb, &full[st], n0 + 64 * pn, k0,
                          z);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg, lane = tid & 31, wi = (tid % kWgThreads) >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    float acc[BN / 8][4];
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int z, mi, ni;
      tile_walk(t, tiles_m, tiles_n, p.group, z, mi, ni);
      // One commit group a k step, the next issued before the last one is
      // waited for; a stage is released once its products have completed.
      // The first k step overwrites the accumulator (scale_d = 0).
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int st = it % S;
        mbar_wait(&full[st], (it / S) & 1);
        // This warpgroup's 64 rows of A: rows 64 w.. of a K-major tile,
        // panel w of an MN-major one; both start 8 KB in.
        const uint32_t a = opaque(smem_addr(sm + st * STAGE)) + w * PANEL;
        const uint32_t b = opaque(smem_addr(sm + st * STAGE + A_BYTES));
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) {
          const uint64_t da = TA ? desc_b128(a + kk * 2048, PANEL)
                                 : desc_b128(a + kk * 32, 16);
          const uint64_t db = TB ? desc_b128(b + kk * 32, 16)
                                 : desc_b128(b + kk * 2048, PANEL);
          // wgmma's transpose flags: 1 = MN-major, so A stored [K, M] and
          // B stored [K, N].
          Wgmma<BN>::template ss<TA, !TB>(acc, da, db, kb > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(acc);
        if (kb > 0 && lane == 0) mbar_arrive(&empty[(it + S - 1) % S]);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[(it + S - 1) % S]);

      // Epilogue from registers: each thread's column pairs, C0 added in
      // fp32 after its rounding to C's type, one cast; rows past M and
      // columns past N are never stored. The producer is meanwhile
      // filling the ring for this CTA's next tile.
      const int row0 = mi * kWgBM + 64 * w + 16 * wi + g;
      const int col0 = ni * BN + 2 * t4;
      const size_t cz = (size_t)z * p.M * p.N;
      if (p.c_type == 0)
        store_acc<float>(p, acc, cz, row0, col0);
      else if (p.c_type == 1)
        store_acc<bf16>(p, acc, cz, row0, col0);
      else
        store_acc<__half>(p, acc, cz, row0, col0);
    }
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

// The tensor map of a stored bf16 operand [batch, rows, cols] (cols
// contiguous, row stride ld, batch stride bs, in elements) with boxes of
// 64 columns by box_rows rows; raises (returns an error) where TMA cannot
// map it, never falling back.
bool operand_map(CUtensorMap* map, const void* base, int rows, int cols,
                 long long ld, long long bs, int batch, int box_rows) {
  const uint64_t s1 = (uint64_t)ld * 2;
  const uint64_t s2 = batch > 1 ? (uint64_t)bs * 2 : s1 * rows;
  return tile_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, cols, rows,
                     batch, s1, s2, 64, box_rows, 1,
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int BN, bool TA, bool TB>
cudaError_t launch_wgmma(GemmParams p, cudaStream_t stream) {
  const int smem = wg_smem_bytes(BN, p.stages);
  if (p.stages < 2 || smem > kSmemOptin || p.group < 1)
    return cudaErrorInvalidValue;
  // K-major tiles: boxes of 64 K values by the tile's rows; MN-major: 64
  // M or N values by 64 K rows.
  CUtensorMap ma, mb;
  const bool ok_a =
      TA ? operand_map(&ma, p.a, p.K, p.M, p.lda, p.a_batch, p.batch, kWgBK)
         : operand_map(&ma, p.a, p.M, p.K, p.lda, p.a_batch, p.batch, kWgBM);
  const bool ok_b =
      TB ? operand_map(&mb, p.b, p.N, p.K, p.ldb, p.b_batch, p.batch, BN)
         : operand_map(&mb, p.b, p.K, p.N, p.ldb, p.b_batch, p.batch, kWgBK);
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  const long long tiles = (long long)((p.M + kWgBM - 1) / kWgBM) *
                          ((p.N + BN - 1) / BN) * p.batch;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  const int grid = persistent_ctas((int)tiles);
  if (grid < 1) return cudaErrorInvalidValue;
  auto kernel = mfa_gemm_wgmma<BN, TA, TB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWgmmaThreads, smem, stream>>>(p, ma, mb);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_wgmma_t(const GemmParams& p, int ta, int tb,
                           cudaStream_t s) {
  if (ta && tb) return launch_wgmma<BN, true, true>(p, s);
  if (ta) return launch_wgmma<BN, true, false>(p, s);
  if (tb) return launch_wgmma<BN, false, true>(p, s);
  return launch_wgmma<BN, false, false>(p, s);
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
// a_type == b_type in {1, 2}), 3 ffma, 4 w256 and 5 w128 (wgmma, 128 x 256
// and 128 x 128 CTA tiles, a_type == b_type == 1, operands TMA can map:
// 16-byte-aligned bases, row and batch strides of whole 16 bytes; a ring
// of `stages` stages, tiles walked in bands of `group` tile rows). c0 may
// be null. lda / ldb are the stored operands' row strides, a_batch /
// b_batch their batch strides, in elements; C and C0 are contiguous
// [batch, M, N].
extern "C" int mfa_gemm(const void* a, const void* b, const void* c0,
                        void* c, int batch, int M, int N, int K,
                        long long lda, long long a_batch, long long ldb,
                        long long b_batch, int a_type, int b_type,
                        int c_type, int ta, int tb, int tile, int stages,
                        int group, void* stream) {
  GemmParams p{a, b, c0, c, M, N, K, lda, a_batch, ldb, b_batch,
               a_type, b_type, c_type, 0, batch, stages, group};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  if (tile == 4 || tile == 5) {
    if (a_type != 1 || b_type != 1) return cudaErrorInvalidValue;
    return tile == 4 ? launch_wgmma_t<256>(p, ta, tb, s)
                     : launch_wgmma_t<128>(p, ta, tb, s);
  }
  if (batch > 65535) return cudaErrorInvalidValue;
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
