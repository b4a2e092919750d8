// INT4-weight matmul for Hopper (sm_90a): y = x W * scale, W streamed as
// packed nibbles and dequantized on chip.
//
// Replaces the TPU kernels mfa_tpu/kernels/quant_matmul.py::_qmm_kernel
// (signed nibbles) and ::_qmm_biased_kernel (nibbles q + 8, corrected by
// 8 * rowsum(x) in the epilogue), built by build_int4_matmul. The weight
// is half-split: in the port's layout [N, K/2] (mfa_tpu's [K/2, N] bytes,
// transposed so that a row of the B tile is contiguous along K), byte
// (n, i) holds W[i, n] in its low nibble and W[i + K/2, n] in its high
// nibble. So one packed tile feeds two products: x[:, i-block] with the
// low nibbles and x[:, K/2 + i-block] with the high ones, as on the TPU.
//
// Design: a CTA loops over K/2 in a ring of cp.async stages holding the
// packed bytes and both x slices. Warps widen their weight fragments in
// registers straight from 32-bit loads of packed bytes: a nibble u
// (signed: u ^ 8) is put into the bf16 bit pattern 0x4300 | u = 128 + u
// by one AND/XOR, and 136 (signed) or 128 (biased) is subtracted, exact
// in bf16, so the weight never exists in bf16 outside the registers, in
// shared or in device memory. The k slots of a quad are permuted the
// same way in x and W (below), so that one load feeds a whole fragment.
// Products are bf16 x widened nibble on mma.sync m16n8k16 with fp32
// accumulation. The biased layout sums x's rows from the same fragments;
// the epilogue computes (acc - 8 * rowsum) * scale (signed: acc *
// scale), in mfa_tpu's order, and casts once; the row sums come from the
// same x fragments through one more mma against ones. Prefill (M > 16)
// takes 64 x 128 blocks of y. Decode (M <= 16) computes y^T =
// W^T x^T so that 16 output channels fill the mma's row side and the
// tokens its 8-wide side; a CTA owns 32 channels (448 CTAs at N = 14336),
// streams 256 packed bytes a row per stage (more bytes in flight for a
// CTA that is alone on its SM), and its four warps split K, summing
// through shared memory at the end.
// fp32 activations run an FMA loop with the same epilogue.
//
// What bounds it on an H100: at decode (M = 4) the packed weight is the
// traffic, K * N / 2 bytes: 29.4 MB for 4096 -> 14336, 8.8 us at
// 3.35 TB/s, against 0.47 GFLOP (0.5 us): bytes. At prefill (M = 2048)
// the same shape is 240 GFLOP, 243 us at 989 TFLOP/s: operations. With
// N = 1024 decode still has only 32 CTAs for 132 SMs (split-K across CTAs
// is later work). No wgmma or TMA yet.

#include "matmul.cuh"

namespace {

using namespace mfa;

struct QmmParams {
  const void* x;         // [M, K] bf16 or fp32, contiguous
  const uint8_t* w;      // [N, K/2] packed nibbles, contiguous
  const float* scale;    // [N]
  void* y;               // [M, N], x's type
  int M, N, K;
};

// K slots. In each group of 16 packed columns kk..kk+15, thread t4 of a
// quad owns the four columns c = kk + 4 t4 .. c + 3 of x and of W, and
// puts them in the mma's k slots (2 t4, 2 t4 + 1) <- columns (c, c + 2)
// and (2 t4 + 8, 2 t4 + 9) <- (c + 1, c + 3). The same map on both
// operands leaves the dot product as it is, and it lets one 32-bit load
// of packed bytes and one 64-bit load of x feed whole fragments.

// Four packed bytes (columns c .. c + 3) → bf16 pairs of their low
// nibbles, lo[0] = (c, c + 2) and lo[1] = (c + 1, c + 3), and of their
// high nibbles, hi[0], hi[1]. A nibble u lands in the bf16 pattern
// 0x4300 | u = 128 + u (signed: u ^ 8 = q + 8 first), exact; 136
// (signed) or 128 (biased) is then subtracted, exact in bf16.
template <bool BIASED>
__device__ __forceinline__ void unpack4(uint32_t v, uint32_t (&lo)[2],
                                        uint32_t (&hi)[2]) {
  constexpr uint32_t kMask = 0x000F000Fu;
  constexpr uint32_t kMagic = BIASED ? 0x43004300u : 0x43084308u;
  uint32_t r[4] = {(v & kMask) ^ kMagic, ((v >> 8) & kMask) ^ kMagic,
                   ((v >> 4) & kMask) ^ kMagic, ((v >> 12) & kMask) ^ kMagic};
  const __nv_bfloat162 off = __float2bfloat162_rn(BIASED ? 128.f : 136.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 d =
        __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r[i]), off);
    r[i] = *reinterpret_cast<uint32_t*>(&d);
  }
  lo[0] = r[0];
  lo[1] = r[1];
  hi[0] = r[2];
  hi[1] = r[3];
}

// x columns c .. c + 3 of one row → the pairs (c, c + 2) and (c + 1, c + 3).
__device__ __forceinline__ void x_slots(const uint16_t* p, uint32_t& s0,
                                        uint32_t& s8) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  s0 = __byte_perm(w.x, w.y, 0x5410);
  s8 = __byte_perm(w.x, w.y, 0x7632);
}

__device__ __forceinline__ float pair_sum(uint32_t v) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  return f.x + f.y;
}

// One stage of cp.async copies: x rows [m0, m0 + XR) of both K slices
// (columns kp0 .. kp0 + BK and K/2 + kp0 ..) and packed rows
// [n0, n0 + WR); outside the problem reads zero. Row strides XS (x,
// elements) and WS (bytes) are padded so that the fragment loads of
// eight rows fall in distinct banks.
template <int XR, int WR, int BK, int NT>
__device__ __forceinline__ void load_stage(const QmmParams& p, uint16_t* xs,
                                           uint8_t* ws, int m0, int n0,
                                           int kp0, int tid) {
  constexpr int XS = 2 * BK + 16, WS = BK + 16;
  const int Kh = p.K / 2;
  const uint16_t* xg = static_cast<const uint16_t*>(p.x);
  constexpr int XCH = 2 * BK / 8;
  for (int i = tid; i < XR * XCH; i += NT) {
    const int r = i / XCH, c = (i % XCH) * 8;
    const int kc = kp0 + (c % BK);
    const bool in = m0 + r < p.M && kc < Kh;
    const uint16_t* src =
        xg + (size_t)(m0 + r) * p.K + kc + (c >= BK ? Kh : 0);
    cp_async16(xs + r * XS + c, in ? src : xg, in ? 16 : 0);
  }
  constexpr int WCH = BK / 16;
  for (int i = tid; i < WR * WCH; i += NT) {
    const int r = i / WCH, c = (i % WCH) * 16;
    const bool in = n0 + r < p.N && kp0 + c < Kh;
    const uint8_t* src = p.w + (size_t)(n0 + r) * Kh + kp0 + c;
    cp_async16(ws + r * WS + c, in ? src : p.w, in ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// Prefill: bf16 x, mma.sync with x as A (rows = tokens) and the widened
// weight as B. A BM x BN block of y per CTA, WM x WN warps.
// ---------------------------------------------------------------------------
template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool BIASED>
__global__ void __launch_bounds__(WM * WN * 32)
qmm_int4_mma(QmmParams p) {
  constexpr int NT = WM * WN * 32;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int FM = WTM / 16, FN = WTN / 8;
  constexpr int XS = 2 * BK + 16, WS = BK + 16;
  constexpr int X_TILE = BM * XS;   // uint16 elements
  constexpr int W_TILE = BN * WS;   // bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sX = reinterpret_cast<uint16_t*>(smem_raw);
  uint8_t* sW = reinterpret_cast<uint8_t*>(sX + STAGES * X_TILE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int M = p.M, N = p.N, Kh = p.K / 2;

  // Biased layout: rs[i] = x's row sums of m tile i, from an mma against
  // a B fragment of ones (every column of the 16 x 8 result is the sum).
  constexpr uint32_t kOnes = 0x3F803F80u;   // bf16 (1, 1)
  float acc[FM][FN][4];
  float rs[FM][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      rs[i][e] = 0.f;
#pragma unroll
      for (int j = 0; j < FN; ++j) acc[i][j][e] = 0.f;
    }

  const int nk = (Kh + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<BM, BN, BK, NT>(p, sX + s * X_TILE, sW + s * W_TILE, m0, n0,
                                 s * BK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage kt landed; stage kt - 1 is consumed
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_stage<BM, BN, BK, NT>(p, sX + (nxt % STAGES) * X_TILE,
                                 sW + (nxt % STAGES) * W_TILE, m0, n0,
                                 nxt * BK, tid);
    cp_async_commit();
    const uint16_t* xs = sX + (kt % STAGES) * X_TILE;
    const uint8_t* ws = sW + (kt % STAGES) * W_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][FM][4];   // [low / high K slice][m tile]
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const uint16_t* xr = xs + (wm * WTM + i * 16 + g) * XS + kk + 4 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          x_slots(xr + h * BK, a[h][i][0], a[h][i][2]);
          x_slots(xr + h * BK + 8 * XS, a[h][i][1], a[h][i][3]);
          if (BIASED) mma_bf16(rs[i], a[h][i], kOnes, kOnes);
        }
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        uint32_t lo[2], hi[2];
        unpack4<BIASED>(*reinterpret_cast<const uint32_t*>(
                            ws + (wn * WTN + j * 8 + g) * WS + kk + 4 * t4),
                        lo, hi);
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          mma_bf16(acc[i][j], a[0][i], lo[0], lo[1]);
          mma_bf16(acc[i][j], a[1][i], hi[0], hi[1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y);
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * WTM + i * 16 + g + 8 * (e >> 1);
        const int col = n0 + wn * WTN + j * 8 + t4 * 2 + (e & 1);
        if (row >= M || col >= N) continue;
        float v = acc[i][j][e];
        if (BIASED) v -= 8.f * rs[i][e];
        y[(size_t)row * N + col] = __float2bfloat16(v * p.scale[col]);
      }
}

// ---------------------------------------------------------------------------
// Decode (M <= 8 TT tokens): the product transposed, y^T = W^T x^T, so
// that output channels fill the mma's 16-row side and the few tokens its
// 8-wide side (a 16-row x tile would waste 12 of 16 rows at M = 4). A
// CTA owns BN channels; its KW warps split each stage's K columns and
// sum their partial products through shared memory at the end.
// ---------------------------------------------------------------------------
template <int TT, int BN, int BK, int KW, int STAGES, bool BIASED>
__global__ void __launch_bounds__(KW * 32)
qmm_int4_decode(QmmParams p) {
  constexpr int NT = KW * 32;
  constexpr int FT = TT / 8, FC = BN / 16;   // token n-tiles, channel m-tiles
  constexpr int XS = 2 * BK + 16, WS = BK + 16;
  constexpr int X_TILE = TT * XS, W_TILE = BN * WS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sX = reinterpret_cast<uint16_t*>(smem_raw);
  uint8_t* sW = reinterpret_cast<uint8_t*>(sX + STAGES * X_TILE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int M = p.M, N = p.N, Kh = p.K / 2;

  float acc[FC][FT][4];
  float rs[FT];   // token g of each token tile (biased layout)
#pragma unroll
  for (int t = 0; t < FT; ++t) {
    rs[t] = 0.f;
#pragma unroll
    for (int i = 0; i < FC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;
  }

  const int nk = (Kh + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<TT, BN, BK, NT>(p, sX + s * X_TILE, sW + s * W_TILE, 0, n0,
                                 s * BK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_stage<TT, BN, BK, NT>(p, sX + (nxt % STAGES) * X_TILE,
                                 sW + (nxt % STAGES) * W_TILE, 0, n0,
                                 nxt * BK, tid);
    cp_async_commit();
    const uint16_t* xs = sX + (kt % STAGES) * X_TILE;
    const uint8_t* ws = sW + (kt % STAGES) * W_TILE;
#pragma unroll
    for (int kk = 16 * warp; kk < BK; kk += 16 * KW) {
      uint32_t b[2][FT][2];   // x: [K slice][token tile]
#pragma unroll
      for (int t = 0; t < FT; ++t) {
        const uint16_t* xr = xs + (t * 8 + g) * XS + kk + 4 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          x_slots(xr + h * BK, b[h][t][0], b[h][t][1]);
          if (BIASED) rs[t] += pair_sum(b[h][t][0]) + pair_sum(b[h][t][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < FC; ++i) {
        const uint8_t* wr = ws + (i * 16 + g) * WS + kk + 4 * t4;
        uint32_t lo0[2], hi0[2], lo1[2], hi1[2];
        unpack4<BIASED>(*reinterpret_cast<const uint32_t*>(wr), lo0, hi0);
        unpack4<BIASED>(*reinterpret_cast<const uint32_t*>(wr + 8 * WS), lo1,
                        hi1);
        const uint32_t alo[4] = {lo0[0], lo1[0], lo0[1], lo1[1]};
        const uint32_t ahi[4] = {hi0[0], hi1[0], hi0[1], hi1[1]};
#pragma unroll
        for (int t = 0; t < FT; ++t) {
          mma_bf16(acc[i][t], alo, b[0][t][0], b[0][t][1]);
          mma_bf16(acc[i][t], ahi, b[1][t][0], b[1][t][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the stage buffers become the reduction buffer

  // Sum the KW warps' partial products (and token row sums).
  float* red = reinterpret_cast<float*>(smem_raw);
  constexpr int PER = FC * FT * 4;
#pragma unroll
  for (int i = 0; i < FC; ++i)
#pragma unroll
    for (int t = 0; t < FT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((warp * PER) + (i * FT + t) * 4 + e) * 32 + lane] = acc[i][t][e];
  float* rsum = red + KW * PER * 32;   // [KW][TT]
  if (BIASED) {
#pragma unroll
    for (int t = 0; t < FT; ++t) {
      float v = rs[t];
      v += __shfl_xor_sync(kFull, v, 1);
      v += __shfl_xor_sync(kFull, v, 2);
      if (t4 == 0) rsum[warp * TT + t * 8 + g] = v;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y);
#pragma unroll
  for (int i = 0; i < FC; ++i)
#pragma unroll
    for (int t = 0; t < FT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < KW; ++w)
          v += red[((w * PER) + (i * FT + t) * 4 + e) * 32 + lane];
        const int ch = n0 + i * 16 + g + 8 * (e >> 1);
        const int tok = t * 8 + t4 * 2 + (e & 1);
        if (ch >= N || tok >= M) continue;
        if (BIASED) {
          float r = 0.f;
#pragma unroll
          for (int w = 0; w < KW; ++w) r += rsum[w * TT + tok];
          v -= 8.f * r;
        }
        y[(size_t)tok * N + ch] = __float2bfloat16(v * p.scale[ch]);
      }
}

// ---------------------------------------------------------------------------
// fp32 activations: FMA. B(k, n) is the widened nibble (biased: q + 8).
// ---------------------------------------------------------------------------
struct XLoad {
  const float* x;
  int M, K;
  __device__ __forceinline__ float operator()(int m, int k) const {
    return (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
  }
};

template <bool BIASED>
struct NibbleLoad {
  const uint8_t* w;
  int K, N;
  __device__ __forceinline__ float operator()(int k, int n) const {
    if (k >= K || n >= N) return 0.f;
    const int kh = K / 2;
    const unsigned byte = w[(size_t)n * kh + (k < kh ? k : k - kh)];
    const int u = k < kh ? byte & 15 : byte >> 4;
    return static_cast<float>(BIASED ? u : (u ^ 8) - 8);
  }
};

template <bool BIASED>
__global__ void __launch_bounds__(kFfmaThreads)
qmm_int4_ffma(QmmParams p) {
  const int m0 = blockIdx.y * kFfmaBM, n0 = blockIdx.x * kFfmaBN;
  const XLoad A{static_cast<const float*>(p.x), p.M, p.K};
  const NibbleLoad<BIASED> B{p.w, p.K, p.N};
  float acc[4][4], rs[4];
  ffma_mainloop<BIASED>(A, B, m0, n0, p.K, acc, rs);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* y = static_cast<float*>(p.y);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty * 4 + i, col = n0 + tx * 4 + j;
      if (row >= p.M || col >= p.N) continue;
      float v = acc[i][j];
      if (BIASED) v -= 8.f * rs[i];
      y[(size_t)row * p.N + col] = v * p.scale[col];
    }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   const QmmParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

constexpr size_t stage_bytes(int rows, int cols, int bk) {
  return 2 * rows * (2 * bk + 16) + cols * (bk + 16);
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool BIASED>
cudaError_t launch_mma(const QmmParams& p, cudaStream_t s) {
  return launch(qmm_int4_mma<BM, BN, BK, WM, WN, STAGES, BIASED>,
                dim3((p.N + BN - 1) / BN, (p.M + BM - 1) / BM), WM * WN * 32,
                STAGES * stage_bytes(BM, BN, BK), p, s);
}

template <int TT, int BN, int BK, int KW, int STAGES, bool BIASED>
cudaError_t launch_decode(const QmmParams& p, cudaStream_t s) {
  if (p.M > TT) return cudaErrorInvalidValue;
  constexpr size_t ring = STAGES * stage_bytes(TT, BN, BK);
  constexpr size_t red = sizeof(float) * KW * (BN * TT + TT);
  return launch(qmm_int4_decode<TT, BN, BK, KW, STAGES, BIASED>,
                dim3((p.N + BN - 1) / BN), KW * 32, ring > red ? ring : red,
                p, s);
}

template <bool BIASED>
cudaError_t launch_tile(const QmmParams& p, int x_bf16, int tile,
                        cudaStream_t s) {
  // Tiles as ops/params.py::QMM_TILES numbers them: 0 d8, 1 d16 (decode),
  // 2 m64 (prefill), 3 ffma.
  if (x_bf16 && tile == 0) return launch_decode<8, 32, 256, 4, 4, BIASED>(p, s);
  if (x_bf16 && tile == 1) return launch_decode<16, 32, 256, 4, 4, BIASED>(p, s);
  if (x_bf16 && tile == 2)
    return launch_mma<64, 128, 32, 2, 2, 4, BIASED>(p, s);
  if (!x_bf16 && tile == 3) {
    const dim3 grid((p.N + kFfmaBN - 1) / kFfmaBN,
                    (p.M + kFfmaBM - 1) / kFfmaBM);
    qmm_int4_ffma<BIASED><<<grid, kFfmaThreads, 0, s>>>(p);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x [M, K] (bf16: x_bf16 = 1, else fp32), w [N, K/2] packed, scale [N]
// fp32, y [M, N] in x's type; all contiguous. K % 32 == 0 (whole 16-byte
// copies of both x slices and the packed rows); x and w 16-byte aligned.
extern "C" int mfa_int4_matmul(const void* x, const void* w,
                               const void* scale, void* y, int M, int N,
                               int K, int x_bf16, int biased, int tile,
                               void* stream) {
  if (M < 1 || N < 1 || K < 32 || K % 32 != 0 ||
      (M + 15) / 16 > 65535)
    return cudaErrorInvalidValue;
  const QmmParams p{x, static_cast<const uint8_t*>(w),
                    static_cast<const float*>(scale), y, M, N, K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return biased ? launch_tile<true>(p, x_bf16, tile, s)
                : launch_tile<false>(p, x_bf16, tile, s);
}
