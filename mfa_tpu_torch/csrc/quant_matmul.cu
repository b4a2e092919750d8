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
// Prefill (M > 16 rows of bf16 x: kernels/quant_matmul.py::int4_tile)
// runs qmm_int4_wgmma, warp-specialised and persistent like K7's wgmma
// kernel (csrc/hopper.cuh), on the product transposed, y^T = W^T x^T:
// - One producer thread streams, for each step of 64 packed columns, x's
//   low and high K slices by TMA (x viewed as [M, 2, K/2], so neither
//   slice reads past its half; boxes of 64 values by 128 tokens,
//   128-byte-swizzled) and the packed tile [BC channels x 64 bytes]
//   (64-byte-swizzled), into a ring of `stages` stages.
// - Two consumer warpgroups own BC / 2 output channels each, as blocks
//   of 64 (BC = 128 or 256, tiles w128 and w256 of ops/params.py: the
//   larger reads 40% fewer operand bytes a product and wins wherever its
//   tiles fill the card; kernels/quant_matmul.py::int4_tile). A thread loads
//   its fragment's packed bytes from shared memory in wgmma's natural k
//   order (one 16-bit load a pair of k) and widens both nibbles of each
//   byte in registers: a nibble u (signed: u ^ 8) is put into the bf16
//   bit pattern 0x4300 | u = 128 + u and 136 (signed) or 128 (biased) is
//   subtracted, exact in bf16, so the weight never exists in bf16 outside
//   the registers. The widened weight is wgmma's register A operand
//   (m64 channels), the x slice its B operand from shared memory (K-major,
//   N = the tokens): per step and block four k16 products against the
//   low nibbles and x's low slice, four against the high nibbles and the
//   high slice. While one warpgroup widens, the other's products run.
// - Epilogue: in the accumulator the scale is per row and 8 rowsum(x) per
//   column; (acc - 8 rowsum(x)) * scale (signed: acc * scale) in
//   mfa_tpu's order, one cast, with rowsum(x) reduced once before the
//   launch as mfa_tpu does (kernels/quant_matmul.py; times 8 here, exact);
//   y^T is staged transposed in shared memory and stored as y [M, N], 16
//   bytes along each token's channels.
//
// Decode (M <= 16) keeps the first cut: y^T on mma.sync so that 16
// output channels fill the mma's row side and the tokens its 8-wide side;
// a CTA owns 32 channels (448 CTAs at N = 14336), streams 256 packed bytes
// a row per stage by cp.async (more bytes in flight for a CTA that is
// alone on its SM), and its four warps split K, summing through shared
// memory at the end. It permutes the k slots of a quad the same way in x
// and W (below), so that one 32-bit load of packed bytes feeds a whole
// fragment, and sums the biased layout's row sums from the same x
// fragments in registers. Prefill has no mma.sync tile: the wgmma tile
// measured faster at every M from 17 to 2048 on the H100 (utils/
// bwd_tuning.py sweep --only matmul). fp32 activations run an FMA loop
// with the same epilogue.
//
// What bounds it on an H100: at decode (M = 4) the packed weight is the
// traffic, K * N / 2 bytes: 29.4 MB for 4096 -> 14336, 8.8 us at
// 3.35 TB/s, against 0.47 GFLOP (0.5 us): bytes. At prefill (M = 2048)
// the same shape is 240 GFLOP, 243 us at 989 TFLOP/s: operations. With
// N = 1024 decode still has only 32 CTAs for 132 SMs (split-K across CTAs
// is later work).

#include "hopper.cuh"
#include "matmul.cuh"

namespace {

using namespace mfa;
using namespace mfa::hopper;
using bf16 = __nv_bfloat16;

struct QmmParams {
  const void* x;         // [M, K] bf16 or fp32, contiguous
  const uint8_t* w;      // [N, K/2] packed nibbles, contiguous
  const float* scale;    // [N]
  const float* rs;       // wgmma tile, biased: rowsum(x) [M], fp32
  void* y;               // [M, N], x's type
  int M, N, K;
  int stages, group;     // wgmma tile: ring depth, tile-walk band
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
// Prefill on wgmma (bf16 x, M above the crossover of kernels/quant_matmul.py
// ::int4_tile): the product transposed, y^T = W^T x^T, warp-specialised and
// persistent (see the note at the top). A CTA tile is 128 output channels
// (64 a consumer warpgroup, wgmma's M side) by BT tokens (its N side); K
// steps by 64 packed bytes, that is 64 values of each K half.
// ---------------------------------------------------------------------------
constexpr int kQK = 64;        // packed bytes (values of each K half) a step
constexpr int kStoreBar = 1;   // named barrier of the two consumer warpgroups

// Shared memory of a CTA of BC channels by BT tokens: `stages` stages of
// x's low and high K slices [BT x 64] (128-byte-swizzled) and the packed
// weight tile [BC x 64 bytes] (64-byte-swizzled), the epilogue's staging
// tile y [BT x (BC + 8)] bf16, then the mbarriers full[stages] and
// empty[stages] (ops/params.py::qmm_smem_bytes mirrors this).
__host__ __device__ constexpr int qw_stage_bytes(int bt, int bc) {
  return 2 * bt * kPanelBytes + bc * kQK;
}

__host__ __device__ constexpr int qw_smem_bytes(int bt, int bc, int stages) {
  return stages * (qw_stage_bytes(bt, bc) + 16) + bt * (bc + 8) * 2 +
         kAlignSlack;
}

// The A fragments (wgmma's m64k16 register operand, mma.sync's layout) of
// the low and the high nibbles of one k step, from the packed tile in
// shared memory: rows r0 and r0 + 8 (channels), packed columns c + 2 t4,
// + 1 and c + 2 t4 + 8, + 9 (k), each pair one 16-bit load, in the
// natural k order in which wgmma reads x. The tile's 64-byte rows are
// 64-byte-swizzled (16-byte chunk ^ (row / 2) % 4): the eight rows a load
// instruction touches fall in eight distinct groups of banks.
template <bool BIASED>
__device__ __forceinline__ void widen_kstep(const unsigned char* wt, int r0,
                                            int c, uint32_t (&lo)[4],
                                            uint32_t (&hi)[4]) {
  constexpr uint32_t kMask = 0x000F000Fu;
  constexpr uint32_t kMagic = BIASED ? 0x43004300u : 0x43084308u;
  const __nv_bfloat162 off = __float2bfloat162_rn(BIASED ? 128.f : 136.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 8 * (i & 1), col = c + 8 * (i >> 1);
    const uint32_t v = *reinterpret_cast<const uint16_t*>(
        wt + r * kQK + (((col >> 4) ^ ((r >> 1) & 3)) << 4) + (col & 15));
    // bytes (k, k + 1) -> bits 0-7 and 16-23, then each nibble into the
    // bf16 pattern 0x4300 | u = 128 + u (signed: u ^ 8), less 128 or 136.
    const uint32_t t = __byte_perm(v, 0, 0x4140);
    uint32_t l = (t & kMask) ^ kMagic, h = ((t >> 4) & kMask) ^ kMagic;
    __nv_bfloat162 dl =
        __hsub2(*reinterpret_cast<__nv_bfloat162*>(&l), off);
    __nv_bfloat162 dh =
        __hsub2(*reinterpret_cast<__nv_bfloat162*>(&h), off);
    lo[i] = *reinterpret_cast<uint32_t*>(&dl);
    hi[i] = *reinterpret_cast<uint32_t*>(&dh);
  }
}

// BC channels a CTA, BC / 2 a consumer warpgroup as MB = BC / 128 blocks
// of 64 (wgmma's M), which share each x tile.
template <int BT, int BC, bool BIASED>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
qmm_int4_wgmma(const QmmParams p, const __grid_constant__ CUtensorMap mx,
               const __grid_constant__ CUtensorMap mw) {
  constexpr int MB = BC / 128;
  constexpr int X_BYTES = BT * kPanelBytes, STAGE = qw_stage_bytes(BT, BC);
  constexpr int SROW = BC + 8;
  const int S = p.stages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_atom(smem_raw);
  bf16* stg = reinterpret_cast<bf16*>(sm + S * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S * STAGE +
                                               BT * SROW * 2);
  uint64_t* empty = full + S;

  const int tiles_c = (p.N + BC - 1) / BC, tiles_t = (p.M + BT - 1) / BT;
  const int tiles = tiles_c * tiles_t;
  const int nk = (p.K / 2 + kQK - 1) / kQK;
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
    // Producer: x's two K slices (x viewed as [M, 2, K/2]: the high slice
    // is half 1, so neither slice reads past its own half) and the packed
    // tile of each k step.
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 2 * kWgThreads) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int z, ci, ti;
        tile_walk(t, tiles_c, tiles_t, p.group, z, ci, ti);
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int st = it % S;
          mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
          unsigned char* xs = sm + st * STAGE;
          mbar_expect_tx(&full[st], STAGE);
          tma_load_3d(xs, &mx, &full[st], kb * kQK, 0, ti * BT);
          tma_load_3d(xs + X_BYTES, &mx, &full[st], kb * kQK, 1, ti * BT);
          tma_load_3d(xs + 2 * X_BYTES, &mw, &full[st], kb * kQK, ci * BC,
                      0);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg, wt = tid % kWgThreads, lane = tid & 31, wi = wt >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    // This thread's tile rows (channels): r0 + 64 b and r0 + 64 b + 8 of
    // block b.
    const int r0 = BC / 2 * w + 16 * wi + g;
    float acc[MB][BT / 8][4];
    uint32_t fr[2 * kQK / 16][4];   // [k step][low / high] A fragments
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int z, ci, ti;
      tile_walk(t, tiles_c, tiles_t, p.group, z, ci, ti);
      // Each k step and channel block: wait for the previous products
      // (they read the fragment registers; at a block 0, release the last
      // step's stage), widen this block's nibbles, issue its eight
      // products (low and high halves of four k16 steps; the first of a
      // tile overwrites the accumulator). The other warpgroup's products
      // keep the tensor cores busy meanwhile (a second fragment buffer, to
      // widen under this warpgroup's own products, measured no faster on
      // the H100).
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int st = it % S;
        mbar_wait(&full[st], (it / S) & 1);
        const unsigned char* xs = sm + st * STAGE;
        const uint32_t xb = opaque(smem_addr(xs));
#pragma unroll
        for (int b = 0; b < MB; ++b) {
          wgmma_wait<0>();
#pragma unroll
          for (int bb = 0; bb < MB; ++bb) fence_acc(acc[bb]);
          fence_frag(fr);
          if (b == 0 && kb > 0 && lane == 0)
            mbar_arrive(&empty[(it + S - 1) % S]);
#pragma unroll
          for (int kk = 0; kk < kQK / 16; ++kk)
            widen_kstep<BIASED>(xs + 2 * X_BYTES, r0 + 64 * b,
                                16 * kk + 2 * t4, fr[2 * kk], fr[2 * kk + 1]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kQK / 16; ++kk) {
            Wgmma<BT>::template rs<0>(acc[b], fr[2 * kk],
                                      desc_b128(xb + kk * 32, 16),
                                      kb > 0 || kk > 0);
            Wgmma<BT>::template rs<0>(
                acc[b], fr[2 * kk + 1],
                desc_b128(xb + X_BYTES + kk * 32, 16), 1);
          }
          wgmma_commit();
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < MB; ++b) fence_acc(acc[b]);
      fence_frag(fr);
      if (lane == 0) mbar_arrive(&empty[(it + S - 1) % S]);

      // Epilogue: (acc - 8 rowsum(x)) * scale (signed: acc * scale), one
      // cast, staged transposed as y [token][channel] and stored 16 bytes
      // along each token's channels. The scales of this thread's channels
      // and 8 rowsum(x) of its tokens go to registers first (loads
      // between the staging stores would repeat: the compiler cannot tell
      // the two apart).
      const int c0 = ci * BC, m0 = ti * BT;
      float sc[MB][2], rs8[BIASED ? BT / 4 : 1];
#pragma unroll
      for (int b = 0; b < MB; ++b)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ch = c0 + r0 + 64 * b + 8 * h;
          sc[b][h] = ch < p.N ? p.scale[ch] : 0.f;
        }
      if (BIASED) {
#pragma unroll
        for (int i = 0; i < BT / 4; ++i) {
          const int tok = m0 + 8 * (i / 2) + 2 * t4 + (i & 1);
          rs8[i] = tok < p.M ? 8.f * p.rs[tok] : 0.f;
        }
      }
      named_barrier(kStoreBar, 2 * kWgThreads);   // the last tile is out
#pragma unroll
      for (int b = 0; b < MB; ++b)
#pragma unroll
        for (int j = 0; j < BT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tok = 8 * j + 2 * t4 + (e & 1);
            float v = acc[b][j][e];
            if (BIASED) v -= rs8[2 * j + (e & 1)];
            stg[tok * SROW + r0 + 64 * b + 8 * (e >> 1)] =
                __float2bfloat16(v * sc[b][e >> 1]);
          }
      named_barrier(kStoreBar, 2 * kWgThreads);
      bf16* y = static_cast<bf16*>(p.y);
      const bool vec = p.N % 8 == 0;
      for (int idx = tid; idx < BT * (BC / 8); idx += 2 * kWgThreads) {
        const int tok = idx / (BC / 8), c = (idx % (BC / 8)) * 8;
        const int row = m0 + tok, col = c0 + c;
        if (row >= p.M || col >= p.N) continue;
        const bf16* src = stg + tok * SROW + c;
        bf16* dst = y + (size_t)row * p.N + col;
        if (vec) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && col + e < p.N; ++e) dst[e] = src[e];
        }
      }
    }
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

template <int TT, int BN, int BK, int KW, int STAGES, bool BIASED>
cudaError_t launch_decode(const QmmParams& p, cudaStream_t s) {
  if (p.M > TT) return cudaErrorInvalidValue;
  constexpr size_t ring = STAGES * stage_bytes(TT, BN, BK);
  constexpr size_t red = sizeof(float) * KW * (BN * TT + TT);
  return launch(qmm_int4_decode<TT, BN, BK, KW, STAGES, BIASED>,
                dim3((p.N + BN - 1) / BN), KW * 32, ring > red ? ring : red,
                p, s);
}

template <int BT, int BC, bool BIASED>
cudaError_t launch_wgmma(const QmmParams& p, cudaStream_t s) {
  const int smem = qw_smem_bytes(BT, BC, p.stages);
  if (p.stages < 2 || smem > kSmemOptin || p.group < 1 ||
      (BIASED && p.rs == nullptr))
    return cudaErrorInvalidValue;
  // x as [M, 2, K/2] (boxes of 64 values of one half by BT tokens), the
  // packed weight as [N, K/2] bytes (boxes of 64 bytes by BC channels).
  CUtensorMap mx, mw;
  const uint64_t kh = p.K / 2;
  if (!tile_map_3d(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.x, kh, 2, p.M,
                   kh * 2, kh * 4, kQK, 1, BT, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tile_map_3d(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.w, kh, p.N, 1, kh,
                   kh * p.N, kQK, BC, 1, CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  const int grid = persistent_ctas(((p.N + BC - 1) / BC) *
                                   ((p.M + BT - 1) / BT));
  if (grid < 1) return cudaErrorInvalidValue;
  auto kernel = qmm_int4_wgmma<BT, BC, BIASED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWgmmaThreads, smem, s>>>(p, mx, mw);
  return cudaGetLastError();
}

template <bool BIASED>
cudaError_t launch_tile(const QmmParams& p, int x_bf16, int tile,
                        cudaStream_t s) {
  // Tiles as ops/params.py::QMM_TILES numbers them: 0 d8, 1 d16 (decode),
  // 2 w128 and 4 w256 (prefill), 3 ffma.
  if (x_bf16 && tile == 0) return launch_decode<8, 32, 256, 4, 4, BIASED>(p, s);
  if (x_bf16 && tile == 1) return launch_decode<16, 32, 256, 4, 4, BIASED>(p, s);
  if (x_bf16 && tile == 2) return launch_wgmma<128, 128, BIASED>(p, s);
  if (x_bf16 && tile == 4) return launch_wgmma<128, 256, BIASED>(p, s);
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
// The wgmma tiles (2, 4) take rs = rowsum(x) [M] fp32 for the biased
// layout (else null), a ring of `stages` stages and tiles walked in bands
// of `group` channel tiles; the other tiles ignore all three.
extern "C" int mfa_int4_matmul(const void* x, const void* w,
                               const void* scale, const void* rs, void* y,
                               int M, int N, int K, int x_bf16, int biased,
                               int tile, int stages, int group,
                               void* stream) {
  if (M < 1 || N < 1 || K < 32 || K % 32 != 0 ||
      (tile == 3 && (M + 63) / 64 > 65535))
    return cudaErrorInvalidValue;
  const QmmParams p{x, static_cast<const uint8_t*>(w),
                    static_cast<const float*>(scale),
                    static_cast<const float*>(rs), y, M, N, K, stages,
                    group};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return biased ? launch_tile<true>(p, x_bf16, tile, s)
                : launch_tile<false>(p, x_bf16, tile, s);
}
