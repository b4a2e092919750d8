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
// Decode (M <= 16 rows: kernels/quant_matmul.py::int4_tile, tiles d8 and
// d16) runs qmm_int4_splitk: y^T on mma.sync, so that 16 output channels
// fill the mma's row side and the tokens its 8-wide side, with K split
// across CTAs (ops/params.py::qmm_split_cols, from the shapes and the SM
// count alone), so that even N = 1024 puts several CTAs on every SM:
// - A CTA owns 64 channels and one split of the packed columns; eight
//   warps, four a 32-channel group (two 16-channel blocks sharing each x
//   fragment), splitting every stage's columns in quarters. One thread
//   streams the weight by TMA in boxes of 64 channels x 128 bytes
//   (128-byte-swizzled: a fragment's eight rows fall in eight bank
//   groups) through an mbarrier ring; the M rows of x's two K slices of
//   the split are copied once and stay resident.
// - The k slots of a quad are permuted the same way in x and W (below),
//   so that one 32-bit load of packed bytes and one 64-bit load of x feed
//   whole fragments; the biased layout's rowsum(x) is summed from the same
//   x fragments in registers.
// - Each split writes fp32 partial products (and row sums) to a workspace;
//   the last CTA of a channel tile to arrive (an integer counter that it
//   resets for the next call) sums them in split order and applies the
//   epilogue, so y is the same whatever CTA comes last.
// Prefill has no mma.sync tile: the wgmma tile measured faster at every M
// from 17 to 2048 on the H100 (utils/bwd_tuning.py sweep --only matmul).
// fp32 activations run an FMA loop with the same epilogue.
//
// What bounds it on an H100: at decode (M = 4) the packed weight is the
// traffic, K * N / 2 bytes: 29.4 MB for 4096 -> 14336, 8.8 us at
// 3.35 TB/s, against 0.47 GFLOP (0.5 us): bytes, so every SM needs
// weight bytes in flight. At prefill (M = 2048) the same shape is 240
// GFLOP, 243 us at 989 TFLOP/s: operations.

#include <cstring>
#include <functional>
#include <unordered_map>

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
  int stages, group;     // ring depth; wgmma tile: tile-walk band
  // Decode tiles: packed columns a split, the splits' partials (fp32) and
  // one arrival counter a channel tile (zero between calls).
  int split_cols;
  float* part;
  unsigned* counters;
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

__device__ __forceinline__ float pair_sum(uint32_t v) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  return f.x + f.y;
}

// ---------------------------------------------------------------------------
// Decode (M <= TT tokens, bf16 x): the product transposed, y^T = W^T x^T,
// so that output channels fill the mma's 16-row side and the few tokens
// its 8-wide side (a 16-row x tile would waste 12 of 16 rows at M = 4),
// with K split across CTAs. CTA (tile, split) owns kQdChannels channels
// and packed columns [split * split_cols, + split_cols) of them: the
// weight streams through a ring of kQdStep-byte TMA boxes, the M rows of
// x's two K slices of the split stay resident, stored with the k slots of
// each quad already permuted (one 64-bit load a fragment). Eight warps:
// warp w takes two 16-channel blocks, channels 32 (w % 2) .. + 31, so
// that each x fragment feeds both, and quarter w / 2 of each stage's
// columns, so that enough warps hide the loads' latency; the quarters
// meet in shared memory at the end. Each split writes its fp32 partial
// products (and, biased, its part of rowsum(x)) to the workspace; the last
// CTA of a channel tile to arrive (an integer counter that it resets) sums
// them in split order and applies the epilogue, so y does not depend on
// which CTA came last.
// ---------------------------------------------------------------------------
constexpr int kQdStep = 128;       // packed bytes a channel row a stage
constexpr int kQdChannels = 64;    // output channels a CTA, 32 a warp
constexpr int kQdThreads = 256;    // four warps a 32-channel group
constexpr int kQdStageBytes = kQdChannels * kQdStep;
constexpr int kQdMaxStages = 8;

// Shared memory of a decode CTA for M tokens (ops/params.py::
// qmm_smem_bytes mirrors it): the ring (stages x [64 channels x 128
// bytes], 128-byte-swizzled; the quarters' sums reuse it at the end, so
// it holds at least two stages), x's two slices [M][2 * split_cols + 16]
// bf16, the stages' mbarriers, each quarter's rowsum(x) of the split
// [4][TT] fp32, the last-to-arrive flag; slack to align the ring to the
// 1024-byte swizzle atom.
__host__ __device__ constexpr int qd_x_stride(int split_cols) {
  return 2 * split_cols + 16;
}

__host__ __device__ constexpr int qd_smem_bytes(int tt, int m, int stages,
                                                int split_cols) {
  return kAlignSlack + stages * (kQdStageBytes + 8) +
         m * qd_x_stride(split_cols) * 2 + 4 * tt * 4 + 4;
}

template <int TT, bool BIASED>
__global__ void __launch_bounds__(kQdThreads)
qmm_int4_splitk(const QmmParams p, const __grid_constant__ CUtensorMap mw) {
  constexpr int FT = TT / 8;            // token n-tiles
  constexpr int QUARTER = kQdStep / 4;  // packed columns a warp a stage
  const int S = p.stages, sc = p.split_cols, XS = qd_x_stride(sc);
  const int M = p.M, N = p.N, Kh = p.K / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_atom(smem_raw);
  uint16_t* xs = reinterpret_cast<uint16_t*>(ring + S * kQdStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + M * XS);
  float* rsum = reinterpret_cast<float*>(full + S);   // [4][TT]
  int* last = reinterpret_cast<int*>(rsum + 4 * TT);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int cg = warp & 1, kq = warp >> 1;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int n0 = tile * kQdChannels;
  const int c0 = split * sc, cols = min(Kh, c0 + sc) - c0;
  const int nst = (cols + kQdStep - 1) / kQdStep;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    for (int s = 0; s < S && s < nst; ++s) {
      mbar_expect_tx(&full[s], kQdStageBytes);
      tma_load_3d(ring + s * kQdStageBytes, &mw, &full[s], c0 + s * kQdStep,
                  n0, 0);
    }
  }
  // x's low and high slices of this split, zero past K/2 (the last
  // stage's columns past K/2 hold TMA's zeros in W), each quad's columns
  // (c, c + 1, c + 2, c + 3) stored as (c, c + 2, c + 1, c + 3).
  const uint4* xg = static_cast<const uint4*>(p.x);
  const int xch = nst * kQdStep / 8;   // 16-byte chunks of one slice row
  for (int i = tid; i < M * 2 * xch; i += kQdThreads) {
    const int r = i / (2 * xch), c = i - r * 2 * xch;
    const int h = c / xch, col = (c - h * xch) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (col < cols) v = xg[((size_t)r * p.K + h * Kh + c0 + col) / 8];
    uint4 q;
    q.x = __byte_perm(v.x, v.y, 0x5410);
    q.y = __byte_perm(v.x, v.y, 0x7632);
    q.z = __byte_perm(v.z, v.w, 0x5410);
    q.w = __byte_perm(v.z, v.w, 0x7632);
    *reinterpret_cast<uint4*>(xs + r * XS + h * sc + col) = q;
  }
  __syncthreads();

  float acc[2][FT][4], rs[FT];
#pragma unroll
  for (int t = 0; t < FT; ++t) {
    rs[t] = 0.f;
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][t][e] = 0.f;
  }
  // This warp's channel rows r0 + 16 b and r0 + 16 b + 8 of the tile. In a
  // 128-byte-swizzled box, byte c of row r sits in 16-byte chunk (c / 16)
  // ^ (r % 8): the eight rows of a fragment load fall in eight chunks, no
  // bank twice. Lanes of tokens past M take zeros for x.
  const int r0 = cg * 32 + g;
  for (int i = 0; i < nst; ++i) {
    const int st = i % S;
    mbar_wait(&full[st], (i / S) & 1);
    const unsigned char* wt = ring + st * kQdStageBytes + r0 * kQdStep;
    const uint16_t* xr = xs + i * kQdStep;
#pragma unroll
    for (int kk = kq * QUARTER; kk < kq * QUARTER + QUARTER; kk += 16) {
      uint32_t bx[2][FT][2] = {};   // x: [K slice][token tile]
#pragma unroll
      for (int t = 0; t < FT; ++t) {
        if (t * 8 + g >= M) continue;
        const uint16_t* xp = xr + (t * 8 + g) * XS + kk + 4 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint2 v = *reinterpret_cast<const uint2*>(xp + h * sc);
          bx[h][t][0] = v.x;
          bx[h][t][1] = v.y;
          if (BIASED && cg == 0) rs[t] += pair_sum(v.x) + pair_sum(v.y);
        }
      }
      const int at = (((kk >> 4) ^ (r0 & 7)) << 4) + 4 * t4;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const unsigned char* wb = wt + 16 * b * kQdStep + at;
        uint32_t lo0[2], hi0[2], lo1[2], hi1[2];
        unpack4<BIASED>(*reinterpret_cast<const uint32_t*>(wb), lo0, hi0);
        unpack4<BIASED>(*reinterpret_cast<const uint32_t*>(wb + 8 * kQdStep),
                        lo1, hi1);
        const uint32_t alo[4] = {lo0[0], lo1[0], lo0[1], lo1[1]};
        const uint32_t ahi[4] = {hi0[0], hi1[0], hi0[1], hi1[1]};
#pragma unroll
        for (int t = 0; t < FT; ++t) {
          mma_bf16(acc[b][t], alo, bx[0][t][0], bx[0][t][1]);
          mma_bf16(acc[b][t], ahi, bx[1][t][0], bx[1][t][1]);
        }
      }
    }
    __syncthreads();   // every warp is done with stage st: refill it
    if (tid == 0 && i + S < nst) {
      mbar_expect_tx(&full[st], kQdStageBytes);
      tma_load_3d(ring + st * kQdStageBytes, &mw, &full[st],
                  c0 + (i + S) * kQdStep, n0, 0);
    }
  }
  // Each quarter's rowsum(x) over the split's columns: token t * 8 + g
  // over a quad. Quarters 1-3's products join quarter 0's, in quarter
  // order, through the ring, which no copy writes any more.
  if (BIASED && cg == 0) {
#pragma unroll
    for (int t = 0; t < FT; ++t) {
      float v = rs[t];
      v += __shfl_xor_sync(kFull, v, 1);
      v += __shfl_xor_sync(kFull, v, 2);
      if (t4 == 0) rsum[kq * TT + t * 8 + g] = v;
    }
  }
  constexpr int PER = 2 * FT * 4;                      // a thread's sums
  float* quarters = reinterpret_cast<float*>(ring);   // [3][2][PER][32]
  if (kq > 0)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int t = 0; t < FT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          quarters[(((kq - 1) * 2 + cg) * PER + (b * FT + t) * 4 + e) * 32 +
                   lane] = acc[b][t][e];
  __syncthreads();
  if (kq == 0)
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int t = 0; t < FT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[b][t][e] +=
                quarters[((q * 2 + cg) * PER + (b * FT + t) * 4 + e) * 32 +
                         lane];
  if (BIASED && tid < TT)
    rsum[tid] += rsum[TT + tid] + rsum[2 * TT + tid] + rsum[3 * TT + tid];
  __syncthreads();

  // Quarter 0's outputs: channels n0 + r0 + 16 b (+ 8), tokens 8 t + 2 t4
  // (+ 1).
  bf16* y = static_cast<bf16*>(p.y);
  if (splits == 1) {
    if (kq > 0) return;
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int t = 0; t < FT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = n0 + r0 + 16 * b + 8 * (e >> 1);
          const int tok = t * 8 + 2 * t4 + (e & 1);
          if (ch >= N || tok >= M) continue;
          float v = acc[b][t][e];
          if (BIASED) v -= 8.f * rsum[tok];
          y[(size_t)tok * N + ch] = __float2bfloat16(v * p.scale[ch]);
        }
    return;
  }
  // Partials [tiles][splits][M][64] and (biased) rowsum parts
  // [tiles][splits][M] after them.
  float* part = p.part + ((size_t)tile * splits + split) * M * kQdChannels;
  float* rs_part = p.part + (size_t)gridDim.x * splits * M * kQdChannels +
                   ((size_t)tile * splits + split) * M;
  if (kq == 0)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int t = 0; t < FT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = r0 + 16 * b + 8 * (e >> 1);
          const int tok = t * 8 + 2 * t4 + (e & 1);
          if (tok < M) part[tok * kQdChannels + c] = acc[b][t][e];
        }
  if (BIASED && tid < M) rs_part[tid] = rsum[tid];
  // Publish the partials, then count this split in; the last to arrive
  // resets the counter for the next call.
  __threadfence();
  __syncthreads();
  if (tid == 0)
    *last = atomicInc(p.counters + tile, splits - 1) == (unsigned)splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const float* parts = p.part + (size_t)tile * splits * M * kQdChannels;
  const float* rs_parts = p.part +
                          (size_t)gridDim.x * splits * M * kQdChannels +
                          (size_t)tile * splits * M;
  for (int idx = tid; idx < M * kQdChannels; idx += kQdThreads) {
    const int tok = idx / kQdChannels, ch = n0 + idx % kQdChannels;
    if (ch >= N) continue;
    float v = 0.f, r = 0.f;
    for (int j = 0; j < splits; ++j) {
      v += __ldcg(parts + (size_t)j * M * kQdChannels + idx);
      if (BIASED) r += __ldcg(rs_parts + j * M + tok);
    }
    if (BIASED) v -= 8.f * r;
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

// The decode tile's weight map, kept for the weights a thread has used: a
// decode step takes the same weights again at every step, and encoding a
// map costs the host more than the rest of a launch. A map is a function
// of (base, K/2, N) alone (type, box and swizzle are fixed here), so a
// kept one is never stale, whatever the memory at base holds now.
bool weight_map(CUtensorMap* map, const void* w, int kh, int N) {
  struct Kept {
    unsigned char bytes[sizeof(CUtensorMap)];
  };
  struct Key {
    const void* w;
    int kh, N;
    bool operator==(const Key& o) const {
      return w == o.w && kh == o.kh && N == o.N;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(k.w) ^ ((size_t)k.kh << 32) ^ k.N;
    }
  };
  thread_local std::unordered_map<Key, Kept, Hash> kept;
  const auto it = kept.find(Key{w, kh, N});
  if (it != kept.end()) {
    std::memcpy(map, it->second.bytes, sizeof(CUtensorMap));
    return true;
  }
  if (!tile_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, kh, N, 1, kh,
                   (uint64_t)kh * N, kQdStep, kQdChannels, 1,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  if (kept.size() >= 4096) kept.clear();   // bounded: a model has hundreds
  std::memcpy(kept[Key{w, kh, N}].bytes, map, sizeof(CUtensorMap));
  return true;
}

template <int TT, bool BIASED>
cudaError_t launch_splitk(const QmmParams& p, cudaStream_t s) {
  const int kh = p.K / 2;
  if (p.M > TT || p.stages < 2 || p.stages > kQdMaxStages ||
      p.split_cols < kQdStep || p.split_cols % kQdStep != 0)
    return cudaErrorInvalidValue;
  const int tiles = (p.N + kQdChannels - 1) / kQdChannels;
  const int splits = (kh + p.split_cols - 1) / p.split_cols;
  const int smem = qd_smem_bytes(TT, p.M, p.stages, p.split_cols);
  if (splits > 65535 || smem > kSmemOptin ||
      (splits > 1 && (p.part == nullptr || p.counters == nullptr)))
    return cudaErrorInvalidValue;
  // The packed weight as [N, K/2] bytes, boxes of 128 bytes by 64 channels.
  CUtensorMap mw;
  if (!weight_map(&mw, p.w, kh, p.N)) return cudaErrorInvalidValue;
  auto kernel = qmm_int4_splitk<TT, BIASED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles, splits), kQdThreads, smem, s>>>(p, mw);
  return cudaGetLastError();
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
  if (x_bf16 && tile == 0) return launch_splitk<8, BIASED>(p, s);
  if (x_bf16 && tile == 1) return launch_splitk<16, BIASED>(p, s);
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
// of `group` channel tiles. The decode tiles (0, 1) take a ring of
// `stages` stages, K split into splits of `split_cols` packed columns (a
// multiple of 128) and, with more than one split, part: fp32 workspace of
// tiles * splits * M * 65 values, and counters: tiles unsigned ints, zero
// (tiles = ceil(N / 64), splits = ceil(K / 2 / split_cols)). Unused
// arguments may be 0.
extern "C" int mfa_int4_matmul(const void* x, const void* w,
                               const void* scale, const void* rs,
                               void* part, void* counters, void* y, int M,
                               int N, int K, int x_bf16, int biased,
                               int tile, int stages, int group,
                               int split_cols, void* stream) {
  if (M < 1 || N < 1 || K < 32 || K % 32 != 0 ||
      (tile == 3 && (M + 63) / 64 > 65535))
    return cudaErrorInvalidValue;
  const QmmParams p{x, static_cast<const uint8_t*>(w),
                    static_cast<const float*>(scale),
                    static_cast<const float*>(rs), y, M, N, K, stages,
                    group, split_cols, static_cast<float*>(part),
                    static_cast<unsigned*>(counters)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return biased ? launch_tile<true>(p, x_bf16, tile, s)
                : launch_tile<false>(p, x_bf16, tile, s);
}
