// Flash-attention backward for Hopper (sm_90a): two kernels, no atomics.
//
// K3 flash_bwd_q replaces mfa_tpu/kernels/flash_bwd.py::_bwd_q_kernel
// (build_bwd_query). One CTA owns one (batch*head, q-block). It first
// computes the D-term rowsum(dO * O) in fp32 from O in its stored type,
// then loops over the CTA's live kv blocks [j_min, j_max] (the bounds K1
// uses) with S = Q K^T, P = exp2(S*scale*log2e - L*log2e), dP = dO V^T,
// dS = P (dP - D) * cap' * scale and dQ += dS K. Outputs dQ [BH, R, D]
// and the D-term [BH, R], both fp32.
//
// K4 flash_bwd_kv replaces ::_bwd_kv_kernel (build_bwd_key_value). One
// CTA owns one (batch*kv-head, kv-block) and walks (query head g of the
// GQA group) x (live q-blocks), so dK and dV of a kv head accumulate over
// the whole group in registers: deterministic, no atomics, no second pass.
// It computes the transposed orientation S^T = K Q^T (the original Metal
// kernel's): each warp owns 16 kv rows, and the S^T / dS^T accumulators
// of mma.sync already have the A-operand layout of P^T dO and dS^T Q, so
// P and dS go from one product to the next in registers. Q and dO are B
// operands there and are also kept transposed in shared memory. A kv
// block that no query sees still writes dK = dV = 0.
//
// Rounding points kept from the TPU kernels: S from Q pre-scaled by
// scale*log2e and rounded to bf16 (bf16 inputs; fp32 scales S instead),
// the raw Q for dK, the soft-cap derivative taken in the log2 domain, dS
// multiplied by scale (not scale*log2e), P rounded to bf16 only for dV
// and dS rounded to bf16 before dQ and dK (bf16 inputs), fp32
// accumulation, the large-finite mask sentinel (P = 0 where masked), and
// the diagonal aligned to the sequence ends (offset = C - R, floor
// division when negative).
//
// What bounds them on an H100: at Llama-3-8B widths (32 query heads, 8 kv
// heads, N = 2048, D = 128, causal) K3 does 6*D FLOP per visible pair
// (~52 GFLOP, ~0.052 ms at the 989 TFLOP/s bf16 tensor-core peak) and K4
// 8*D (~69 GFLOP, ~0.069 ms) against ~20 MB of operand traffic (~6 us at
// 3.35 TB/s): the bound is operations. This first cut uses warp-level
// mma.sync (m16n8k16, bf16 -> fp32) from shared-memory tiles with no
// load/compute overlap; wgmma, TMA and pipelining are later work. fp32
// inputs take plain-FMA kernels: TF32 would miss the fp32 gradient budget.
// K4's two fp32 [16 x D] accumulators per warp are 128 registers a thread
// at D = 128; at D = 256 the warps split the head dim in two (each pair
// of warps recomputes S^T and dP^T for its 16 rows).

#include "common.cuh"

namespace {

using namespace mfa;
using bf16 = __nv_bfloat16;

struct BwdParams {
  const void* q;     // [BH, R, D]
  const void* k;     // [BH / group, C, D]
  const void* v;
  const void* o;     // [BH, R, D] (K3), input type or fp32 (o_f32)
  const void* d_o;   // [BH, R, D], input type
  const float* lse;  // [BH, R] natural-log logsumexp
  float* dterm;      // [BH, R]: written by K3, read by K4
  float* dq;         // [BH, R, D]
  float* dk;         // [BH / group, C, D]
  float* dv;
  int group, R, C, D;
  int causal, window;          // window <= 0: none
  float scale2, cap2, scale;   // scale*log2e; soft-cap*log2e (<= 0: none)
  int o_f32;
  int vec;                     // 16-byte global loads allowed
};

__device__ __forceinline__ bool visible(const BwdParams& p, int row,
                                        int col) {
  return row < p.R && visible_rc(row, col, p.R, p.C, p.causal, p.window);
}

// dS from S (already scaled into the log2 domain), dP and the row's L2 =
// L*log2e and D-term; also returns P. Masked entries give P = dS = 0.
__device__ __forceinline__ float grad_score(const BwdParams& p, float s,
                                            float dp, float l2, float dt,
                                            bool vis, float& prob) {
  float cg;
  float x = cap_with_grad(s, p.cap2, cg);
  if (!vis) x = kMaskValue;
  prob = exp2f(x - l2);
  return ((prob * (dp - dt)) * cg) * p.scale;
}

// Rows [row0, row0 + ROWS) of a bf16 [nrows, D] matrix into shared
// memory, zero padded: row-major into rm (stride DP + 8; scaled by
// `scale` and rounded when scale != 0) and/or transposed into tr (stride
// ROWS + 8). Consecutive threads take consecutive rows, so the scattered
// 2-byte transposed stores stay conflict-free.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void load_rows(const bf16* src, int row0,
                                          int nrows, int D, int vec,
                                          float scale, bf16* rm, bf16* tr,
                                          int tid) {
  for (int c = tid; c < ROWS * (DP / 8); c += NT) {
    const int r = c % ROWS, d0 = (c / ROWS) * 8;
    const bool in = row0 + r < nrows;
    uint4 val = make_uint4(0, 0, 0, 0);
    bf16* e8 = reinterpret_cast<bf16*>(&val);
    if (vec) {
      if (in && d0 < D)
        val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D +
                                              d0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (in && d0 + e < D) e8[e] = src[(size_t)(row0 + r) * D + d0 + e];
    }
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
  }
}

// A fragment (16x16) of a row-major bf16 tile at rows r0.., columns kk..
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile,
                                       int stride, int r0, int kk, int g,
                                       int t4) {
  const bf16* x = tile + (r0 + g) * stride + kk + t4 * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(x);
  a[1] = *reinterpret_cast<const uint32_t*>(x + 8 * stride);
  a[2] = *reinterpret_cast<const uint32_t*>(x + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(x + 8 * stride + 8);
}

// D (16x8) += A * B where B[k][n] = tile[n0 + n][kk + k] (row-major tile
// whose rows are B's columns).
__device__ __forceinline__ void mma_rows(float* c, const uint32_t* a,
                                         const bf16* tile, int stride,
                                         int n0, int kk, int g, int t4) {
  const bf16* b = tile + (n0 + g) * stride + kk + t4 * 2;
  mma_bf16(c, a, *reinterpret_cast<const uint32_t*>(b),
           *reinterpret_cast<const uint32_t*>(b + 8));
}

// The accumulators of n-tiles 2kc and 2kc+1 as one A fragment (rounded).
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* lo,
                                         const float* hi) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Live kv blocks [lo, hi] of q-block i (hi < lo: none), as K1 computes.
__device__ __forceinline__ void kv_range(const BwdParams& p, int i, int bq,
                                         int bkv, int& lo, int& hi) {
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

// Live q blocks [lo, hi] of kv-block j (hi < lo: none): rows r with
// r >= col - offset (causal) and r <= col - offset + W - 1 (window).
__device__ __forceinline__ void q_range(const BwdParams& p, int j, int bq,
                                        int bkv, int& lo, int& hi) {
  const int nq = (p.R + bq - 1) / bq;
  const int offset = p.C - p.R;
  lo = 0;
  hi = nq - 1;
  if (p.causal || p.window > 0) {
    lo = max(floor_div(j * bkv - offset, bq), 0);
    if (p.window > 0)
      hi = min(floor_div((j + 1) * bkv - 1 - offset + p.window - 1, bq),
               nq - 1);
  }
}

// The D-term of rows [row0, row0 + BQ) of head bh (one warp per row) into
// sD and global memory, and L*log2e into sL. Rows past R get zeros.
template <typename OT, int BQ, int NT>
__device__ __forceinline__ void d_term(const BwdParams& p, int bh, int row0,
                                       const OT* og, const void* dog,
                                       bool do_f32, float* sL, float* sD,
                                       int warp, int lane) {
  for (int r = warp; r < BQ; r += NT / 32) {
    const int row = row0 + r;
    float acc = 0.f, l2 = 0.f;
    if (row < p.R) {
      const size_t base = ((size_t)bh * p.R + row) * p.D;
      for (int d = lane; d < p.D; d += 32) {
        const float dov =
            do_f32 ? static_cast<const float*>(dog)[base + d]
                   : __bfloat162float(static_cast<const bf16*>(dog)[base + d]);
        float ov;
        if constexpr (std::is_same<OT, float>::value)
          ov = og[base + d];
        else
          ov = __bfloat162float(og[base + d]);
        acc += dov * ov;
      }
      acc = warp_sum(acc);
      l2 = p.lse[(size_t)bh * p.R + row] * kLog2e;
      if (lane == 0) p.dterm[(size_t)bh * p.R + row] = acc;
    }
    if (lane == 0) {
      sD[r] = acc;
      sL[r] = l2;
    }
  }
}

// ---------------------------------------------------------------------------
// K3, bf16 inputs: mma.sync, four warps of 16 query rows.
// ---------------------------------------------------------------------------
template <int BQ, int BKV, int DP>
__global__ void __launch_bounds__(BQ * 2)
flash_bwd_q_bf16(BwdParams p) {
  constexpr int NT = BQ * 2;
  constexpr int QS = DP + 8;       // row-major tile stride
  constexpr int TS = BKV + 8;      // transposed K tile stride
  constexpr int NKT = BKV / 8;     // S / dP n-tiles
  constexpr int NDT = DP / 8;      // dQ n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // pre-scaled Q
  bf16* sdO = sQ + BQ * QS;
  bf16* sK = sdO + BQ * QS;
  bf16* sV = sK + BKV * QS;
  bf16* sKt = sV + BKV * QS;
  float* sL = reinterpret_cast<float*>(sKt + DP * TS);
  float* sD = sL + BQ;

  const int i = blockIdx.x, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int R = p.R, C = p.C, D = p.D;
  const size_t qoff = (size_t)bh * R * D;
  const size_t kvoff = (size_t)(bh / p.group) * C * D;
  const bf16* kg = static_cast<const bf16*>(p.k) + kvoff;
  const bf16* vg = static_cast<const bf16*>(p.v) + kvoff;
  const int row0 = i * BQ;

  load_rows<BQ, DP, NT>(static_cast<const bf16*>(p.q) + qoff, row0, R, D,
                        p.vec, p.scale2, sQ, nullptr, tid);
  load_rows<BQ, DP, NT>(static_cast<const bf16*>(p.d_o) + qoff, row0, R, D,
                        p.vec, 0.f, sdO, nullptr, tid);
  if (p.o_f32)
    d_term<float, BQ, NT>(p, bh, row0, static_cast<const float*>(p.o),
                          p.d_o, false, sL, sD, warp, lane);
  else
    d_term<bf16, BQ, NT>(p, bh, row0, static_cast<const bf16*>(p.o), p.d_o,
                         false, sL, sD, warp, lane);
  __syncthreads();
  const int wr = warp * 16 + g;       // tile rows wr and wr + 8
  const float l2[2] = {sL[wr], sL[wr + 8]};
  const float dt[2] = {sD[wr], sD[wr + 8]};

  float dq[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  int lo, hi;
  kv_range(p, i, BQ, BKV, lo, hi);
  for (int j = lo; j <= hi; ++j) {
    const int col0 = j * BKV;
    __syncthreads();   // previous tiles consumed
    load_rows<BKV, DP, NT>(kg, col0, C, D, p.vec, 0.f, sK, sKt, tid);
    load_rows<BKV, DP, NT>(vg, col0, C, D, p.vec, 0.f, sV, nullptr, tid);
    __syncthreads();

    // S = Qs K^T and dP = dO V^T for this warp's 16 rows.
    float s[NKT][4], dp[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t aq[4], ad[4];
      load_a(aq, sQ, QS, warp * 16, kk, g, t4);
      load_a(ad, sdO, QS, warp * 16, kk, g, t4);
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
        mma_rows(s[n], aq, sK, QS, n * 8, kk, g, t4);
        mma_rows(dp[n], ad, sV, QS, n * 8, kk, g, t4);
      }
    }
    // dS, in place of S.
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = col0 + n * 8 + t4 * 2 + (e & 1);
        float prob;
        s[n][e] = grad_score(p, s[n][e], dp[n][e], l2[h], dt[h],
                             visible(p, row0 + wr + 8 * h, col), prob);
      }
    // dQ += dS K: the dS accumulators are the A fragments (rounded to
    // bf16); K^T from the transposed tile gives single 32-bit B loads.
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int n = 0; n < NDT; ++n)
        mma_rows(dq[n], a, sKt, TS, n * 8, kc * 16, g, t4);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wr + 8 * h;
    if (r >= R) continue;
#pragma unroll
    for (int n = 0; n < NDT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + t4 * 2 + e;
        if (d < D) p.dq[qoff + (size_t)r * D + d] = dq[n][2 * h + e];
      }
  }
}

// ---------------------------------------------------------------------------
// K4, bf16 inputs: mma.sync in the S^T orientation. BKV/16 warps of 16 kv
// rows, times DSPLIT warps that split the head dim of the accumulators.
// ---------------------------------------------------------------------------
template <int BQ, int BKV, int DP, int DSPLIT>
__global__ void __launch_bounds__(BKV / 16 * DSPLIT * 32)
flash_bwd_kv_bf16(BwdParams p) {
  constexpr int RWARPS = BKV / 16;
  constexpr int NT = RWARPS * DSPLIT * 32;
  constexpr int DW = DP / DSPLIT;   // accumulator columns of one warp
  constexpr int QS = DP + 8;        // row-major tile stride
  constexpr int TS = BQ + 8;        // transposed Q / dO tile stride
  constexpr int NQT = BQ / 8;       // S^T / dP^T n-tiles (query columns)
  constexpr int NDT = DW / 8;       // dK / dV n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BKV * QS;
  bf16* sQ = sV + BKV * QS;         // pre-scaled Q, for S^T
  bf16* sdO = sQ + BQ * QS;
  bf16* sQt = sdO + BQ * QS;        // raw Q, transposed, for dK
  bf16* sdOt = sQt + DP * TS;
  float* sL = reinterpret_cast<float*>(sdOt + DP * TS);
  float* sD = sL + BQ;

  const int j = blockIdx.x, bhkv = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rw = (warp % RWARPS) * 16, dbase = (warp / RWARPS) * DW;
  const int R = p.R, C = p.C, D = p.D;
  const size_t kvoff = (size_t)bhkv * C * D;
  const int col0 = j * BKV;

  load_rows<BKV, DP, NT>(static_cast<const bf16*>(p.k) + kvoff, col0, C, D,
                         p.vec, 0.f, sK, nullptr, tid);
  load_rows<BKV, DP, NT>(static_cast<const bf16*>(p.v) + kvoff, col0, C, D,
                         p.vec, 0.f, sV, nullptr, tid);

  float dk[NDT][4], dv[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  int lo, hi;
  q_range(p, j, BQ, BKV, lo, hi);
  for (int gq = 0; gq < p.group; ++gq) {
    const int bh = bhkv * p.group + gq;
    const size_t qoff = (size_t)bh * R * D;
    const bf16* qg = static_cast<const bf16*>(p.q) + qoff;
    const bf16* dog = static_cast<const bf16*>(p.d_o) + qoff;
    for (int i = lo; i <= hi; ++i) {
      const int row0 = i * BQ;
      __syncthreads();   // previous tiles consumed
      load_rows<BQ, DP, NT>(qg, row0, R, D, p.vec, p.scale2, sQ, nullptr,
                            tid);
      load_rows<BQ, DP, NT>(qg, row0, R, D, p.vec, 0.f, nullptr, sQt, tid);
      load_rows<BQ, DP, NT>(dog, row0, R, D, p.vec, 0.f, sdO, sdOt, tid);
      for (int r = tid; r < BQ; r += NT) {
        const bool in = row0 + r < R;
        const size_t at = (size_t)bh * R + row0 + r;
        sL[r] = in ? p.lse[at] * kLog2e : 0.f;
        sD[r] = in ? p.dterm[at] : 0.f;
      }
      __syncthreads();

      // S^T = K Qs^T and dP^T = V dO^T for this warp's 16 kv rows.
      float s[NQT][4], dp[NQT][4];
#pragma unroll
      for (int n = 0; n < NQT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        uint32_t ak[4], av[4];
        load_a(ak, sK, QS, rw, kk, g, t4);
        load_a(av, sV, QS, rw, kk, g, t4);
#pragma unroll
        for (int n = 0; n < NQT; ++n) {
          mma_rows(s[n], ak, sQ, QS, n * 8, kk, g, t4);
          mma_rows(dp[n], av, sdO, QS, n * 8, kk, g, t4);
        }
      }
      // P^T in s, dS^T in dp; L and the D-term are per column here.
#pragma unroll
      for (int n = 0; n < NQT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = n * 8 + t4 * 2 + (e & 1);
          const int col = col0 + rw + g + 8 * (e >> 1);
          float prob;
          dp[n][e] = grad_score(p, s[n][e], dp[n][e], sL[rl], sD[rl],
                                visible(p, row0 + rl, col), prob);
          s[n][e] = prob;
        }
      // dV += P^T dO and dK += dS^T Q, from registers (rounded to bf16).
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        uint32_t ap[4], ads[4];
        acc_to_a(ap, s[2 * kc], s[2 * kc + 1]);
        acc_to_a(ads, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
        for (int n = 0; n < NDT; ++n) {
          mma_rows(dv[n], ap, sdOt, TS, dbase + n * 8, kc * 16, g, t4);
          mma_rows(dk[n], ads, sQt, TS, dbase + n * 8, kc * 16, g, t4);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = col0 + rw + g + 8 * h;
    if (c >= C) continue;
#pragma unroll
    for (int n = 0; n < NDT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = dbase + n * 8 + t4 * 2 + e;
        if (d >= D) continue;
        const size_t at = kvoff + (size_t)c * D + d;
        p.dk[at] = dk[n][2 * h + e];
        p.dv[at] = dv[n][2 * h + e];
      }
  }
}

// ---------------------------------------------------------------------------
// fp32 inputs: plain FMA, four warps. K3: lane = kv column of the 32-wide
// tile for S / dP, lane = head-dim column for dQ.
// ---------------------------------------------------------------------------
template <int BQ, int DP>
__global__ void __launch_bounds__(128)
flash_bwd_q_f32(BwdParams p) {
  constexpr int BKV = 32;
  constexpr int RW = BQ / 4;        // rows per warp
  constexpr int ND = DP / 32;       // dQ columns per lane
  constexpr int KS = DP + 1;        // K/V tile row stride (bank spread)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sdO = sQ + BQ * DP;
  float* sK = sdO + BQ * DP;
  float* sV = sK + BKV * KS;
  float* sL = sV + BKV * KS;
  float* sD = sL + BQ;

  const int i = blockIdx.x, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = p.R, C = p.C, D = p.D;
  const size_t qoff = (size_t)bh * R * D;
  const float* qg = static_cast<const float*>(p.q) + qoff;
  const float* dog = static_cast<const float*>(p.d_o) + qoff;
  const size_t kvoff = (size_t)(bh / p.group) * C * D;
  const float* kg = static_cast<const float*>(p.k) + kvoff;
  const float* vg = static_cast<const float*>(p.v) + kvoff;
  const int row0 = i * BQ;

  for (int idx = tid; idx < BQ * DP; idx += 128) {
    const int r = idx / DP, d = idx % DP;
    const bool in = row0 + r < R && d < D;
    sQ[idx] = in ? qg[(size_t)(row0 + r) * D + d] : 0.f;
    sdO[idx] = in ? dog[(size_t)(row0 + r) * D + d] : 0.f;
  }
  d_term<float, BQ, 128>(p, bh, row0, static_cast<const float*>(p.o), p.d_o,
                         true, sL, sD, warp, lane);

  float dq[RW][ND];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr)
#pragma unroll
    for (int n = 0; n < ND; ++n) dq[rr][n] = 0.f;

  int lo, hi;
  kv_range(p, i, BQ, BKV, lo, hi);
  for (int j = lo; j <= hi; ++j) {
    const int col0 = j * BKV;
    __syncthreads();
    for (int idx = tid; idx < BKV * DP; idx += 128) {
      const int r = idx / DP, d = idx % DP;
      const bool in = col0 + r < C && d < D;
      sK[r * KS + d] = in ? kg[(size_t)(col0 + r) * D + d] : 0.f;
      sV[r * KS + d] = in ? vg[(size_t)(col0 + r) * D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp * RW + rr;
      const float* qr = sQ + r * DP;
      const float* dor = sdO + r * DP;
      const float* kr = sK + lane * KS;
      const float* vr = sV + lane * KS;
      float x = 0.f, dpv = 0.f;
      for (int d = 0; d < DP; ++d) {
        x = fmaf(qr[d], kr[d], x);
        dpv = fmaf(dor[d], vr[d], dpv);
      }
      float prob;
      const float ds = grad_score(p, x * p.scale2, dpv, sL[r], sD[r],
                                  visible(p, row0 + r, col0 + lane), prob);
      for (int jj = 0; jj < BKV; ++jj) {
        const float dsj = __shfl_sync(kFull, ds, jj);
#pragma unroll
        for (int n = 0; n < ND; ++n)
          dq[rr][n] = fmaf(dsj, sK[jj * KS + lane + 32 * n], dq[rr][n]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = row0 + warp * RW + rr;
    if (r >= R) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = lane + 32 * n;
      if (d < D) p.dq[qoff + (size_t)r * D + d] = dq[rr][n];
    }
  }
}

// K4, fp32: lane = query column of the 32-wide q tile for S^T / dP^T,
// lane = head-dim column for dK / dV.
template <int BKV, int DP>
__global__ void __launch_bounds__(128)
flash_bwd_kv_f32(BwdParams p) {
  constexpr int BQ = 32;
  constexpr int RW = BKV / 4;       // kv rows per warp
  constexpr int ND = DP / 32;
  constexpr int QS = DP + 1;        // Q/dO tile row stride (bank spread)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + BKV * DP;
  float* sQ = sV + BKV * DP;
  float* sdO = sQ + BQ * QS;
  float* sL = sdO + BQ * QS;
  float* sD = sL + BQ;

  const int j = blockIdx.x, bhkv = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = p.R, C = p.C, D = p.D;
  const size_t kvoff = (size_t)bhkv * C * D;
  const float* kg = static_cast<const float*>(p.k) + kvoff;
  const float* vg = static_cast<const float*>(p.v) + kvoff;
  const int col0 = j * BKV;

  for (int idx = tid; idx < BKV * DP; idx += 128) {
    const int r = idx / DP, d = idx % DP;
    const bool in = col0 + r < C && d < D;
    sK[idx] = in ? kg[(size_t)(col0 + r) * D + d] : 0.f;
    sV[idx] = in ? vg[(size_t)(col0 + r) * D + d] : 0.f;
  }

  float dk[RW][ND], dv[RW][ND];
#pragma unroll
  for (int cc = 0; cc < RW; ++cc)
#pragma unroll
    for (int n = 0; n < ND; ++n) dk[cc][n] = dv[cc][n] = 0.f;

  int lo, hi;
  q_range(p, j, BQ, BKV, lo, hi);
  for (int gq = 0; gq < p.group; ++gq) {
    const int bh = bhkv * p.group + gq;
    const size_t qoff = (size_t)bh * R * D;
    const float* qg = static_cast<const float*>(p.q) + qoff;
    const float* dog = static_cast<const float*>(p.d_o) + qoff;
    for (int i = lo; i <= hi; ++i) {
      const int row0 = i * BQ;
      __syncthreads();
      for (int idx = tid; idx < BQ * DP; idx += 128) {
        const int r = idx / DP, d = idx % DP;
        const bool in = row0 + r < R && d < D;
        sQ[r * QS + d] = in ? qg[(size_t)(row0 + r) * D + d] : 0.f;
        sdO[r * QS + d] = in ? dog[(size_t)(row0 + r) * D + d] : 0.f;
      }
      for (int r = tid; r < BQ; r += 128) {
        const bool in = row0 + r < R;
        const size_t at = (size_t)bh * R + row0 + r;
        sL[r] = in ? p.lse[at] * kLog2e : 0.f;
        sD[r] = in ? p.dterm[at] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int cc = 0; cc < RW; ++cc) {
        const int c = warp * RW + cc;
        const float* kr = sK + c * DP;
        const float* vr = sV + c * DP;
        const float* qr = sQ + lane * QS;
        const float* dor = sdO + lane * QS;
        float x = 0.f, dpv = 0.f;
        for (int d = 0; d < DP; ++d) {
          x = fmaf(kr[d], qr[d], x);
          dpv = fmaf(vr[d], dor[d], dpv);
        }
        float prob;
        const float ds = grad_score(p, x * p.scale2, dpv, sL[lane], sD[lane],
                                    visible(p, row0 + lane, col0 + c), prob);
        for (int jj = 0; jj < BQ; ++jj) {
          const float pj = __shfl_sync(kFull, prob, jj);
          const float dsj = __shfl_sync(kFull, ds, jj);
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            dv[cc][n] = fmaf(pj, sdO[jj * QS + lane + 32 * n], dv[cc][n]);
            dk[cc][n] = fmaf(dsj, sQ[jj * QS + lane + 32 * n], dk[cc][n]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int cc = 0; cc < RW; ++cc) {
    const int c = col0 + warp * RW + cc;
    if (c >= C) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = lane + 32 * n;
      if (d >= D) continue;
      p.dk[kvoff + (size_t)c * D + d] = dk[cc][n];
      p.dv[kvoff + (size_t)c * D + d] = dv[cc][n];
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int grid_x, int grid_y, int threads,
                   size_t smem, const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(grid_x, grid_y), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int BQ, int BKV, int DP>
cudaError_t launch_q_bf16(int bh, const BwdParams& p, cudaStream_t s) {
  const size_t smem = sizeof(bf16) * (2 * BQ * (DP + 8) + 2 * BKV * (DP + 8)
                                      + DP * (BKV + 8)) + sizeof(float) * 2 * BQ;
  return launch(flash_bwd_q_bf16<BQ, BKV, DP>, (p.R + BQ - 1) / BQ, bh,
                BQ * 2, smem, p, s);
}

template <int BQ, int BKV, int DP>
cudaError_t launch_kv_bf16(int bhkv, const BwdParams& p, cudaStream_t s) {
  constexpr int DSPLIT = DP > 128 ? DP / 128 : 1;
  const size_t smem = sizeof(bf16) * (2 * BKV * (DP + 8) + 2 * BQ * (DP + 8)
                                      + 2 * DP * (BQ + 8)) + sizeof(float) * 2 * BQ;
  return launch(flash_bwd_kv_bf16<BQ, BKV, DP, DSPLIT>, (p.C + BKV - 1) / BKV,
                bhkv, BKV / 16 * DSPLIT * 32, smem, p, s);
}

template <int BQ, int DP>
cudaError_t launch_q_f32(int bh, const BwdParams& p, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * (2 * BQ * DP + 2 * 32 * (DP + 1) + 2 * BQ);
  return launch(flash_bwd_q_f32<BQ, DP>, (p.R + BQ - 1) / BQ, bh, 128, smem,
                p, s);
}

template <int BKV, int DP>
cudaError_t launch_kv_f32(int bhkv, const BwdParams& p, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * (2 * BKV * DP + 2 * 32 * (DP + 1) + 2 * 32);
  return launch(flash_bwd_kv_f32<BKV, DP>, (p.C + BKV - 1) / BKV, bhkv, 128,
                smem, p, s);
}

int vec_ok(int D, const void* a, const void* b, const void* c,
           const void* d) {
  const uintptr_t ptr_or =
      reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
      reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d);
  return (D % 8 == 0) && (ptr_or % 16 == 0);
}

}  // namespace

// K3. dtype: 0 = fp32, 1 = bf16 (q, k, v, d_o); o_f32: O is fp32 (else the
// input type). (block_q, block_kv, block_d) must be a row of
// ops/params.py's flash_bwd_q tables.
extern "C" int mfa_flash_bwd_q(const void* q, const void* k, const void* v,
                               const void* o, const void* d_o,
                               const void* lse, void* dq, void* dterm,
                               int bh, int group, int R, int C, int D,
                               int causal, int window, float scale2,
                               float cap2, float scale, int dtype, int o_f32,
                               int block_q, int block_kv, int block_d,
                               void* stream) {
  BwdParams p{q, k, v, o, d_o, static_cast<const float*>(lse),
              static_cast<float*>(dterm), static_cast<float*>(dq), nullptr,
              nullptr, group, R, C, D, causal, window, scale2, cap2, scale,
              o_f32, vec_ok(D, q, k, v, d_o)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (block_q == 16 && block_kv == 32) {
      if (block_d == 64) return launch_q_f32<16, 64>(bh, p, s);
      if (block_d == 128) return launch_q_f32<16, 128>(bh, p, s);
      if (block_d == 256) return launch_q_f32<16, 256>(bh, p, s);
    }
    return cudaErrorInvalidValue;
  }
  if (block_q == 64 && block_kv == 64 && block_d == 64)
    return launch_q_bf16<64, 64, 64>(bh, p, s);
  if (block_q == 64 && block_kv == 64 && block_d == 128)
    return launch_q_bf16<64, 64, 128>(bh, p, s);
  if (block_q == 64 && block_kv == 32 && block_d == 256)
    return launch_q_bf16<64, 32, 256>(bh, p, s);
  return cudaErrorInvalidValue;
}

// K4. dtype as for K3; the D-term is K3's. (block_q, block_kv, block_d)
// must be a row of ops/params.py's flash_bwd_kv tables.
extern "C" int mfa_flash_bwd_kv(const void* q, const void* k, const void* v,
                                const void* d_o, const void* lse,
                                const void* dterm, void* dk, void* dv,
                                int bhkv, int group, int R, int C, int D,
                                int causal, int window, float scale2,
                                float cap2, float scale, int dtype,
                                int block_q, int block_kv, int block_d,
                                void* stream) {
  BwdParams p{q, k, v, nullptr, d_o, static_cast<const float*>(lse),
              const_cast<float*>(static_cast<const float*>(dterm)), nullptr,
              static_cast<float*>(dk), static_cast<float*>(dv), group, R, C,
              D, causal, window, scale2, cap2, scale, 0,
              vec_ok(D, q, k, v, d_o)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (block_q == 32 && block_kv == 16) {
      if (block_d == 64) return launch_kv_f32<16, 64>(bhkv, p, s);
      if (block_d == 128) return launch_kv_f32<16, 128>(bhkv, p, s);
      if (block_d == 256) return launch_kv_f32<16, 256>(bhkv, p, s);
    }
    return cudaErrorInvalidValue;
  }
  if (block_q == 32 && block_kv == 64) {
    if (block_d == 64) return launch_kv_bf16<32, 64, 64>(bhkv, p, s);
    if (block_d == 128) return launch_kv_bf16<32, 64, 128>(bhkv, p, s);
    if (block_d == 256) return launch_kv_bf16<32, 64, 256>(bhkv, p, s);
  }
  return cudaErrorInvalidValue;
}
