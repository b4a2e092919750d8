// Flash-attention backward for Hopper (sm_90a): two kernels, no atomics.
//
// K3 flash_bwd_q replaces mfa_tpu/kernels/flash_bwd.py::_bwd_q_kernel
// (build_bwd_query). A CTA owns a q-block of one batch*head. It first
// computes the D-term rowsum(dO * O) in fp32 from O in its stored type,
// then walks its live kv blocks (the bounds K1 uses) with S = Qs K^T,
// P = exp2(S - L*log2e), dP = dO V^T, dS = P (dP - D) * cap' * scale and
// dQ += dS K. Outputs dQ [BH, R, D] and the D-term [BH, R], both fp32.
//
// K4 flash_bwd_kv replaces ::_bwd_kv_kernel (build_bwd_key_value). A CTA
// owns a kv block of one batch*kv-head and walks (query head g of the GQA
// group) x (live q-blocks), so dK and dV of a kv head accumulate over the
// whole group in registers: deterministic, no atomics, no second pass. It
// computes the transposed orientation S^T = K Qs^T (the original Metal
// kernel's), whose accumulators are already the A operands of P^T dO and
// dS^T Q. A kv block that no query sees still writes dK = dV = 0.
//
// Rounding points kept from the TPU kernels: S from Q pre-scaled by
// scale*log2e and rounded to bf16 (Qs; bf16 inputs; fp32 scales S
// instead), the raw Q for dK, the soft-cap derivative taken in the log2
// domain, dS multiplied by scale (not scale*log2e), P rounded to bf16
// only for dV and dS rounded to bf16 before dQ and dK (bf16 inputs), fp32
// accumulation, the large-finite mask sentinel (P = 0 where masked), and
// the diagonal aligned to the sequence ends (offset = C - R, floor
// division when negative).
//
// What bounds them on an H100: at Llama-3-8B widths (32 query heads, 8 kv
// heads, N = 2048, D = 128, causal) K3 does 6*D FLOP per visible pair
// (~52 GFLOP, ~0.052 ms at the 989 TFLOP/s bf16 tensor-core peak) and K4
// 8*D (~69 GFLOP, ~0.069 ms) against ~20 MB of operand traffic (~6 us at
// 3.35 TB/s): the bound is operations, so the design feeds the tensor
// cores from shared memory without stalls.
//
// bf16, D % 8 == 0 and D <= 128, 16-byte-aligned operands (rows "wgmma"
// of ops/params.py): warp-specialised kernels, 384 threads = two consumer
// warpgroups and one producer warpgroup (setmaxnreg: 240 / 24 registers).
// One producer thread keeps TMA loads in flight (cp.async.bulk.tensor
// into 128-byte-swizzled panels, one mbarrier a stage; rows past R or C
// arrive as zeros) and the consumers wait only on those mbarriers and on
// barriers of their own warpgroup. Every product is wgmma (bf16 -> fp32,
// hopper.cuh); B operands are read K-major or MN-major from the same
// tiles through the descriptor's transpose bit, so no tile is stored
// transposed, and P^T / dS^T / dS feed the next product as register A
// operands.
// - K3: a CTA owns 128 query rows (64 a consumer warpgroup; Q and dO
//   resident, Q scaled once in place) and streams K and V through a ring
//   of up to 4 stages of block_kv rows (as many as fit). S = Qs K^T and dP = dO V^T read K and V
//   K-major; dQ += dS K reads the same K tile MN-major. A warpgroup skips
//   the kv blocks none of its rows sees. The head-dim-split kernel below
//   (one CTA, 64- or 128-wide panel, block_kv 64; a sweep candidate)
//   walks those blocks too: it measured no faster at D = 128 and 4.5%
//   slower at D = 64 (utils/bwd_tuning.py sweep; PERF.md), so this
//   kernel keeps the rows up to D = 128.
// - K4: a CTA owns 64 kv rows (K and V resident) and streams Q and dO (by
//   TMA) and L and the D-term (cp.async by the producer warp: a TMA box
//   of fp32 rows starts 16-byte aligned only when R % 4 == 0, and a
//   misaligned one was an illegal instruction on the H100) through a ring
//   of 4 stages of block_q rows; the two
//   consumer warpgroups take alternate q steps of the walk (stage s goes
//   to warpgroup s % 2), each with its own dK and dV in registers (64 + 64
//   fp32 a thread at D = 128), summed in a fixed order at the end:
//   bit-reproducible. Each warpgroup scales its Q tile into a private
//   buffer (Qs, the B operand of S^T = K Qs^T) and keeps the raw tile for
//   dK += dS^T Q.
// - Grid: the flat tile index on grid.x (no 65535 limit on batch *
//   heads), heaviest walk first (K3: the last q-blocks, whose causal walks
//   are longest; K4: the first kv blocks). At chip_smoke.py's causal shape
//   (N 2048, Hq 32, Hkv 8, D 128; rows of ops/params.py): K3 runs 16 x 32
//   = 512 CTAs whose walks are 2..32 kv steps of 64 (a CTA's two
//   warpgroups skip the steps past their own rows' diagonal); K4 runs 32
//   x 8 = 256 CTAs whose walks are 4 heads x (64 - 2j) q steps of 32 for
//   kv block j, 256 down to 8, taken in turn by the two warpgroups. Both
//   run 1 CTA an SM (shared memory: K3 ~199 KB, K4 ~117 KB with 384
//   threads of 240 / 24 registers), so the 132 heaviest CTAs start first
//   and the lighter ones fill in behind them.
//
// Past D = 128, K3 and K4 on bf16 rows TMA can map, up to D = 512 (rows
// "wgmma_dblk"; K1 past D = 256 in csrc/flash_fwd.cu): the head dim split
// across the CTAs of a thread-block cluster, one CTA up to D = 256 (a
// 192- or 256-wide panel holds the whole head dim) and two past it. CTA p
// loads panel p (block_d columns from p * block_d; columns past D arrive
// as zeros) of its operands by TMA and owns that panel of the outputs;
// the CTAs of a cluster walk the same steps, and the panels' partial
// products (K3: S and dP; K4: S^T and dP^T) are summed across the cluster
// in rank order (hopper.cuh ClusterSum, as in K1), so every CTA holds the
// same bits and forms the same P and dS: S and dP once a (q-block,
// kv-block) pair, as mfa_tpu's D-paged kernels (flash_bwd.py:175-235,
// :530-660), no atomics.
// - K3 (flash_bwd_q_split): a CTA owns 128 query rows, 64 a consumer
//   warpgroup as at D <= 128, Q and dO resident (Q scaled in place), K
//   and V streamed in 32-row blocks through two rings: V's stage is freed
//   once dP is formed, K's is kept for the deferred product below. Each
//   warpgroup forms its rows' partial S and dP, exchanges both with its
//   twin in one ClusterSum, forms dS and issues dQ += dS K for its panel
//   (64 x block_d fp32, at most 128 registers a thread) into the next
//   step, where it runs under that step's exchange and dS, as K1 defers
//   its PV. The D-term is formed over the whole head dim in every CTA
//   (the same bits); rank 0 stores it.
// - K4 (flash_bwd_kv_split): a CTA owns 64 kv rows, and its consumer
//   warpgroups split the outputs rather than the steps. Warpgroup 1 forms
//   S^T's partial and owns dV, warpgroup 0 dP^T's and owns dK (64 x
//   block_d fp32, at most 128 registers a thread); each sums with its
//   twin in the other CTA (a CTA alone skips the exchange), and
//   warpgroup 1 hands the summed S^T to warpgroup 0 through a double
//   buffer. Each step's dV / dK product is deferred into the next step,
//   as K1 defers its PV, and runs under that step's partial and exchange.
// - Panels measured and not kept (utils/bwd_tuning.py sweep, PERF.md): K4
//   at D <= 128's design (warpgroups taking alternate steps) on 128-wide
//   panels in clusters of 3-4, and this K4 on two 128-wide panels at D
//   256: time follows exchanges per FLOP, and a CTA alone has none.
// - What bounds them (B 1, H 8, N 4096, causal): K3 6 D and K4 8 D FLOP
//   a visible pair, 0.10 / 0.14 ms at D 256 and 0.16 / 0.21 at D 384 at
//   the bf16 peak: bound by operations. One CTA runs K3 at 2.3x that
//   bound and K4 at 3.8x (D 256); two CTAs 6x and 7x (D 384): a step's
//   products are short (64 x 32 a warpgroup), and each step waits for the
//   partner CTA's partials, latency rather than bytes (one bulk copy a
//   partial in place of the st.async stores measured no faster in K4).
//
// bf16 rows TMA cannot map (D % 8 != 0, a base off 16 bytes) up to D =
// 256, where q, k, v, dO and the row stride 2 D share 4 bytes (D even;
// OpenLLaMA-3B's D 100: 200-byte rows, 8-byte aligned): the same wgmma
// kernels and rows, K3's and K4's of D <= 128 and their one-CTA
// head-dim-split ones (PROD, a template flag; the TMA instances compile
// as before), with a copying producer, as K1's (csrc/flash_fwd.cu). Its
// 128 threads issue cp.async of that granule (8 or 4 bytes) straight into
// the swizzled slots (hopper.cuh copy_rows), rows past R or C as
// zero-source copies, each thread's copies counted on the tile's full
// barrier (cp.async.mbarrier.arrive.noinc: 128 arrivals, K4's L and
// D-term among them). The columns D..DP-1 no copy writes are zeroed once
// at the start in every resident tile and ring slot (and fenced); they
// stay zero, so every product sees zeros there, the scaled-Q tiles
// inherit them, and dQ, dK, dV are stored below column D only. cp.async
// writes through the generic proxy and wgmma reads through the async
// one, so each consumer thread fences (fence.proxy.async) after its
// full-barrier wait, before the products that read the tile (K4's Q and
// dO by the fence that follows its scaling). The instances' layouts are
// compile-time, as TMA's: the rings take at most kQCopyStages and
// kKvCopyStages; K4's warpgroup 1 passes its dK and dV through shared
// memory from K's tile on, which a shallower ring than TMA's may need.
// dK and dV keep their fixed order of sums.
// What bounds them at OpenLLaMA-3B's D 100 (Hq = Hkv 32, N 2048, causal):
// the tensor work is the 128-wide panel's, 6 D and 8 D FLOP a visible
// pair (0.041 / 0.054 ms at the bf16 peak), and the producer's copies,
// issued by four warps that share the SMs' schedulers with the consumers.
// On the H100 (NVIDIA H100 80GB HBM3, 700 W; utils/bwd_tuning.py sweep
// --only copy; the rings of ops/params.py): K3 0.2223 ms (5.5x its
// bound), K4 0.4232 (7.8x), against the mma.sync rows' 1.418 and 1.500;
// at D 250 (H 8, N 1024, causal) K3 0.1304 and K4 0.1149 against 0.3775
// and 0.3634. K4 copies Q, dO, L and the D-term for every 32-row step.
//
// Other rows keep the first cut: bf16 where neither TMA nor the copying
// producer can take the operands (odd D, a base only 2-byte aligned, D %
// 8 != 0 past D = 256) runs warp-level mma.sync (m16n8k16) from
// shared-memory tiles loaded synchronously (rows "mma"); fp32 inputs take
// plain-FMA kernels:
// TF32 would miss the fp32 gradient budget. The mma K4 keeps two fp32 [16
// x D] accumulators per warp (128 registers a thread at D = 128); at D =
// 256 its warps split the head dim in two. Past D = 256 the same kernels
// run D-blocked (DBLK; rows "mma_dblk", "fma_dblk"; see flash_bwd_q_bf16
// and flash_bwd_kv_bf16): a CTA per block_d panel of dQ (K3) or of dK and
// dV (K4), S and dP summed once a panel over streamed panels, where the
// split kernels cannot take the row (D % 8 != 0, a misaligned base, D >
// 512) and for fp32. K4's two accumulators leave ptxas short of
// registers there, and it spills (chip_smoke.py's build line lists each
// instance past D = 256).

#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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
  int gran;     // bytes every base (q, k, v, dO) and row stride share
};

// The copying producer's ring depths (ops/params.py mirrors them as
// BWD_Q_COPY_RING_STAGES and BWD_KV_COPY_RING_STAGES): the most tiles of
// K3's K and V ring, or of each of its head-dim-split kernel's two, and
// the most stages of K4's ring each consumer warpgroup cycles through.
// utils/bwd_tuning.py sweep --only copy builds the library again with
// others (-DMFA_BWD_Q_COPY_STAGES=n, -DMFA_BWD_KV_COPY_STAGES=n).
#ifndef MFA_BWD_Q_COPY_STAGES
#define MFA_BWD_Q_COPY_STAGES 3
#endif
#ifndef MFA_BWD_KV_COPY_STAGES
#define MFA_BWD_KV_COPY_STAGES 3
#endif
constexpr int kQCopyStages = MFA_BWD_Q_COPY_STAGES;
constexpr int kKvCopyStages = MFA_BWD_KV_COPY_STAGES;

__device__ __forceinline__ bool visible(const BwdParams& p, int row,
                                        int col) {
  return row < p.R && visible_rc(row, col, p.R, p.C, p.causal, p.window);
}

// dS from S (already scaled into the log2 domain), dP and the row's L2 =
// L*log2e and D-term; also returns P. Masked entries give P = dS = 0. CAP:
// the soft-cap applies (p.cap2 > 0), decided at compile time so that an
// unrolled loop over accumulator fragments has no branch per element.
template <bool CAP>
__device__ __forceinline__ float grad_score_t(const BwdParams& p, float s,
                                              float dp, float l2, float dt,
                                              bool vis, float& prob) {
  float x = s, cg = 1.f;
  if constexpr (CAP) {
    const float t = tanhf(s / p.cap2);
    cg = 1.f - t * t;
    x = p.cap2 * t;
  }
  if (!vis) x = kMaskValue;
  prob = exp2f(x - l2);
  return ((prob * (dp - dt)) * cg) * p.scale;
}

__device__ __forceinline__ float grad_score(const BwdParams& p, float s,
                                            float dp, float l2, float dt,
                                            bool vis, float& prob) {
  return p.cap2 > 0.f ? grad_score_t<true>(p, s, dp, l2, dt, vis, prob)
                      : grad_score_t<false>(p, s, dp, l2, dt, vis, prob);
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

// The D-term of rows [row0, row0 + BQ) of head bh (one warp per row, over
// the whole head dim) into sD and, when `store`, global memory, and
// L*log2e into sL. Rows past R get zeros.
template <typename OT, int BQ, int NT>
__device__ __forceinline__ void d_term(const BwdParams& p, int bh, int row0,
                                       const OT* og, const void* dog,
                                       bool do_f32, float* sL, float* sD,
                                       int warp, int lane, bool store = true) {
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
      if (lane == 0 && store) p.dterm[(size_t)bh * p.R + row] = acc;
    }
    if (lane == 0) {
      sD[r] = acc;
      sL[r] = l2;
    }
  }
}

// ---------------------------------------------------------------------------
// K3, bf16 inputs: mma.sync, four warps of 16 query rows. DBLK (rows
// "mma_dblk"): head-dim blocking, mfa_tpu's D-paged _bwd_q_kernel
// (flash_bwd.py:175-235). The CTA owns dQ's columns [panel * DP, panel *
// DP + DP) of its q-block; S = Qs K^T and dP = dO V^T are summed over
// DP-wide panels of Q, dO, K and V streamed through shared memory (the
// same order in every panel CTA, so each forms the same dS), and dQ +=
// dS K takes K's own panel. Each panel CTA forms the D-term over the
// whole head dim; panel 0 stores it.
// ---------------------------------------------------------------------------
template <int BQ, int BKV, int DP, bool DBLK>
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

  const int nqb = (p.R + BQ - 1) / BQ;
  const int panels = DBLK ? (p.D + DP - 1) / DP : 1;
  const int tile = (int)blockIdx.x / panels;
  const int panel = (int)blockIdx.x % panels;
  const int i = tile % nqb, bh = tile / nqb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int R = p.R, C = p.C, D = p.D;
  const size_t qoff = (size_t)bh * R * D;
  const size_t kvoff = (size_t)(bh / p.group) * C * D;
  const bf16* qg = static_cast<const bf16*>(p.q) + qoff;
  const bf16* dog = static_cast<const bf16*>(p.d_o) + qoff;
  const bf16* kg = static_cast<const bf16*>(p.k) + kvoff;
  const bf16* vg = static_cast<const bf16*>(p.v) + kvoff;
  const int row0 = i * BQ;
  const int dcol = panel * DP;     // this CTA's dQ columns start here

  if constexpr (!DBLK) {
    load_rows<BQ, DP, NT>(qg, row0, R, D, p.vec, p.scale2, sQ, nullptr, tid);
    load_rows<BQ, DP, NT>(dog, row0, R, D, p.vec, 0.f, sdO, nullptr, tid);
  }
  if (p.o_f32)
    d_term<float, BQ, NT>(p, bh, row0, static_cast<const float*>(p.o),
                          p.d_o, false, sL, sD, warp, lane, panel == 0);
  else
    d_term<bf16, BQ, NT>(p, bh, row0, static_cast<const bf16*>(p.o), p.d_o,
                         false, sL, sD, warp, lane, panel == 0);
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
    // S = Qs K^T and dP = dO V^T for this warp's 16 rows, over the head
    // dim's panels (one unless DBLK); the transposed K tile is the panel
    // of this CTA's dQ columns.
    float s[NKT][4], dp[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    for (int d0 = 0; d0 < (DBLK ? D : 1); d0 += DP) {
      __syncthreads();   // previous tiles consumed
      if constexpr (DBLK) {
        load_panel<BQ, DP, NT>(qg, row0, R, D, d0, p.vec, p.scale2, sQ,
                               nullptr, tid);
        load_panel<BQ, DP, NT>(dog, row0, R, D, d0, p.vec, 0.f, sdO, nullptr,
                               tid);
        load_panel<BKV, DP, NT>(kg, col0, C, D, d0, p.vec, 0.f, sK,
                                d0 == dcol ? sKt : nullptr, tid);
        load_panel<BKV, DP, NT>(vg, col0, C, D, d0, p.vec, 0.f, sV, nullptr,
                                tid);
        cp_async_wait_all();
      } else {
        load_rows<BKV, DP, NT>(kg, col0, C, D, p.vec, 0.f, sK, sKt, tid);
        load_rows<BKV, DP, NT>(vg, col0, C, D, p.vec, 0.f, sV, nullptr, tid);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        if (DBLK && d0 + kk >= D) break;   // the last panel's zero tail
        uint32_t aq[4], ad[4];
        load_a(aq, sQ, QS, warp * 16, kk, g, t4);
        load_a(ad, sdO, QS, warp * 16, kk, g, t4);
#pragma unroll
        for (int n = 0; n < NKT; ++n) {
          mma_rows(s[n], aq, sK, QS, n * 8, kk, g, t4);
          mma_rows(dp[n], ad, sV, QS, n * 8, kk, g, t4);
        }
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
      for (int n = 0; n < NDT; ++n) {
        if (DBLK && dcol + n * 8 >= D) break;   // past the last column
        mma_rows(dq[n], a, sKt, TS, n * 8, kc * 16, g, t4);
      }
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
        const int d = dcol + n * 8 + t4 * 2 + e;
        if (d < D) p.dq[qoff + (size_t)r * D + d] = dq[n][2 * h + e];
      }
  }
}

// ---------------------------------------------------------------------------
// K4, bf16 inputs: mma.sync in the S^T orientation. BKV/16 warps of 16 kv
// rows, times DSPLIT warps that split the head dim of the accumulators.
// DBLK (rows "mma_dblk"): head-dim blocking, mfa_tpu's D-paged
// _bwd_kv_kernel (flash_bwd.py:530-656). The CTA owns dK's and dV's
// columns [panel * DP, panel * DP + DP) of its kv block; S^T = K Qs^T and
// dP^T = V dO^T are summed over DP-wide panels of K, V, Q and dO streamed
// through shared memory (one order in every panel CTA), and dV += P^T dO,
// dK += dS^T Q take the panel of Q and dO that holds its own columns.
// ---------------------------------------------------------------------------
template <int BQ, int BKV, int DP, int DSPLIT, bool DBLK>
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

  const int nkvb = (p.C + BKV - 1) / BKV;
  const int panels = DBLK ? (p.D + DP - 1) / DP : 1;
  const int tile = (int)blockIdx.x / panels;
  const int panel = (int)blockIdx.x % panels;
  const int j = tile % nkvb, bhkv = tile / nkvb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rw = (warp % RWARPS) * 16, dbase = (warp / RWARPS) * DW;
  const int R = p.R, C = p.C, D = p.D;
  const size_t kvoff = (size_t)bhkv * C * D;
  const bf16* kg = static_cast<const bf16*>(p.k) + kvoff;
  const bf16* vg = static_cast<const bf16*>(p.v) + kvoff;
  const int col0 = j * BKV;
  const int dcol = panel * DP;      // this CTA's dK / dV columns start here

  if constexpr (!DBLK) {
    load_rows<BKV, DP, NT>(kg, col0, C, D, p.vec, 0.f, sK, nullptr, tid);
    load_rows<BKV, DP, NT>(vg, col0, C, D, p.vec, 0.f, sV, nullptr, tid);
  }

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
      // S^T = K Qs^T and dP^T = V dO^T for this warp's 16 kv rows, over
      // the head dim's panels (one unless DBLK); the transposed Q and dO
      // tiles are the panel of this CTA's dK / dV columns.
      float s[NQT][4], dp[NQT][4];
#pragma unroll
      for (int n = 0; n < NQT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      for (int d0 = 0; d0 < (DBLK ? D : 1); d0 += DP) {
        __syncthreads();   // previous tiles consumed
        if constexpr (DBLK) {
          const bool own = d0 == dcol;
          load_panel<BKV, DP, NT>(kg, col0, C, D, d0, p.vec, 0.f, sK, nullptr,
                                  tid);
          load_panel<BKV, DP, NT>(vg, col0, C, D, d0, p.vec, 0.f, sV, nullptr,
                                  tid);
          load_panel<BQ, DP, NT>(qg, row0, R, D, d0, p.vec, p.scale2, sQ,
                                 nullptr, tid);
          if (own)
            load_panel<BQ, DP, NT>(qg, row0, R, D, d0, p.vec, 0.f, nullptr,
                                   sQt, tid);
          load_panel<BQ, DP, NT>(dog, row0, R, D, d0, p.vec, 0.f, sdO,
                                 own ? sdOt : nullptr, tid);
        } else {
          load_rows<BQ, DP, NT>(qg, row0, R, D, p.vec, p.scale2, sQ, nullptr,
                                tid);
          load_rows<BQ, DP, NT>(qg, row0, R, D, p.vec, 0.f, nullptr, sQt,
                                tid);
          load_rows<BQ, DP, NT>(dog, row0, R, D, p.vec, 0.f, sdO, sdOt, tid);
        }
        if (d0 == 0)
          for (int r = tid; r < BQ; r += NT) {
            const bool in = row0 + r < R;
            const size_t at = (size_t)bh * R + row0 + r;
            sL[r] = in ? p.lse[at] * kLog2e : 0.f;
            sD[r] = in ? p.dterm[at] : 0.f;
          }
        if constexpr (DBLK) cp_async_wait_all();
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < DP; kk += 16) {
          if (DBLK && d0 + kk >= D) break;   // the last panel's zero tail
          uint32_t ak[4], av[4];
          load_a(ak, sK, QS, rw, kk, g, t4);
          load_a(av, sV, QS, rw, kk, g, t4);
#pragma unroll
          for (int n = 0; n < NQT; ++n) {
            mma_rows(s[n], ak, sQ, QS, n * 8, kk, g, t4);
            mma_rows(dp[n], av, sdO, QS, n * 8, kk, g, t4);
          }
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
          if (DBLK && dcol + dbase + n * 8 >= D) break;   // past the last
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
        const int d = dcol + dbase + n * 8 + t4 * 2 + e;
        if (d >= D) continue;
        const size_t at = kvoff + (size_t)c * D + d;
        p.dk[at] = dk[n][2 * h + e];
        p.dv[at] = dv[n][2 * h + e];
      }
  }
}

// ---------------------------------------------------------------------------
// fp32 inputs: plain FMA, four warps. K3: lane = kv column of the 32-wide
// tile for S / dP, lane = head-dim column for dQ. DBLK (rows "fma_dblk"):
// head-dim blocking as in flash_bwd_q_bf16; K's panel of this CTA's dQ
// columns is kept apart (sKd) while the other panels stream through sK.
// ---------------------------------------------------------------------------
template <int BQ, int DP, bool DBLK>
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
  float* sKd = DBLK ? sD + BQ : sK;  // K's panel of the dQ columns

  const int nqb = (p.R + BQ - 1) / BQ;
  const int panels = DBLK ? (p.D + DP - 1) / DP : 1;
  const int tile = (int)blockIdx.x / panels;
  const int panel = (int)blockIdx.x % panels;
  const int i = tile % nqb, bh = tile / nqb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = p.R, C = p.C, D = p.D;
  const size_t qoff = (size_t)bh * R * D;
  const float* qg = static_cast<const float*>(p.q) + qoff;
  const float* dog = static_cast<const float*>(p.d_o) + qoff;
  const size_t kvoff = (size_t)(bh / p.group) * C * D;
  const float* kg = static_cast<const float*>(p.k) + kvoff;
  const float* vg = static_cast<const float*>(p.v) + kvoff;
  const int row0 = i * BQ;
  const int dcol = panel * DP;      // this CTA's dQ columns start here

  if constexpr (!DBLK) {
    for (int idx = tid; idx < BQ * DP; idx += 128) {
      const int r = idx / DP, d = idx % DP;
      const bool in = row0 + r < R && d < D;
      sQ[idx] = in ? qg[(size_t)(row0 + r) * D + d] : 0.f;
      sdO[idx] = in ? dog[(size_t)(row0 + r) * D + d] : 0.f;
    }
  }
  d_term<float, BQ, 128>(p, bh, row0, static_cast<const float*>(p.o), p.d_o,
                         true, sL, sD, warp, lane, panel == 0);

  float dq[RW][ND];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr)
#pragma unroll
    for (int n = 0; n < ND; ++n) dq[rr][n] = 0.f;

  int lo, hi;
  kv_range(p, i, BQ, BKV, lo, hi);
  for (int j = lo; j <= hi; ++j) {
    const int col0 = j * BKV;
    // S and dP of each row, over the head dim's panels (one unless DBLK).
    float xs[RW], dps[RW];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) xs[rr] = dps[rr] = 0.f;
    for (int d0 = 0; d0 < (DBLK ? D : 1); d0 += DP) {
      __syncthreads();
      if constexpr (DBLK) {
        load_panel_f32<BQ, DP, DP, 128>(qg, row0, R, D, d0, sQ, tid);
        load_panel_f32<BQ, DP, DP, 128>(dog, row0, R, D, d0, sdO, tid);
        load_panel_f32<BKV, DP, KS, 128>(kg, col0, C, D, d0, sK, tid);
        load_panel_f32<BKV, DP, KS, 128>(vg, col0, C, D, d0, sV, tid);
        if (d0 == dcol)
          load_panel_f32<BKV, DP, KS, 128>(kg, col0, C, D, d0, sKd, tid);
        cp_async_wait_all();
      } else {
        for (int idx = tid; idx < BKV * DP; idx += 128) {
          const int r = idx / DP, d = idx % DP;
          const bool in = col0 + r < C && d < D;
          sK[r * KS + d] = in ? kg[(size_t)(col0 + r) * D + d] : 0.f;
          sV[r * KS + d] = in ? vg[(size_t)(col0 + r) * D + d] : 0.f;
        }
      }
      __syncthreads();
      if constexpr (DBLK) {
        const int dn = min(DP, D - d0);
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) {
          const int r = warp * RW + rr;
          const float* qr = sQ + r * DP;
          const float* dor = sdO + r * DP;
          const float* kr = sK + lane * KS;
          const float* vr = sV + lane * KS;
          float x = xs[rr], dpv = dps[rr];
          for (int d = 0; d < dn; ++d) {
            x = fmaf(qr[d], kr[d], x);
            dpv = fmaf(dor[d], vr[d], dpv);
          }
          xs[rr] = x;
          dps[rr] = dpv;
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp * RW + rr;
      float x = xs[rr], dpv = dps[rr];
      if constexpr (!DBLK) {   // the one panel, a row at a time
        const float* qr = sQ + r * DP;
        const float* dor = sdO + r * DP;
        const float* kr = sK + lane * KS;
        const float* vr = sV + lane * KS;
        for (int d = 0; d < DP; ++d) {
          x = fmaf(qr[d], kr[d], x);
          dpv = fmaf(dor[d], vr[d], dpv);
        }
      }
      float prob;
      const float ds = grad_score(p, x * p.scale2, dpv, sL[r], sD[r],
                                  visible(p, row0 + r, col0 + lane), prob);
      for (int jj = 0; jj < BKV; ++jj) {
        const float dsj = __shfl_sync(kFull, ds, jj);
#pragma unroll
        for (int n = 0; n < ND; ++n)
          dq[rr][n] = fmaf(dsj, sKd[jj * KS + lane + 32 * n], dq[rr][n]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = row0 + warp * RW + rr;
    if (r >= R) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = dcol + lane + 32 * n;
      if (d < D) p.dq[qoff + (size_t)r * D + d] = dq[rr][n];
    }
  }
}

// K4, fp32: lane = query column of the 32-wide q tile for S^T / dP^T,
// lane = head-dim column for dK / dV. DBLK: head-dim blocking as in
// flash_bwd_kv_bf16; Q's and dO's panels of this CTA's columns are kept
// apart (sQd, sdOd) while the other panels stream through sQ and sdO.
template <int BKV, int DP, bool DBLK>
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
  float* sQd = DBLK ? sD + BQ : sQ;   // the panels of the dK / dV columns
  float* sdOd = DBLK ? sQd + BQ * QS : sdO;

  const int nkvb = (p.C + BKV - 1) / BKV;
  const int panels = DBLK ? (p.D + DP - 1) / DP : 1;
  const int tile = (int)blockIdx.x / panels;
  const int panel = (int)blockIdx.x % panels;
  const int j = tile % nkvb, bhkv = tile / nkvb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = p.R, C = p.C, D = p.D;
  const size_t kvoff = (size_t)bhkv * C * D;
  const float* kg = static_cast<const float*>(p.k) + kvoff;
  const float* vg = static_cast<const float*>(p.v) + kvoff;
  const int col0 = j * BKV;
  const int dcol = panel * DP;      // this CTA's dK / dV columns start here

  if constexpr (!DBLK) {
    for (int idx = tid; idx < BKV * DP; idx += 128) {
      const int r = idx / DP, d = idx % DP;
      const bool in = col0 + r < C && d < D;
      sK[idx] = in ? kg[(size_t)(col0 + r) * D + d] : 0.f;
      sV[idx] = in ? vg[(size_t)(col0 + r) * D + d] : 0.f;
    }
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
      // S^T and dP^T of each kv row, over the head dim's panels (one
      // unless DBLK).
      float xs[RW], dps[RW];
#pragma unroll
      for (int cc = 0; cc < RW; ++cc) xs[cc] = dps[cc] = 0.f;
      for (int d0 = 0; d0 < (DBLK ? D : 1); d0 += DP) {
        __syncthreads();
        if constexpr (DBLK) {
          load_panel_f32<BKV, DP, DP, 128>(kg, col0, C, D, d0, sK, tid);
          load_panel_f32<BKV, DP, DP, 128>(vg, col0, C, D, d0, sV, tid);
          load_panel_f32<BQ, DP, QS, 128>(qg, row0, R, D, d0, sQ, tid);
          load_panel_f32<BQ, DP, QS, 128>(dog, row0, R, D, d0, sdO, tid);
          if (d0 == dcol) {
            load_panel_f32<BQ, DP, QS, 128>(qg, row0, R, D, d0, sQd, tid);
            load_panel_f32<BQ, DP, QS, 128>(dog, row0, R, D, d0, sdOd, tid);
          }
        } else {
          for (int idx = tid; idx < BQ * DP; idx += 128) {
            const int r = idx / DP, d = idx % DP;
            const bool in = row0 + r < R && d < D;
            sQ[r * QS + d] = in ? qg[(size_t)(row0 + r) * D + d] : 0.f;
            sdO[r * QS + d] = in ? dog[(size_t)(row0 + r) * D + d] : 0.f;
          }
        }
        if (d0 == 0)
          for (int r = tid; r < BQ; r += 128) {
            const bool in = row0 + r < R;
            const size_t at = (size_t)bh * R + row0 + r;
            sL[r] = in ? p.lse[at] * kLog2e : 0.f;
            sD[r] = in ? p.dterm[at] : 0.f;
          }
        if constexpr (DBLK) cp_async_wait_all();
        __syncthreads();
        if constexpr (DBLK) {
          const int dn = min(DP, D - d0);
#pragma unroll
          for (int cc = 0; cc < RW; ++cc) {
            const int c = warp * RW + cc;
            const float* kr = sK + c * DP;
            const float* vr = sV + c * DP;
            const float* qr = sQ + lane * QS;
            const float* dor = sdO + lane * QS;
            float x = xs[cc], dpv = dps[cc];
            for (int d = 0; d < dn; ++d) {
              x = fmaf(kr[d], qr[d], x);
              dpv = fmaf(vr[d], dor[d], dpv);
            }
            xs[cc] = x;
            dps[cc] = dpv;
          }
        }
      }
#pragma unroll
      for (int cc = 0; cc < RW; ++cc) {
        const int c = warp * RW + cc;
        float x = xs[cc], dpv = dps[cc];
        if constexpr (!DBLK) {   // the one panel, a row at a time
          const float* kr = sK + c * DP;
          const float* vr = sV + c * DP;
          const float* qr = sQ + lane * QS;
          const float* dor = sdO + lane * QS;
          for (int d = 0; d < DP; ++d) {
            x = fmaf(kr[d], qr[d], x);
            dpv = fmaf(vr[d], dor[d], dpv);
          }
        }
        float prob;
        const float ds = grad_score(p, x * p.scale2, dpv, sL[lane], sD[lane],
                                    visible(p, row0 + lane, col0 + c), prob);
        for (int jj = 0; jj < BQ; ++jj) {
          const float pj = __shfl_sync(kFull, prob, jj);
          const float dsj = __shfl_sync(kFull, ds, jj);
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            dv[cc][n] = fmaf(pj, sdOd[jj * QS + lane + 32 * n], dv[cc][n]);
            dk[cc][n] = fmaf(dsj, sQd[jj * QS + lane + 32 * n], dk[cc][n]);
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
      const int d = dcol + lane + 32 * n;
      if (d >= D) continue;
      p.dk[kvoff + (size_t)c * D + d] = dk[cc][n];
      p.dv[kvoff + (size_t)c * D + d] = dv[cc][n];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on wgmma: warp-specialised K3 and K4 (see the note at the top).
// ---------------------------------------------------------------------------
namespace hw = mfa::hopper;
using namespace hw;   // the layout and helpers of hopper.cuh

// Every (row, col) of rows [r0, r0 + nr) x cols [c0, c0 + nc) is visible
// (no mask to apply): inside R and C, below the diagonal, inside the
// window.
__device__ __forceinline__ bool block_visible(const BwdParams& p, int r0,
                                              int nr, int c0, int nc) {
  if (r0 + nr > p.R || c0 + nc > p.C) return false;
  if (!(p.causal || p.window > 0)) return true;
  const int offset = p.C - p.R;
  if (c0 + nc - 1 > r0 + offset) return false;
  return !(p.window > 0 && c0 < r0 + nr - 1 + offset - (p.window - 1));
}

// Zeroes the 16-byte chunks past D (hopper.cuh zero_chunks) of `n` tiles
// of `rows` rows `stride` bytes apart from `tile`: the columns a copying
// producer never writes (TMA fills them with zeros itself). They stay
// zero for the whole walk; the caller fences them to the async proxy.
__device__ __forceinline__ void zero_pad(const BwdParams& p,
                                         unsigned char* tile, int n,
                                         int stride, int rows, int dp,
                                         int tid) {
  for (int s = 0; s < n; ++s)
    hw::zero_chunks(tile + s * stride, rows, dp, p.D / 8, tid, kWgmmaThreads);
}

// Rows [row0, row0 + ROWS) of head h's [rows x D] bf16 matrix at `base`
// (`limit` rows a head) into a swizzled tile by the copying producer's
// 128 threads at granule G (hopper.cuh copy_rows).
template <int ROWS, int G>
__device__ __forceinline__ void copy_head_rows(const BwdParams& p,
                                               unsigned char* tile,
                                               const void* base, int h,
                                               int row0, int limit, int pt) {
  const int rb = 2 * p.D;
  hw::copy_rows<ROWS, G>(
      tile, static_cast<const unsigned char*>(base) + (size_t)h * limit * rb,
      row0, limit, rb, pt, kWgThreads);
}

// fn(G) at the launch's copy granule: 8 bytes, or 4.
template <typename F>
__device__ __forceinline__ void with_granule(const BwdParams& p, F&& fn) {
  if (p.gran >= 8)
    fn(std::integral_constant<int, 8>{});
  else
    fn(std::integral_constant<int, 4>{});
}

// K3's shared memory: Q and dO resident, then a ring of K and V tiles
// (both warpgroups read every stage), L and the D-term, the mbarriers
// q_full, full[S], empty[S]. The ring takes as many stages as fit, up to
// 4 for TMA and kQCopyStages for the copying producer.
template <int BKV, int DP, int PROD = kTma>
struct QWgmmaSmem {
  static constexpr int kBQ = 128;
  static constexpr int kTile = tile_bytes(BKV, DP);
  static constexpr int kS = ring_stages(
      2 * tile_bytes(kBQ, DP) + 8 * kBQ + 8 + kAlignSlack, 2 * kTile + 16,
      PROD == kTma ? 4 : kQCopyStages, 1);
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + tile_bytes(kBQ, DP);
  static constexpr int kK = kDO + tile_bytes(kBQ, DP);   // [stage]
  static constexpr int kV = kK + kS * kTile;
  static constexpr int kL = kV + kS * kTile;
  static constexpr int kD = kL + 4 * kBQ;
  static constexpr int kBar = kD + 4 * kBQ;   // q_full, full[S], empty[S]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kS) + kAlignSlack;
  // The deferred dQ product holds a stage until the next one's wait.
  static_assert(kS >= 2 && kBytes <= kSmemOptin, "K3 wgmma layout");
};

// PROD: how the producer fills the tiles (hopper.cuh Producer; the tensor
// maps only for kTma).
template <int BKV, int DP, int PROD = kTma>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_bwd_q_wgmma(const BwdParams p, const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mdo,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv) {
  using L = QWgmmaSmem<BKV, DP, PROD>;
  constexpr int BQ = L::kBQ;
  constexpr int S = L::kS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_atom(smem_raw);
  float* sL = reinterpret_cast<float*>(sm + L::kL);
  float* sD = reinterpret_cast<float*>(sm + L::kD);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  // Heaviest first: the last q-blocks have the longest causal walks.
  const int nqb = (p.R + BQ - 1) / BQ;
  const int bhs = gridDim.x / nqb;
  const int i = nqb - 1 - (int)blockIdx.x / bhs;
  const int bh = (int)blockIdx.x % bhs;
  const int bhkv = bh / p.group;
  const int tid = threadIdx.x, wg = hw::warpgroup_index();
  int lo_c, hi_c;
  pair_kv_range(p, i, BKV, lo_c, hi_c);

  if (tid == 0) {
    // TMA's tiles complete on one arrival and their bytes; the copying
    // producer's on one arrival of each producer thread.
    const int fills = PROD == kTma ? 1 : kWgThreads;
    hw::mbar_init(q_full, fills);
    for (int s = 0; s < S; ++s) {
      hw::mbar_init(&full[s], fills);
      hw::mbar_init(&empty[s], 8);   // every consumer warp
    }
    hw::mbar_init_fence();
  }
  if constexpr (PROD != kTma) {
    zero_pad(p, sm + L::kQ, 2, tile_bytes(BQ, DP), BQ, DP, tid);
    zero_pad(p, sm + L::kK, 2 * S, L::kTile, BKV, DP, tid);
    hw::fence_proxy_async();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: Q and dO once, then K and V of each live kv block.
    hw::setmaxnreg_dec<kProducerRegs>();
    if constexpr (PROD != kTma) {
      // All 128 threads, at the granule the rows and bases share; each
      // thread's copies of a tile counted on its full barrier.
      const int pt = tid - 2 * kWgThreads;
      with_granule(p, [&](auto granule) {
        constexpr int G = decltype(granule)::value;
        copy_head_rows<BQ, G>(p, sm + L::kQ, p.q, bh, i * BQ, p.R, pt);
        copy_head_rows<BQ, G>(p, sm + L::kDO, p.d_o, bh, i * BQ, p.R,
                              pt);
        hw::cp_async_arrive(q_full);
        for (int j = lo_c; j <= hi_c; ++j) {
          const int t = j - lo_c, st = t % S;
          hw::mbar_wait(&empty[st], ((t / S) & 1) ^ 1);
          copy_head_rows<BKV, G>(p, sm + L::kK + st * L::kTile, p.k,
                                 bhkv, j * BKV, p.C, pt);
          copy_head_rows<BKV, G>(p, sm + L::kV + st * L::kTile, p.v, bhkv,
                                 j * BKV, p.C, pt);
          hw::cp_async_arrive(&full[st]);
        }
      });
    } else if (tid == 2 * kWgThreads) {
      hw::mbar_expect_tx(q_full, 2 * tile_bytes(BQ, DP));
#pragma unroll
      for (int pn = 0; pn < DP / 64; ++pn) {
        hw::tma_load_3d(sm + L::kQ + pn * BQ * kPanelBytes, &mq, q_full,
                        64 * pn, i * BQ, bh);
        hw::tma_load_3d(sm + L::kDO + pn * BQ * kPanelBytes, &mdo, q_full,
                        64 * pn, i * BQ, bh);
      }
      for (int j = lo_c; j <= hi_c; ++j) {
        const int t = j - lo_c, st = t % S;
        hw::mbar_wait(&empty[st], ((t / S) & 1) ^ 1);
        hw::mbar_expect_tx(&full[st], 2 * tile_bytes(BKV, DP));
        unsigned char* k_tile = sm + L::kK + st * tile_bytes(BKV, DP);
        unsigned char* v_tile = sm + L::kV + st * tile_bytes(BKV, DP);
#pragma unroll
        for (int pn = 0; pn < DP / 64; ++pn) {
          hw::tma_load_3d(k_tile + pn * BKV * kPanelBytes, &mk, &full[st],
                          64 * pn, j * BKV, bhkv);
          hw::tma_load_3d(v_tile + pn * BKV * kPanelBytes, &mv, &full[st],
                          64 * pn, j * BKV, bhkv);
        }
      }
    }
  } else {
    hw::setmaxnreg_inc<kConsumerRegs>();
    const int w = wg, wt = tid % kWgThreads, wi = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int rw0 = i * BQ + 64 * w;   // this warpgroup's first row
    const size_t qoff = (size_t)bh * p.R * p.D;
    if (p.o_f32)
      d_term<float, 64, kWgThreads>(p, bh, rw0, static_cast<const float*>(p.o),
                                    p.d_o, false, sL + 64 * w, sD + 64 * w,
                                    wi, lane);
    else
      d_term<bf16, 64, kWgThreads>(p, bh, rw0, static_cast<const bf16*>(p.o),
                                   p.d_o, false, sL + 64 * w, sD + 64 * w, wi,
                                   lane);
    // Qs = bf16(Q * scale * log2e), this warpgroup's rows, in place.
    hw::mbar_wait(q_full, 0);
#pragma unroll
    for (int pn = 0; pn < DP / 64; ++pn) {
      unsigned char* rows = sm + L::kQ + pn * BQ * kPanelBytes +
                            64 * w * kPanelBytes;
      scale_chunks(rows, rows, 64 * kPanelBytes, p.scale2, wt, kWgThreads);
    }
    hw::fence_proxy_async();
    hw::named_barrier(1 + w, kWgThreads);
    const int r16 = 64 * w + wi * 16 + g;   // tile rows r16 and r16 + 8
    const float l2[2] = {sL[r16], sL[r16 + 8]};
    const float dt[2] = {sD[r16], sD[r16 + 8]};
    int lo_w, hi_w;
    half_kv_range(p, i, w, BKV, lo_w, hi_w);

    float dq[DP / 8][4];
    zero_acc(dq);
    // The stage whose dQ product may still run: released once a later
    // wait has seen it complete, so dQ += dS K overlaps the next step.
    int pending = -1;
    auto release_pending = [&]() {
      if (pending >= 0 && lane == 0) hw::mbar_arrive(&empty[pending]);
      pending = -1;
    };
    for (int j = lo_c; j <= hi_c; ++j) {
      const int t = j - lo_c, st = t % S;
      hw::mbar_wait(&full[st], (t / S) & 1);
      // cp.async writes through the generic proxy: order them before
      // wgmma's reads (the barrier made them visible to this thread).
      if constexpr (PROD != kTma) hw::fence_proxy_async();
      if (j < lo_w || j > hi_w) {
        // Nothing of this tile is visible to this warpgroup's rows.
        hw::wgmma_wait<0>();
        release_pending();
        if (lane == 0) hw::mbar_arrive(&empty[st]);
        continue;
      }
      {
        const int col0 = j * BKV;
        const uint32_t k_base =
            hw::opaque(hw::smem_addr(sm + L::kK + st * tile_bytes(BKV, DP)));
        const uint32_t v_base =
            hw::opaque(hw::smem_addr(sm + L::kV + st * tile_bytes(BKV, DP)));
        const uint32_t q_base =
            hw::opaque(hw::smem_addr(sm + L::kQ) + 64 * w * kPanelBytes);
        const uint32_t do_base =
            hw::opaque(hw::smem_addr(sm + L::kDO) + 64 * w * kPanelBytes);
        float s[BKV / 8][4], dp[BKV / 8][4];
        zero_acc(s);
        zero_acc(dp);
        hw::fence_acc(s);
        hw::fence_acc(dp);
        hw::wgmma_fence();
        // S = Qs K^T and dP = dO V^T: A = the query rows (K-major, the
        // rows of this warpgroup sit 64 rows into each 128-row panel), B =
        // the K / V tile K-major.
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          hw::Wgmma<BKV>::template ss<0, 0>(s, desc_k(q_base, BQ, kk),
                                            desc_k(k_base, BKV, kk), 1);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          hw::Wgmma<BKV>::template ss<0, 0>(dp, desc_k(do_base, BQ, kk),
                                            desc_k(v_base, BKV, kk), 1);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();   // also the previous step's dQ product
        hw::fence_acc(s);
        hw::fence_acc(dp);
        release_pending();
        // dS, in place of S; the masks only where the block is not
        // wholly visible.
        with_flags(!block_visible(p, rw0, 64, col0, BKV), p.cap2 > 0.f,
                   [&](auto masked, auto capped) {
#pragma unroll
          for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int h = e >> 1;
              bool vis = true;
              if constexpr (decltype(masked)::value)
                vis = visible(p, i * BQ + r16 + 8 * h,
                              col0 + n * 8 + t4 * 2 + (e & 1));
              float prob;
              s[n][e] = grad_score_t<decltype(capped)::value>(
                  p, s[n][e], dp[n][e], l2[h], dt[h], vis, prob);
            }
        });
        // dQ += dS K: A = dS from registers (rounded to bf16), B = the same
        // K tile read MN-major.
        hw::fence_acc(dq);
        hw::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BKV / 16; ++kc) {
          uint32_t a[4];
          acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
          hw::Wgmma<DP>::template rs<1>(dq, a, desc_mn(k_base, BKV, kc), 1);
        }
        hw::wgmma_commit();
        pending = st;
      }
    }
    hw::wgmma_wait<0>();
    hw::fence_acc(dq);
    release_pending();

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i * BQ + r16 + 8 * h;
      if (r >= p.R) continue;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = n * 8 + t4 * 2 + e;
          if (d < p.D) p.dq[qoff + (size_t)r * p.D + d] = dq[n][2 * h + e];
        }
    }
  }
}

// K4's shared memory: K and V resident, then a ring of Q and dO tiles,
// a scaled-Q tile a consumer warpgroup, the ring's L and D-term, the
// mbarriers kv_full, full[S], empty[S]. The ring takes an even number of
// stages, as many as fit, up to 4 for TMA (2 a consumer warpgroup: 8
// measured no faster on the H100) and 2 kKvCopyStages for the copying
// producer: stage s feeds warpgroup s % 2, whose stage is freed by its
// deferred products in its next step, so it cycles through two or more.
template <int BQ, int DP, int PROD = kTma>
struct KvWgmmaSmem {
  static constexpr int kBQ = BQ;
  static constexpr int kBKV = 64;
  static constexpr int kTile = tile_bytes(BQ, DP);
  static constexpr int kS = ring_stages(
      2 * tile_bytes(kBKV, DP) + 2 * kTile + 8 + kAlignSlack,
      2 * kTile + 8 * BQ + 16, PROD == kTma ? 4 : 2 * kKvCopyStages, 2);
  static constexpr int kK = 0;
  static constexpr int kV = kK + tile_bytes(kBKV, DP);
  static constexpr int kQ = kV + tile_bytes(kBKV, DP);   // [stage]
  static constexpr int kDO = kQ + kS * kTile;           // [stage]
  static constexpr int kQs = kDO + kS * kTile;          // [warpgroup]
  static constexpr int kL = kQs + 2 * kTile;            // [stage]
  static constexpr int kD = kL + kS * 4 * BQ;           // [stage]
  static constexpr int kBar = kD + kS * 4 * BQ;  // kv_full, full, empty
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kS) + kAlignSlack;
  // Where warpgroup 1's dK and dV pass at the end: TMA's ring (Q and dO)
  // holds them; a copying producer's shallower ring may not, and they
  // start at K's tile, which no product reads any more.
  static constexpr int kRed = PROD == kTma ? kQ : kK;
  static_assert((PROD == kTma ? 2 * kS * kTile : kL - kRed) >=
                    2 * kBKV * DP * 4,
                "room for one warpgroup's dK and dV");
  static_assert(kS >= (PROD == kTma ? 2 : 4) && kBytes <= kSmemOptin,
                "K4 wgmma layout");
};

// K4's copying producer (kCopy) at granule G, thread pt of the producer
// warpgroup (L: the kCopy KvWgmmaSmem or one-CTA KvSplitSmem): K's and V's
// tiles of kv rows col0.. once, then Q's and dO's rows, L and the D-term
// of each step into its stage of the ring, by cp.async straight into the
// slots, one arrival a thread on a tile's full barrier once its copies
// land.
template <int G, typename L>
__device__ __forceinline__ void kv_copies(const BwdParams& p,
                                          unsigned char* sm,
                                          uint64_t* kv_full, uint64_t* full,
                                          uint64_t* empty, int col0,
                                          int bhkv, int lo, int nlive,
                                          int steps, int pt) {
  constexpr int BQ = L::kBQ, BKV = L::kBKV;
  copy_head_rows<BKV, G>(p, sm + L::kK, p.k, bhkv, col0, p.C, pt);
  copy_head_rows<BKV, G>(p, sm + L::kV, p.v, bhkv, col0, p.C, pt);
  hw::cp_async_arrive(kv_full);
  for (int t = 0; t < steps; ++t) {
    const int bh = bhkv * p.group + t / nlive;
    const int row0 = (lo + t % nlive) * BQ;
    const int st = t % L::kS;
    hw::mbar_wait(&empty[st], ((t / L::kS) & 1) ^ 1);
    copy_head_rows<BQ, G>(p, sm + L::kQ + st * L::kTile, p.q, bh, row0,
                          p.R, pt);
    copy_head_rows<BQ, G>(p, sm + L::kDO + st * L::kTile, p.d_o, bh, row0,
                          p.R, pt);
    float* sL = reinterpret_cast<float*>(sm + L::kL) + st * BQ;
    float* sD = reinterpret_cast<float*>(sm + L::kD) + st * BQ;
    for (int r = pt; r < BQ; r += kWgThreads) {
      const bool in = row0 + r < p.R;
      const size_t at = in ? (size_t)bh * p.R + row0 + r : 0;
      hw::cp_async_g<4>(sL + r, p.lse + at, in);
      hw::cp_async_g<4>(sD + r, p.dterm + at, in);
    }
    hw::cp_async_arrive(&full[st]);
  }
}

template <int BQ, int DP, int PROD = kTma>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_bwd_kv_wgmma(const BwdParams p, const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mdo,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv) {
  using L = KvWgmmaSmem<BQ, DP, PROD>;
  constexpr int BKV = L::kBKV;
  constexpr int S = L::kS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_atom(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  // Heaviest first: the first kv blocks have the longest causal walks.
  const int nkvb = (p.C + BKV - 1) / BKV;
  const int bhkvs = gridDim.x / nkvb;
  const int j = (int)blockIdx.x / bhkvs;
  const int bhkv = (int)blockIdx.x % bhkvs;
  const int col0 = j * BKV;
  const int tid = threadIdx.x, wg = hw::warpgroup_index();
  int lo, hi;
  q_range(p, j, BQ, BKV, lo, hi);
  const int nlive = max(hi - lo + 1, 0);
  const int steps = p.group * nlive;

  if (tid == 0) {
    // TMA: K and V on one arrival and their bytes, a stage on TMA's bytes
    // + 32 lanes' L / D-term; the copying producer: every tile on one
    // arrival of each producer thread.
    hw::mbar_init(kv_full, PROD == kTma ? 1 : kWgThreads);
    for (int s = 0; s < S; ++s) {
      hw::mbar_init(&full[s], PROD == kTma ? 33 : kWgThreads);
      hw::mbar_init(&empty[s], 4);   // the four warps of one warpgroup
    }
    hw::mbar_init_fence();
  }
  if constexpr (PROD != kTma) {
    // K, V, then the Q and dO ring: 2 + 2 S tiles; the scaled-Q tiles
    // inherit Q's zeros.
    zero_pad(p, sm + L::kK, 2, tile_bytes(BKV, DP), BKV, DP, tid);
    zero_pad(p, sm + L::kQ, 2 * S, L::kTile, BQ, DP, tid);
    hw::fence_proxy_async();
  }
  __syncthreads();

  if (wg == 2) {
    hw::setmaxnreg_dec<kProducerRegs>();
    if constexpr (PROD != kTma) {
      with_granule(p, [&](auto granule) {
        kv_copies<decltype(granule)::value, L>(p, sm, kv_full, full, empty,
                                               col0, bhkv, lo, nlive, steps,
                                               tid - 2 * kWgThreads);
      });
    } else if (tid < 2 * kWgThreads + 32) {
      // Producer warp: K and V once, then Q and dO of each step by TMA
      // (lane 0) and L and the D-term by cp.async of every lane (a TMA box
      // of them would start 16-byte aligned only when R % 4 == 0).
      const int lane = tid & 31;
      if (lane == 0) {
        hw::mbar_expect_tx(kv_full, 2 * tile_bytes(BKV, DP));
#pragma unroll
        for (int pn = 0; pn < DP / 64; ++pn) {
          hw::tma_load_3d(sm + L::kK + pn * BKV * kPanelBytes, &mk, kv_full,
                          64 * pn, col0, bhkv);
          hw::tma_load_3d(sm + L::kV + pn * BKV * kPanelBytes, &mv, kv_full,
                          64 * pn, col0, bhkv);
        }
      }
      for (int t = 0; t < steps; ++t) {
        const int bh = bhkv * p.group + t / nlive;
        const int row0 = (lo + t % nlive) * BQ;
        const int st = t % S;
        hw::mbar_wait(&empty[st], ((t / S) & 1) ^ 1);
        if (lane == 0) {
          hw::mbar_expect_tx(&full[st], 2 * L::kTile);
          unsigned char* q_tile = sm + L::kQ + st * L::kTile;
          unsigned char* do_tile = sm + L::kDO + st * L::kTile;
#pragma unroll
          for (int pn = 0; pn < DP / 64; ++pn) {
            hw::tma_load_3d(q_tile + pn * BQ * kPanelBytes, &mq, &full[st],
                            64 * pn, row0, bh);
            hw::tma_load_3d(do_tile + pn * BQ * kPanelBytes, &mdo, &full[st],
                            64 * pn, row0, bh);
          }
        }
        float* sL = reinterpret_cast<float*>(sm + L::kL) + st * BQ;
        float* sD = reinterpret_cast<float*>(sm + L::kD) + st * BQ;
#pragma unroll
        for (int k = 0; k < BQ / 32; ++k) {
          const int r = row0 + lane + 32 * k;
          const size_t at = r < p.R ? (size_t)bh * p.R + r : 0;
          hw::cp_async_g<4>(sL + lane + 32 * k, p.lse + at, r < p.R);
          hw::cp_async_g<4>(sD + lane + 32 * k, p.dterm + at, r < p.R);
        }
        hw::cp_async_arrive(&full[st]);
      }
    }
  } else {
    hw::setmaxnreg_inc<kConsumerRegs>();
    const int w = wg, wt = tid % kWgThreads, wi = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r16 = wi * 16 + g;   // this thread's kv rows r16 and r16 + 8
    unsigned char* qs_tile = sm + L::kQs + w * L::kTile;
    hw::mbar_wait(kv_full, 0);
    // cp.async writes through the generic proxy: order K's and V's before
    // wgmma's reads (the barrier made them visible to this thread). A
    // stage's Q and dO are ordered by the fence after the scaling below.
    if constexpr (PROD != kTma) hw::fence_proxy_async();

    float dk[DP / 8][4], dv[DP / 8][4];
    zero_acc(dk);
    zero_acc(dv);
    // The stage whose dV / dK products may still run (see K3).
    int pending = -1;
    for (int t = w; t < steps; t += 2) {
      const int row0 = (lo + t % nlive) * BQ;
      const int st = t % S;
      unsigned char* q_tile = sm + L::kQ + st * L::kTile;
      const uint32_t q_base = hw::opaque(hw::smem_addr(q_tile));
      const uint32_t do_base =
          hw::opaque(hw::smem_addr(sm + L::kDO + st * L::kTile));
      const uint32_t qs_base = hw::opaque(hw::smem_addr(qs_tile));
      const uint32_t k_base = hw::opaque(hw::smem_addr(sm + L::kK));
      const uint32_t v_base = hw::opaque(hw::smem_addr(sm + L::kV));
      const float* sL = reinterpret_cast<const float*>(sm + L::kL) + st * BQ;
      const float* sD = reinterpret_cast<const float*>(sm + L::kD) + st * BQ;
      hw::mbar_wait(&full[st], (t / S) & 1);
      // Qs = bf16(Q * scale * log2e) into this warpgroup's buffer, once
      // its previous products have read the last one.
      hw::named_barrier(1 + w, kWgThreads);
      scale_chunks(q_tile, qs_tile, L::kTile, p.scale2, wt, kWgThreads);
      hw::fence_proxy_async();
      hw::named_barrier(1 + w, kWgThreads);

      // S^T = K Qs^T and dP^T = V dO^T: A = the K / V tile, B = the Qs /
      // dO tile, both K-major.
      float s[BQ / 8][4], dp[BQ / 8][4];
      zero_acc(s);
      zero_acc(dp);
      hw::fence_acc(s);
      hw::fence_acc(dp);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hw::Wgmma<BQ>::template ss<0, 0>(
            s, desc_k(k_base, BKV, kk), desc_k(qs_base, BQ, kk), 1);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hw::Wgmma<BQ>::template ss<0, 0>(dp, desc_k(v_base, BKV, kk),
                                         desc_k(do_base, BQ, kk), 1);
      hw::wgmma_commit();
      hw::wgmma_wait<0>();   // also the previous step's dV / dK products
      hw::fence_acc(s);
      hw::fence_acc(dp);
      if (pending >= 0 && lane == 0) hw::mbar_arrive(&empty[pending]);
      // P^T in s, dS^T in dp; L (natural log, times log2e here, rounded
      // before it meets S as everywhere else) and the D-term are per
      // column; the masks only where the block is not wholly visible.
      with_flags(!block_visible(p, row0, BQ, col0, BKV), p.cap2 > 0.f,
                 [&](auto masked, auto capped) {
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rl = n * 8 + t4 * 2 + (e & 1);
            bool vis = true;
            if constexpr (decltype(masked)::value)
              vis = visible(p, row0 + rl, col0 + r16 + 8 * (e >> 1));
            float prob;
            dp[n][e] = grad_score_t<decltype(capped)::value>(
                p, s[n][e], dp[n][e], __fmul_rn(sL[rl], kLog2e), sD[rl], vis,
                prob);
            s[n][e] = prob;
          }
      });
      // dV += P^T dO and dK += dS^T Q: A from registers (rounded to bf16),
      // B = the dO / raw Q tile read MN-major.
      hw::fence_acc(dv);
      hw::fence_acc(dk);
      hw::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        uint32_t a[4];
        acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
        hw::Wgmma<DP>::template rs<1>(dv, a, desc_mn(do_base, BQ, kc), 1);
      }
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        uint32_t a[4];
        acc_to_a(a, dp[2 * kc], dp[2 * kc + 1]);
        hw::Wgmma<DP>::template rs<1>(dk, a, desc_mn(q_base, BQ, kc), 1);
      }
      hw::wgmma_commit();
      pending = st;
    }
    hw::wgmma_wait<0>();
    hw::fence_acc(dv);
    hw::fence_acc(dk);
    if (pending >= 0 && lane == 0) hw::mbar_arrive(&empty[pending]);

    // dK, dV = warpgroup 0's + warpgroup 1's (through shared memory no
    // product reads any more: L::kRed), in that order.
    float* red = reinterpret_cast<float*>(sm + L::kRed);
    constexpr int NV = DP / 2;   // values a thread holds of dK (and dV)
    hw::named_barrier(3, 2 * kWgThreads);
    if (w == 1) {
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          red[(n * 4 + e) * kWgThreads + wt] = dk[n][e];
          red[(NV + n * 4 + e) * kWgThreads + wt] = dv[n][e];
        }
    }
    hw::named_barrier(3, 2 * kWgThreads);
    if (w == 0) {
      const size_t kvoff = (size_t)bhkv * p.C * p.D;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = col0 + r16 + 8 * (e >> 1);
          const int d = n * 8 + t4 * 2 + (e & 1);
          const float vk = dk[n][e] + red[(n * 4 + e) * kWgThreads + wt];
          const float vv = dv[n][e] + red[(NV + n * 4 + e) * kWgThreads + wt];
          if (c < p.C && d < p.D) {
            p.dk[kvoff + (size_t)c * p.D + d] = vk;
            p.dv[kvoff + (size_t)c * p.D + d] = vv;
          }
        }
    }
  }
}

// K4 on wide panels (rows "wgmma_dblk" of block_d 192 or 256; see the note
// at the top): CTA p of a cluster of P (CL: P = 2; else one CTA) on
// head-dim panel p, whose consumer warpgroups split the outputs instead of
// the steps: warpgroup 1 forms S^T's partial and owns dV, warpgroup 0
// dP^T's and owns dK. In a cluster each sums its partial with its twin in
// the other CTA (ClusterSum); warpgroup 1 hands the summed S^T to
// warpgroup 0 through shared memory.
// Each step's dV / dK product is deferred into the next step, where it
// runs under that step's partial product and exchange.
template <int BQ, int DP, bool CL, int PROD = kTma>
struct KvSplitSmem {
  static constexpr int kBQ = BQ;
  static constexpr int kBKV = 64;
  static constexpr int kPart = 64 * BQ * 4;   // one fp32 partial
  static constexpr int kTile = tile_bytes(BQ, DP);
  static constexpr int kK = 0;
  static constexpr int kV = kK + tile_bytes(kBKV, DP);
  static constexpr int kQs = kV + tile_bytes(kBKV, DP);   // warpgroup 1's
  static constexpr int kX = kQs + kTile;                  // [warpgroup] (CL)
  static constexpr int kSt = kX + (CL ? 2 * kPart : 0);   // S^T [2]
  static constexpr int kFixed = kSt + 2 * kPart;
  // kv_full, full[S], empty[S], (CL) x_full[2], x_empty[2], s_full[2],
  // s_empty[2]
  static constexpr int kBars = 1 + 4 + (CL ? 4 : 0);
  // Q, dO, L and the D-term a step, both warpgroups reading every stage:
  // as many stages as fit, up to 4 for TMA and kKvCopyStages for the
  // copying producer (a step's stage is freed by its deferred product, in
  // the next step).
  static constexpr int kS =
      ring_stages(kFixed + 8 * kBars + kAlignSlack, 2 * kTile + 8 * BQ + 16,
                  PROD == kTma ? 4 : kKvCopyStages, 1);
  static constexpr int kQ = kFixed;                  // [stage]
  static constexpr int kDO = kQ + kS * kTile;        // [stage]
  static constexpr int kL = kDO + kS * kTile;        // [stage]
  static constexpr int kD = kL + kS * 4 * BQ;        // [stage]
  static constexpr int kBar = kD + kS * 4 * BQ;
  static constexpr int kBytes = kBar + 8 * (2 * kS + kBars) + kAlignSlack;
  static_assert(kS >= (PROD == kTma ? 1 : 2) && kBytes <= kSmemOptin,
                "K4 split layout");
};

template <int BQ, int DP, bool CL, int PROD = kTma>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_bwd_kv_split(const BwdParams p, const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mdo,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv) {
  static_assert(PROD == kTma || !CL, "the copying producer on one CTA only");
  using L = KvSplitSmem<BQ, DP, CL, PROD>;
  constexpr int BKV = L::kBKV;
  constexpr int S = L::kS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_atom(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;
  uint64_t* x_full = empty + S;    // [warpgroup] (CL)
  uint64_t* x_empty = x_full + 2;  // [warpgroup] (CL)
  uint64_t* s_full = empty + S + (CL ? 4 : 0);   // [buffer]: warpgroup 1
                                                 // wrote S^T
  uint64_t* s_empty = s_full + 2;  // [buffer]: warpgroup 0 read it

  int rank = 0, size = 1;
  if constexpr (CL) {
    rank = hw::cluster_rank();   // = blockIdx.x % size: the panel
    // The CTAs of the cluster, as a value the compiler knows to be the
    // same across the warp.
    size = __shfl_sync(kFull, hw::cluster_size(), 0);
  }
  // Heaviest first: the first kv blocks have the longest causal walks.
  const int nkvb = (p.C + BKV - 1) / BKV;
  const int tile = (int)blockIdx.x / size;
  const int bhkvs = gridDim.x / size / nkvb;
  const int j = tile / bhkvs;
  const int bhkv = tile % bhkvs;
  const int col0 = j * BKV;
  const int dcol = rank * DP;    // this CTA's head-dim panel starts here
  const int tid = threadIdx.x, wg = hw::warpgroup_index();
  int lo, hi;
  q_range(p, j, BQ, BKV, lo, hi);
  const int nlive = max(hi - lo + 1, 0);
  const int steps = p.group * nlive;

  if (tid == 0) {
    // As in flash_bwd_kv_wgmma: TMA's K and V on one arrival, a stage on
    // TMA's bytes + 32 lanes' L / D-term; the copying producer's tiles on
    // one arrival of each producer thread.
    hw::mbar_init(kv_full, PROD == kTma ? 1 : kWgThreads);
    for (int s = 0; s < S; ++s) {
      hw::mbar_init(&full[s], PROD == kTma ? 33 : kWgThreads);
      hw::mbar_init(&empty[s], 8);   // every consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      if constexpr (CL) {
        hw::mbar_init(&x_full[b], 1);                 // the local arming
        hw::mbar_init(&x_empty[b], 4 * (size - 1));   // the other's warps
      }
      hw::mbar_init(&s_full[b], 4);
      hw::mbar_init(&s_empty[b], 4);
    }
    hw::mbar_init_fence();
  }
  if constexpr (PROD != kTma) {
    // K, V, then the Q and dO ring; the scaled-Q tile inherits Q's zeros.
    zero_pad(p, sm + L::kK, 2, tile_bytes(BKV, DP), BKV, DP, tid);
    zero_pad(p, sm + L::kQ, 2 * S, L::kTile, BQ, DP, tid);
    hw::fence_proxy_async();
  }
  if constexpr (CL)
    hw::cluster_sync();
  else
    __syncthreads();

  if (wg == 2) {
    hw::setmaxnreg_dec<kProducerRegs>();
    if constexpr (PROD != kTma) {
      with_granule(p, [&](auto granule) {
        kv_copies<decltype(granule)::value, L>(p, sm, kv_full, full, empty,
                                               col0, bhkv, lo, nlive, steps,
                                               tid - 2 * kWgThreads);
      });
    } else if (tid < 2 * kWgThreads + 32) {
      // Producer warp: K and V once, then Q and dO of each step by TMA
      // (lane 0) and L and the D-term by cp.async of every lane, as in
      // flash_bwd_kv_wgmma.
      const int lane = tid & 31;
      if (lane == 0) {
        hw::mbar_expect_tx(kv_full, 2 * tile_bytes(BKV, DP));
#pragma unroll
        for (int pn = 0; pn < DP / 64; ++pn) {
          hw::tma_load_3d(sm + L::kK + pn * BKV * kPanelBytes, &mk, kv_full,
                          dcol + 64 * pn, col0, bhkv);
          hw::tma_load_3d(sm + L::kV + pn * BKV * kPanelBytes, &mv, kv_full,
                          dcol + 64 * pn, col0, bhkv);
        }
      }
      for (int t = 0; t < steps; ++t) {
        const int bh = bhkv * p.group + t / nlive;
        const int row0 = (lo + t % nlive) * BQ;
        const int st = t % S;
        hw::mbar_wait(&empty[st], ((t / S) & 1) ^ 1);
        if (lane == 0) {
          hw::mbar_expect_tx(&full[st], 2 * L::kTile);
          unsigned char* q_tile = sm + L::kQ + st * L::kTile;
          unsigned char* do_tile = sm + L::kDO + st * L::kTile;
#pragma unroll
          for (int pn = 0; pn < DP / 64; ++pn) {
            hw::tma_load_3d(q_tile + pn * BQ * kPanelBytes, &mq, &full[st],
                            dcol + 64 * pn, row0, bh);
            hw::tma_load_3d(do_tile + pn * BQ * kPanelBytes, &mdo, &full[st],
                            dcol + 64 * pn, row0, bh);
          }
        }
        float* sL = reinterpret_cast<float*>(sm + L::kL) + st * BQ;
        float* sD = reinterpret_cast<float*>(sm + L::kD) + st * BQ;
#pragma unroll
        for (int k = 0; k < BQ / 32; ++k) {
          const int r = row0 + lane + 32 * k;
          const size_t at = r < p.R ? (size_t)bh * p.R + r : 0;
          hw::cp_async_g<4>(sL + lane + 32 * k, p.lse + at, r < p.R);
          hw::cp_async_g<4>(sD + lane + 32 * k, p.dterm + at, r < p.R);
        }
        hw::cp_async_arrive(&full[st]);
      }
    }
  } else {
    hw::setmaxnreg_inc<kConsumerRegs>();
    const int w = wg, wt = tid % kWgThreads, wi = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r16 = wi * 16 + g;   // this thread's kv rows r16 and r16 + 8
    // The exchange of this warpgroup's partial with its twin (CL).
    hw::ClusterSum<BQ / 8> xs{hw::smem_addr(sm + L::kX + w * L::kPart),
                              &x_full[w], &x_empty[w], rank, size, wt, lane};
    unsigned char* qs_tile = sm + L::kQs;
    auto q_base = [&](int st) {
      return hw::opaque(hw::smem_addr(sm + L::kQ + st * L::kTile));
    };
    auto do_base = [&](int st) {
      return hw::opaque(hw::smem_addr(sm + L::kDO + st * L::kTile));
    };
    hw::mbar_wait(kv_full, 0);
    // cp.async writes through the generic proxy: order them before
    // wgmma's reads (the barrier made them visible to this thread).
    if constexpr (PROD != kTma) hw::fence_proxy_async();

    // This warpgroup's output panel: dV (warpgroup 1) or dK (0).
    float acc[DP / 8][4];
    zero_acc(acc);
    // P^T or dS^T of the step whose dV / dK product is deferred into the
    // next step (as K1 defers its PV): it runs under that step's partial
    // product and exchange.
    uint32_t pa[BQ / 16][4] = {};
    const uint32_t a_base =
        hw::opaque(hw::smem_addr(sm + (w == 1 ? L::kK : L::kV)));
    for (int t = 0; t < steps; ++t) {
      const int row0 = (lo + t % nlive) * BQ;
      const int st = t % S, b = t & 1;
      // The stage of the deferred product: step t - 1's, or before the
      // first step (P^T = dS^T = 0) this step's.
      const int ps = t > 0 ? (t - 1) % S : st;
      const float* sL = reinterpret_cast<const float*>(sm + L::kL) + st * BQ;
      const float* sD = reinterpret_cast<const float*>(sm + L::kD) + st * BQ;
      hw::mbar_wait(&full[st], (t / S) & 1);
      if constexpr (PROD != kTma) hw::fence_proxy_async();
      if (w == 1) {
        // Qs = bf16(Q * scale * log2e); every product of the last step
        // has completed.
        scale_chunks(sm + L::kQ + st * L::kTile, qs_tile, L::kTile,
                     p.scale2, wt, kWgThreads);
        hw::fence_proxy_async();
        hw::named_barrier(2, kWgThreads);
      }
      // This step's partial: warpgroup 1 S^T = K Qs^T, warpgroup 0 dP^T =
      // V dO^T (A = the K / V tile, B = the Qs / dO tile, both K-major),
      // over this CTA's panel; then the deferred dV += P^T dO (warpgroup
      // 1) or dK += dS^T Q (warpgroup 0), A from registers, B = the dO /
      // raw Q tile read MN-major: two commit groups.
      const uint32_t b_base =
          w == 1 ? hw::opaque(hw::smem_addr(qs_tile)) : do_base(st);
      const uint32_t o_base = w == 1 ? do_base(ps) : q_base(ps);
      float x[BQ / 8][4];
      hw::fence_acc(x);
      hw::fence_acc(acc);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hw::Wgmma<BQ>::template ss<0, 0>(x, desc_k(a_base, BKV, kk),
                                         desc_k(b_base, BQ, kk), kk > 0);
      hw::wgmma_commit();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        hw::Wgmma<DP>::template rs<1>(acc, pa[kc], desc_mn(o_base, BQ, kc),
                                      1);
      hw::wgmma_commit();
      hw::wgmma_wait<1>();   // the partial; the deferred product may run
      hw::fence_acc(x);
      // The cluster's sum, in rank order (a CTA alone holds it already).
      // The cluster instance tests its size at run time: with the test
      // folded away, ptxas scheduled the 192-wide instance 4-5% slower
      // (utils/bwd_tuning.py sweep --only dblk, D 256 and 384).
      if (CL && size > 1) {
        xs.begin();
        xs.send(x, 0);
        xs.wait();
        xs.sum(x, 0);
        xs.end();
      }
      // S^T from warpgroup 1 to warpgroup 0 (a thread's chunks to the same
      // thread of the other warpgroup: the fragments coincide); each
      // reads it back from the buffer.
      float4* s_buf =
          reinterpret_cast<float4*>(sm + L::kSt + b * L::kPart) + wt;
      if (w == 1) {
        if (t >= 2) hw::mbar_wait(&s_empty[b], ((t >> 1) - 1) & 1);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n)
          s_buf[n * kWgThreads] = make_float4(x[n][0], x[n][1], x[n][2],
                                              x[n][3]);
        __syncwarp();
        if (lane == 0) hw::mbar_arrive(&s_full[b]);
      } else {
        hw::mbar_wait(&s_full[b], (t >> 1) & 1);
      }
      // Warpgroup 1: P^T; warpgroup 0: dS^T (from S^T and its dP^T); L
      // (natural log, times log2e here, rounded before it meets S as
      // everywhere else) and the D-term are per column; the masks only
      // where the block is not wholly visible.
      with_flags(!block_visible(p, row0, BQ, col0, BKV), p.cap2 > 0.f,
                 [&](auto masked, auto capped) {
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float4 s4 = s_buf[n * kWgThreads];
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rl = n * 8 + t4 * 2 + (e & 1);
            bool vis = true;
            if constexpr (decltype(masked)::value)
              vis = visible(p, row0 + rl, col0 + r16 + 8 * (e >> 1));
            float prob;
            const float ds = grad_score_t<decltype(capped)::value>(
                p, sv[e], x[n][e], __fmul_rn(sL[rl], kLog2e), sD[rl], vis,
                prob);
            x[n][e] = w == 1 ? prob : ds;
          }
        }
      });
      if (w == 0) {
        __syncwarp();
        if (lane == 0) hw::mbar_arrive(&s_empty[b]);
      }
      hw::wgmma_wait<0>();   // the deferred product
      hw::fence_acc(acc);
      hw::fence_frag(pa);
      if (t > 0 && lane == 0) hw::mbar_arrive(&empty[ps]);
      // This step's P^T or dS^T (rounded to bf16) for its deferred product.
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        acc_to_a(pa[kc], x[2 * kc], x[2 * kc + 1]);
    }
    if (steps > 0) {
      // The last step's product.
      const int last = (steps - 1) % S;
      hw::fence_acc(acc);
      hw::wgmma_fence();
      const uint32_t o_base = w == 1 ? do_base(last) : q_base(last);
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        hw::Wgmma<DP>::template rs<1>(acc, pa[kc], desc_mn(o_base, BQ, kc),
                                      1);
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_acc(acc);
      hw::fence_frag(pa);
      if (lane == 0) hw::mbar_arrive(&empty[last]);
    }

    float* out = w == 1 ? p.dv : p.dk;
    const size_t kvoff = (size_t)bhkv * p.C * p.D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col0 + r16 + 8 * (e >> 1);
        const int d = dcol + n * 8 + t4 * 2 + (e & 1);
        if (c < p.C && d < p.D) out[kvoff + (size_t)c * p.D + d] = acc[n][e];
      }
  }
  // No CTA leaves while the other may still write its slots or arrive on
  // its barriers.
  if constexpr (CL) {
    __syncwarp();
    hw::cluster_sync();
  }
}

// K3 on wide panels (rows "wgmma_dblk" of block_d 192 or 256; see the note
// at the top): CTA p of a cluster of P (CL: P = 2; else one CTA) owns
// head-dim panel p of a 128-row q-block, 64 rows a consumer warpgroup as
// in flash_bwd_q_wgmma. Each warpgroup forms its rows' partial S and dP
// over the panel, sums both with its twin in the other CTA (ClusterSum,
// rank order), forms dS and accumulates its panel of dQ. Each step's dQ
// product is deferred into the next step, as K1 defers its PV, and runs
// under that step's partial products' exchange and dS.
template <int BKV, int DP, bool CL, int PROD = kTma>
struct QSplitSmem {
  static constexpr int kBQ = 128;
  // A thread's chunks of one exchange: S's and dP's n-tiles.
  static constexpr int kNch = 2 * BKV / 8;
  static constexpr int kSlot = kNch * kWgThreads * 16;   // one warpgroup's
  static constexpr int kTile = tile_bytes(BKV, DP);
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + tile_bytes(kBQ, DP);
  static constexpr int kX = kDO + tile_bytes(kBQ, DP);   // [warpgroup] (CL)
  static constexpr int kL = kX + (CL ? 2 * kSlot : 0);
  static constexpr int kD = kL + 4 * kBQ;
  static constexpr int kK = kD + 4 * kBQ;                // [K stage]
  // The K and V tiles that fit beside the rest, each with a full and an
  // empty mbarrier, in two rings: TMA's K ring (read by a step's S and, a
  // step later, by its deferred dQ product) gets up to 4 stages keeping
  // one for V, its V ring (read by dP only) the rest, up to 4; the
  // copying producer's rings half the tiles each, up to kQCopyStages.
  static constexpr int kTiles =
      (kSmemOptin - kK - 8 * (1 + (CL ? 4 : 0)) - kAlignSlack) / (kTile + 16);
  static constexpr int kCopyS =
      kTiles / 2 < kQCopyStages ? kTiles / 2 : kQCopyStages;
  static constexpr int kSV =
      PROD != kTma ? kCopyS
                   : kTiles - 4 > 1 ? (kTiles - 4 < 4 ? kTiles - 4 : 4) : 1;
  static constexpr int kSK =
      PROD != kTma ? kCopyS : kTiles - kSV < 4 ? kTiles - kSV : 4;
  static constexpr int kV = kK + kSK * kTile;            // [V stage]
  // q_full, full_k[SK], empty_k[SK], full_v[SV], empty_v[SV], (CL)
  // x_full[2], x_empty[2]
  static constexpr int kBar = kV + kSV * kTile;
  static constexpr int kBytes =
      kBar + 8 * (1 + 2 * kSK + 2 * kSV + (CL ? 4 : 0)) + kAlignSlack;
  static_assert(kSK >= 2 && kBytes <= kSmemOptin, "K3 split layout");
};

template <int BKV, int DP, bool CL, int PROD = kTma>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_bwd_q_split(const BwdParams p, const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mdo,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv) {
  static_assert(PROD == kTma || !CL, "the copying producer on one CTA only");
  using L = QSplitSmem<BKV, DP, CL, PROD>;
  constexpr int BQ = L::kBQ;
  constexpr int SK = L::kSK, SV = L::kSV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_atom(smem_raw);
  float* sL = reinterpret_cast<float*>(sm + L::kL);
  float* sD = reinterpret_cast<float*>(sm + L::kD);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full_k = q_full + 1;
  uint64_t* empty_k = full_k + SK;
  uint64_t* full_v = empty_k + SK;
  uint64_t* empty_v = full_v + SV;
  uint64_t* x_full = empty_v + SV;  // [warpgroup] (CL)
  uint64_t* x_empty = x_full + 2;   // [warpgroup] (CL)

  int rank = 0, size = 1;
  if constexpr (CL) {
    rank = hw::cluster_rank();   // = blockIdx.x % size: the panel
    size = hw::cluster_size();
  }
  // Heaviest first: the last q-blocks have the longest causal walks.
  const int nqb = (p.R + BQ - 1) / BQ;
  const int tile = (int)blockIdx.x / size;
  const int bhs = (int)gridDim.x / size / nqb;
  const int i = nqb - 1 - tile / bhs;
  const int bh = tile % bhs;
  const int bhkv = bh / p.group;
  const int dcol = rank * DP;    // this CTA's head-dim panel starts here
  const int tid = threadIdx.x, wg = hw::warpgroup_index();
  // Both warpgroups walk every block of the CTA's walk, with no branch
  // around a product: a block none of a warpgroup's rows sees (at a causal
  // diagonal or a window's edge) goes through the mask and gives dS = 0.
  // The twin warpgroups of a cluster walk the same blocks.
  int lo_c, hi_c;
  pair_kv_range(p, i, BKV, lo_c, hi_c);
  const int nblk = max(hi_c - lo_c + 1, 0);

  if (tid == 0) {
    // TMA's tiles complete on one arrival and their bytes; the copying
    // producer's on one arrival of each producer thread.
    const int fills = PROD == kTma ? 1 : kWgThreads;
    hw::mbar_init(q_full, fills);
    for (int s = 0; s < SK; ++s) {
      hw::mbar_init(&full_k[s], fills);
      hw::mbar_init(&empty_k[s], 8);   // every consumer warp
    }
    for (int s = 0; s < SV; ++s) {
      hw::mbar_init(&full_v[s], fills);
      hw::mbar_init(&empty_v[s], 8);
    }
    if constexpr (CL) {
      for (int w = 0; w < 2; ++w) {
        hw::mbar_init(&x_full[w], 1);                 // the local arming
        hw::mbar_init(&x_empty[w], 4 * (size - 1));   // the other's warps
      }
    }
    hw::mbar_init_fence();
  }
  if constexpr (PROD != kTma) {
    // Q and dO, then the K and V rings (adjacent).
    zero_pad(p, sm + L::kQ, 2, tile_bytes(BQ, DP), BQ, DP, tid);
    zero_pad(p, sm + L::kK, SK + SV, L::kTile, BKV, DP, tid);
    hw::fence_proxy_async();
  }
  if constexpr (CL)
    hw::cluster_sync();
  else
    __syncthreads();

  if (wg == 2) {
    // Producer: this panel of Q and dO once, then of K and V of each
    // block of the walk.
    hw::setmaxnreg_dec<kProducerRegs>();
    if constexpr (PROD != kTma) {
      // The copying producer (one CTA, the whole head dim), all 128
      // threads, one arrival a thread a tile.
      const int pt = tid - 2 * kWgThreads;
      with_granule(p, [&](auto granule) {
        constexpr int G = decltype(granule)::value;
        copy_head_rows<BQ, G>(p, sm + L::kQ, p.q, bh, i * BQ, p.R, pt);
        copy_head_rows<BQ, G>(p, sm + L::kDO, p.d_o, bh, i * BQ, p.R,
                              pt);
        hw::cp_async_arrive(q_full);
        for (int t = 0; t < nblk; ++t) {
          const int j = lo_c + t, sk = t % SK, sv = t % SV;
          hw::mbar_wait(&empty_k[sk], ((t / SK) & 1) ^ 1);
          copy_head_rows<BKV, G>(p, sm + L::kK + sk * L::kTile, p.k,
                                 bhkv, j * BKV, p.C, pt);
          hw::cp_async_arrive(&full_k[sk]);
          hw::mbar_wait(&empty_v[sv], ((t / SV) & 1) ^ 1);
          copy_head_rows<BKV, G>(p, sm + L::kV + sv * L::kTile, p.v, bhkv,
                                 j * BKV, p.C, pt);
          hw::cp_async_arrive(&full_v[sv]);
        }
      });
    } else if (tid == 2 * kWgThreads) {
      hw::mbar_expect_tx(q_full, 2 * tile_bytes(BQ, DP));
#pragma unroll
      for (int pn = 0; pn < DP / 64; ++pn) {
        hw::tma_load_3d(sm + L::kQ + pn * BQ * kPanelBytes, &mq, q_full,
                        dcol + 64 * pn, i * BQ, bh);
        hw::tma_load_3d(sm + L::kDO + pn * BQ * kPanelBytes, &mdo, q_full,
                        dcol + 64 * pn, i * BQ, bh);
      }
      for (int t = 0; t < nblk; ++t) {
        const int j = lo_c + t, sk = t % SK, sv = t % SV;
        hw::mbar_wait(&empty_k[sk], ((t / SK) & 1) ^ 1);
        hw::mbar_expect_tx(&full_k[sk], L::kTile);
        unsigned char* k_tile = sm + L::kK + sk * L::kTile;
#pragma unroll
        for (int pn = 0; pn < DP / 64; ++pn)
          hw::tma_load_3d(k_tile + pn * BKV * kPanelBytes, &mk, &full_k[sk],
                          dcol + 64 * pn, j * BKV, bhkv);
        hw::mbar_wait(&empty_v[sv], ((t / SV) & 1) ^ 1);
        hw::mbar_expect_tx(&full_v[sv], L::kTile);
        unsigned char* v_tile = sm + L::kV + sv * L::kTile;
#pragma unroll
        for (int pn = 0; pn < DP / 64; ++pn)
          hw::tma_load_3d(v_tile + pn * BKV * kPanelBytes, &mv, &full_v[sv],
                          dcol + 64 * pn, j * BKV, bhkv);
      }
    }
  } else {
    hw::setmaxnreg_inc<kConsumerRegs>();
    const int w = wg, wt = tid % kWgThreads, wi = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int rw0 = i * BQ + 64 * w;   // this warpgroup's first row
    // The D-term over the whole head dim (the same bits in every CTA of a
    // cluster; rank 0 stores it for K4) and L * log2e of this warpgroup's
    // rows, while the producer's loads land.
    if (p.o_f32)
      d_term<float, 64, kWgThreads>(p, bh, rw0, static_cast<const float*>(p.o),
                                    p.d_o, false, sL + 64 * w, sD + 64 * w,
                                    wi, lane, rank == 0);
    else
      d_term<bf16, 64, kWgThreads>(p, bh, rw0, static_cast<const bf16*>(p.o),
                                   p.d_o, false, sL + 64 * w, sD + 64 * w, wi,
                                   lane, rank == 0);
    // Qs = bf16(Q * scale * log2e), this warpgroup's rows, in place.
    hw::mbar_wait(q_full, 0);
#pragma unroll
    for (int pn = 0; pn < DP / 64; ++pn) {
      unsigned char* rows = sm + L::kQ + pn * BQ * kPanelBytes +
                            64 * w * kPanelBytes;
      scale_chunks(rows, rows, 64 * kPanelBytes, p.scale2, wt, kWgThreads);
    }
    hw::fence_proxy_async();
    hw::named_barrier(1 + w, kWgThreads);
    const int r16 = 64 * w + wi * 16 + g;   // tile rows r16 and r16 + 8
    const float l2[2] = {sL[r16], sL[r16 + 8]};
    const float dt[2] = {sD[r16], sD[r16 + 8]};
    auto k_base = [&](int sk) {
      return hw::opaque(hw::smem_addr(sm + L::kK + sk * L::kTile));
    };
    // The exchange of S's and dP's partials with this warpgroup's twin in
    // the other CTA: chunks [0, BKV / 8) S's n-tiles, then dP's.
    using Sum = hw::ClusterSum<L::kNch>;
    Sum xs{hw::smem_addr(sm + L::kX + w * L::kSlot), &x_full[w],
           &x_empty[w], rank, size, wt, lane};

    float dq[DP / 8][4];
    zero_acc(dq);
    // dS of the step whose dQ product is deferred into the next step.
    uint32_t pa[BKV / 16][4] = {};
    for (int t = 0; t < nblk; ++t) {
      const int sk = t % SK, sv = t % SV;
      // The K tile the deferred product reads: step t - 1's, or before the
      // first step (dS = 0) this step's.
      const int pk = t > 0 ? (t - 1) % SK : sk;
      const int col0 = (lo_c + t) * BKV;
      hw::mbar_wait(&full_k[sk], (t / SK) & 1);
      hw::mbar_wait(&full_v[sv], (t / SV) & 1);
      // cp.async writes through the generic proxy: order them before
      // wgmma's reads (the barriers made them visible to this thread).
      if constexpr (PROD != kTma) hw::fence_proxy_async();
      const uint32_t k_cur = k_base(sk);
      const uint32_t v_cur =
          hw::opaque(hw::smem_addr(sm + L::kV + sv * L::kTile));
      const uint32_t q_base =
          hw::opaque(hw::smem_addr(sm + L::kQ) + 64 * w * kPanelBytes);
      const uint32_t do_base =
          hw::opaque(hw::smem_addr(sm + L::kDO) + 64 * w * kPanelBytes);
      // This step's partials S = Qs K^T and dP = dO V^T over the panel (A
      // = this warpgroup's rows, 64 rows into each 128-row panel; B = the
      // K / V tile; both K-major; the first k-step overwrites), then the
      // deferred dQ += dS K (A = dS from registers, B = that step's K tile
      // read MN-major): two commit groups, issued together.
      float s[BKV / 8][4], dp[BKV / 8][4];
      hw::fence_acc(s);
      hw::fence_acc(dp);
      hw::fence_acc(dq);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hw::Wgmma<BKV>::template ss<0, 0>(s, desc_k(q_base, BQ, kk),
                                          desc_k(k_cur, BKV, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hw::Wgmma<BKV>::template ss<0, 0>(dp, desc_k(do_base, BQ, kk),
                                          desc_k(v_cur, BKV, kk), kk > 0);
      hw::wgmma_commit();
      const uint32_t k_prev = k_base(pk);
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc)
        hw::Wgmma<DP>::template rs<1>(dq, pa[kc], desc_mn(k_prev, BKV, kc),
                                      1);
      hw::wgmma_commit();
      hw::wgmma_wait<1>();   // the partials; the deferred product may run
      hw::fence_acc(s);
      hw::fence_acc(dp);
      if (lane == 0) hw::mbar_arrive(&empty_v[sv]);   // V read
      if constexpr (CL) {
        // The cluster's S and dP, in rank order.
        xs.begin();
        xs.send(s, 0);
        xs.send(dp, BKV / 8);
        xs.wait();
        xs.sum(s, 0);
        xs.sum(dp, BKV / 8);
        xs.end();
      }
      // dS, in place of S; the masks only where the block is not wholly
      // visible to this warpgroup's rows.
      with_flags(!block_visible(p, rw0, 64, col0, BKV), p.cap2 > 0.f,
                 [&](auto masked, auto capped) {
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            bool vis = true;
            if constexpr (decltype(masked)::value)
              vis = visible(p, i * BQ + r16 + 8 * h,
                            col0 + n * 8 + t4 * 2 + (e & 1));
            float prob;
            s[n][e] = grad_score_t<decltype(capped)::value>(
                p, s[n][e], dp[n][e], l2[h], dt[h], vis, prob);
          }
      });
      hw::wgmma_wait<0>();   // the deferred product
      hw::fence_acc(dq);
      hw::fence_frag(pa);
      if (t > 0 && lane == 0) hw::mbar_arrive(&empty_k[pk]);
      // This step's dS (rounded to bf16) for its deferred product.
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc)
        acc_to_a(pa[kc], s[2 * kc], s[2 * kc + 1]);
    }
    if (nblk > 0) {
      // The last step's product.
      const int last = (nblk - 1) % SK;
      hw::fence_acc(dq);
      hw::wgmma_fence();
      const uint32_t k_last = k_base(last);
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc)
        hw::Wgmma<DP>::template rs<1>(dq, pa[kc], desc_mn(k_last, BKV, kc),
                                      1);
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_acc(dq);
      hw::fence_frag(pa);
      if (lane == 0) hw::mbar_arrive(&empty_k[last]);
    }

    const size_t qoff = (size_t)bh * p.R * p.D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i * BQ + r16 + 8 * h;
      if (r >= p.R) continue;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = dcol + n * 8 + t4 * 2 + e;
          if (d < p.D) p.dq[qoff + (size_t)r * p.D + d] = dq[n][2 * h + e];
        }
    }
  }
  // No CTA leaves while the other may still write its slots or arrive on
  // its barriers.
  if constexpr (CL) {
    __syncwarp();
    hw::cluster_sync();
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int grid, int threads, size_t smem,
                   const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The first-cut and D-blocked kernels put (block, head[, panel]) on grid.x
// as (block + nblocks * head) * panels + panel: no 65535 limit on batch *
// heads. DBLK: ceil(D / DP) panels.
template <int DP, bool DBLK>
int panel_count(const BwdParams& p) {
  return DBLK ? (p.D + DP - 1) / DP : 1;
}

template <int BQ, int BKV, int DP, bool DBLK = false>
cudaError_t launch_q_bf16(int bh, const BwdParams& p, cudaStream_t s) {
  const size_t smem = sizeof(bf16) * (2 * BQ * (DP + 8) + 2 * BKV * (DP + 8)
                                      + DP * (BKV + 8)) + sizeof(float) * 2 * BQ;
  return launch(flash_bwd_q_bf16<BQ, BKV, DP, DBLK>,
                (p.R + BQ - 1) / BQ * bh * panel_count<DP, DBLK>(p), BQ * 2,
                smem, p, s);
}

template <int BQ, int BKV, int DP, bool DBLK = false>
cudaError_t launch_kv_bf16(int bhkv, const BwdParams& p, cudaStream_t s) {
  constexpr int DSPLIT = DP > 128 ? DP / 128 : 1;
  const size_t smem = sizeof(bf16) * (2 * BKV * (DP + 8) + 2 * BQ * (DP + 8)
                                      + 2 * DP * (BQ + 8)) + sizeof(float) * 2 * BQ;
  return launch(flash_bwd_kv_bf16<BQ, BKV, DP, DSPLIT, DBLK>,
                (p.C + BKV - 1) / BKV * bhkv * panel_count<DP, DBLK>(p),
                BKV / 16 * DSPLIT * 32, smem, p, s);
}

// DBLK keeps K's panel of the dQ columns apart (one more K tile).
template <int BQ, int DP, bool DBLK = false>
cudaError_t launch_q_f32(int bh, const BwdParams& p, cudaStream_t s) {
  const size_t smem = sizeof(float) * (2 * BQ * DP + (DBLK ? 3 : 2) * 32 *
                                       (DP + 1) + 2 * BQ);
  return launch(flash_bwd_q_f32<BQ, DP, DBLK>,
                (p.R + BQ - 1) / BQ * bh * panel_count<DP, DBLK>(p), 128,
                smem, p, s);
}

// DBLK keeps Q's and dO's panels of the dK / dV columns apart.
template <int BKV, int DP, bool DBLK = false>
cudaError_t launch_kv_f32(int bhkv, const BwdParams& p, cudaStream_t s) {
  const size_t smem = sizeof(float) * (2 * BKV * DP + (DBLK ? 4 : 2) * 32 *
                                       (DP + 1) + 2 * 32);
  return launch(flash_bwd_kv_f32<BKV, DP, DBLK>,
                (p.C + BKV - 1) / BKV * bhkv * panel_count<DP, DBLK>(p), 128,
                smem, p, s);
}

// The wgmma kernels' launch: the shared memory set, the tensor maps TMA
// reads (none for the copying producer), the kernel on a plain launch of
// `grid` CTAs or on clusters of `panels` CTAs (CL).
template <bool CL, typename Kernel>
cudaError_t launch_wgmma(Kernel kernel, int grid, int panels, int bytes,
                         const BwdParams& p, const CUtensorMap& mq,
                         const CUtensorMap& mdo, const CUtensorMap& mk,
                         const CUtensorMap& mv, cudaStream_t s) {
  if constexpr (CL) {
    static int fits[9] = {};
    return hw::launch_clusters(kernel, grid, panels, bytes, s, fits, p, mq,
                               mdo, mk, mv);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kWgmmaThreads, bytes, s>>>(p, mq, mdo, mk, mv);
    return cudaGetLastError();
  }
}

// Tensor maps of q, dO ([BH, R, D], boxes of bq rows) and k, v ([BH /
// group, C, D], boxes of bkv rows) for TMA; false where TMA cannot map
// one. The copying producer (PROD kCopy) needs none.
template <int PROD>
bool bwd_maps(const BwdParams& p, int bh, int bq, int bkv, CUtensorMap* mq,
              CUtensorMap* mdo, CUtensorMap* mk, CUtensorMap* mv) {
  const int bhkv = bh / p.group;
  return PROD != kTma ||
         (hw::tile_map_bf16(mq, p.q, p.D, p.R, bh, bq) &&
          hw::tile_map_bf16(mdo, p.d_o, p.D, p.R, bh, bq) &&
          hw::tile_map_bf16(mk, p.k, p.D, p.C, bhkv, bkv) &&
          hw::tile_map_bf16(mv, p.v, p.D, p.C, bhkv, bkv));
}

template <int BKV, int DP, int PROD = kTma>
cudaError_t launch_q_wgmma(int bh, const BwdParams& p, cudaStream_t s) {
  using L = QWgmmaSmem<BKV, DP, PROD>;
  CUtensorMap mq{}, mdo{}, mk{}, mv{};
  if (!bwd_maps<PROD>(p, bh, L::kBQ, BKV, &mq, &mdo, &mk, &mv))
    return cudaErrorInvalidValue;
  return launch_wgmma<false>(flash_bwd_q_wgmma<BKV, DP, PROD>,
                             (p.R + L::kBQ - 1) / L::kBQ * bh, 1, L::kBytes,
                             p, mq, mdo, mk, mv, s);
}

template <int BQ, int DP, int PROD = kTma>
cudaError_t launch_kv_wgmma(int bhkv, const BwdParams& p, cudaStream_t s) {
  using L = KvWgmmaSmem<BQ, DP, PROD>;
  CUtensorMap mq{}, mdo{}, mk{}, mv{};
  if (!bwd_maps<PROD>(p, bhkv * p.group, BQ, L::kBKV, &mq, &mdo, &mk, &mv))
    return cudaErrorInvalidValue;
  return launch_wgmma<false>(flash_bwd_kv_wgmma<BQ, DP, PROD>,
                             (p.C + L::kBKV - 1) / L::kBKV * bhkv, 1,
                             L::kBytes, p, mq, mdo, mk, mv, s);
}

// K4 on wide panels: P = panels CTAs a kv-block tile, CL for two (a
// cluster, the tile's CTAs adjacent on grid.x), one CTA without; grid.x =
// kv blocks x heads x panels, the first kv blocks (the longest causal
// walks) first.
template <int BQ, int DP, bool CL, int PROD = kTma>
cudaError_t launch_kv_split(int bhkv, int panels, const BwdParams& p,
                            cudaStream_t s) {
  using L = KvSplitSmem<BQ, DP, CL, PROD>;
  CUtensorMap mq{}, mdo{}, mk{}, mv{};
  if (panels != (CL ? 2 : 1) ||
      !bwd_maps<PROD>(p, bhkv * p.group, BQ, L::kBKV, &mq, &mdo, &mk, &mv))
    return cudaErrorInvalidValue;
  return launch_wgmma<CL>(flash_bwd_kv_split<BQ, DP, CL, PROD>,
                          (p.C + L::kBKV - 1) / L::kBKV * bhkv * panels,
                          panels, L::kBytes, p, mq, mdo, mk, mv, s);
}

// K3 on wide panels: P = panels CTAs a (q-block, head) tile, CL for two
// (a cluster, the tile's CTAs adjacent on grid.x), one CTA without; the
// last q-blocks (the longest causal walks) first.
template <int BKV, int DP, bool CL, int PROD = kTma>
cudaError_t launch_q_split(int bh, int panels, const BwdParams& p,
                           cudaStream_t s) {
  using L = QSplitSmem<BKV, DP, CL, PROD>;
  CUtensorMap mq{}, mdo{}, mk{}, mv{};
  if (panels != (CL ? 2 : 1) ||
      !bwd_maps<PROD>(p, bh, L::kBQ, BKV, &mq, &mdo, &mk, &mv))
    return cudaErrorInvalidValue;
  return launch_wgmma<CL>(flash_bwd_q_split<BKV, DP, CL, PROD>,
                          (p.R + L::kBQ - 1) / L::kBQ * bh * panels, panels,
                          L::kBytes, p, mq, mdo, mk, mv, s);
}

// TMA maps these operands: bf16 rows of a multiple of 16 bytes, 16-byte
// aligned bases.
bool tma_ok(int D, std::initializer_list<const void*> ptrs) {
  uintptr_t ptr_or = 0;
  for (const void* q : ptrs) ptr_or |= reinterpret_cast<uintptr_t>(q);
  return D % 8 == 0 && ptr_or % 16 == 0;
}

int vec_ok(int D, const void* a, const void* b, const void* c,
           const void* d) {
  const uintptr_t ptr_or =
      reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
      reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d);
  return (D % 8 == 0) && (ptr_or % 16 == 0);
}

// The copying producer's granule (hopper.cuh copy_granule) of the tensors
// it copies: q, k, v and dO.
int bwd_granule(const BwdParams& p) {
  return hw::copy_granule(
      p.D,
      reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
          reinterpret_cast<uintptr_t>(p.v) |
          reinterpret_cast<uintptr_t>(p.d_o));
}

// K3 with the copying producer: one CTA of the wgmma kernel (kernel 1) or
// of the head-dim-split kernel (kernel 3) at the table's row up to D =
// 256 (ops/params.py BWD_Q_COPY_ROWS).
cudaError_t launch_q_copying(int bh, int kernel, int block_kv, int block_d,
                             const BwdParams& p, cudaStream_t s) {
  if (kernel == 1 && block_kv == 64 && block_d == 64)
    return launch_q_wgmma<64, 64, kCopy>(bh, p, s);
  if (kernel == 1 && block_kv == 64 && block_d == 128)
    return launch_q_wgmma<64, 128, kCopy>(bh, p, s);
  if (kernel == 3 && block_kv == 32 && block_d == 192)
    return launch_q_split<32, 192, false, kCopy>(bh, 1, p, s);
  if (kernel == 3 && block_kv == 32 && block_d == 256)
    return launch_q_split<32, 256, false, kCopy>(bh, 1, p, s);
  return cudaErrorInvalidValue;
}

// K4 with the copying producer, as K3 (ops/params.py BWD_KV_COPY_ROWS).
cudaError_t launch_kv_copying(int bhkv, int kernel, int block_q,
                              int block_d, const BwdParams& p,
                              cudaStream_t s) {
  if (kernel == 1 && block_q == 64 && block_d == 64)
    return launch_kv_wgmma<64, 64, kCopy>(bhkv, p, s);
  if (kernel == 1 && block_q == 32 && block_d == 128)
    return launch_kv_wgmma<32, 128, kCopy>(bhkv, p, s);
  if (kernel == 3 && block_q == 32 && block_d == 192)
    return launch_kv_split<32, 192, false, kCopy>(bhkv, 1, p, s);
  if (kernel == 3 && block_q == 32 && block_d == 256)
    return launch_kv_split<32, 256, false, kCopy>(bhkv, 1, p, s);
  return cudaErrorInvalidValue;
}

// A copying launch's conditions: bf16, one CTA holding the whole head dim
// (D <= block_d), rows and bases of 4 bytes or more.
bool copy_ok(const BwdParams& p, int dtype, int panels, int block_d) {
  return dtype == 1 && panels == 1 && p.D <= block_d && p.gran >= 4;
}

}  // namespace

// K3. dtype: 0 = fp32, 1 = bf16 (q, k, v, d_o); o_f32: O is fp32 (else the
// input type); kernel: 0 the first-cut kernels (mma.sync / FMA), 1 the
// wgmma kernel, 2 the D-blocked kernels (mma.sync / FMA) over `panels`
// head-dim panels, 3 the head-dim-split kernel over `panels` panels (one
// CTA, or a cluster of two). (kernel, block_q, block_kv, block_d) must be
// a row of ops/params.py's flash_bwd_q tables. producer (kernels 1 and 3):
// 0 TMA, 1 cp.async (hopper.cuh Producer; 1 on one CTA, for bf16 rows TMA
// cannot map whose bases and row stride share 4 bytes).
extern "C" int mfa_flash_bwd_q(const void* q, const void* k, const void* v,
                               const void* o, const void* d_o,
                               const void* lse, void* dq, void* dterm,
                               int bh, int group, int R, int C, int D,
                               int panels, int causal, int window,
                               float scale2, float cap2, float scale,
                               int dtype, int o_f32, int kernel, int block_q,
                               int block_kv, int block_d, int producer,
                               void* stream) {
  if (!mfa::panels_ok(kernel, D, block_d, panels))
    return cudaErrorInvalidValue;
  BwdParams p{q, k, v, o, d_o, static_cast<const float*>(lse),
              static_cast<float*>(dterm), static_cast<float*>(dq), nullptr,
              nullptr, group, R, C, D, causal, window, scale2, cap2, scale,
              o_f32, vec_ok(D, q, k, v, d_o)};
  p.gran = bwd_granule(p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (producer == kCopy) {
    if (!copy_ok(p, dtype, panels, block_d) || block_q != 128)
      return cudaErrorInvalidValue;
    return launch_q_copying(bh, kernel, block_kv, block_d, p, s);
  }
  if (producer != kTma) return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (kernel == 2 && block_q == 16 && block_kv == 32) {
      if (block_d == 128) return launch_q_f32<16, 128, true>(bh, p, s);
      if (block_d == 256) return launch_q_f32<16, 256, true>(bh, p, s);
    }
    if (kernel == 0 && block_q == 16 && block_kv == 32) {
      if (block_d == 64) return launch_q_f32<16, 64>(bh, p, s);
      if (block_d == 128) return launch_q_f32<16, 128>(bh, p, s);
      if (block_d == 256) return launch_q_f32<16, 256>(bh, p, s);
    }
    return cudaErrorInvalidValue;
  }
  if (kernel == 1) {
    if (block_q != 128 || D > block_d || !tma_ok(D, {q, k, v, d_o}))
      return cudaErrorInvalidValue;
    if (block_kv == 64 && block_d == 64) return launch_q_wgmma<64, 64>(bh, p, s);
    if (block_kv == 64 && block_d == 128)
      return launch_q_wgmma<64, 128>(bh, p, s);
    return cudaErrorInvalidValue;
  }
  if (kernel == 3) {
    if (block_q != 128 || !tma_ok(D, {q, k, v, d_o}))
      return cudaErrorInvalidValue;
    // One CTA on a 64- or 128-wide panel: the sweep's candidates against
    // the wgmma kernel at D <= 128 (utils/bwd_tuning.py).
    if (block_kv == 64 && block_d == 64)
      return launch_q_split<64, 64, false>(bh, panels, p, s);
    if (block_kv == 64 && block_d == 128)
      return launch_q_split<64, 128, false>(bh, panels, p, s);
    if (block_kv == 32 && block_d == 192)
      return panels == 1 ? launch_q_split<32, 192, false>(bh, panels, p, s)
                         : launch_q_split<32, 192, true>(bh, panels, p, s);
    if (block_kv == 32 && block_d == 256)
      return panels == 1 ? launch_q_split<32, 256, false>(bh, panels, p, s)
                         : launch_q_split<32, 256, true>(bh, panels, p, s);
    return cudaErrorInvalidValue;
  }
  if (kernel == 2) {
    if (block_q == 64 && block_kv == 32 && block_d == 256)
      return launch_q_bf16<64, 32, 256, true>(bh, p, s);
    if (block_q == 64 && block_kv == 64 && block_d == 128)
      return launch_q_bf16<64, 64, 128, true>(bh, p, s);
    return cudaErrorInvalidValue;
  }
  if (kernel != 0) return cudaErrorInvalidValue;
  if (block_q == 64 && block_kv == 64 && block_d == 64)
    return launch_q_bf16<64, 64, 64>(bh, p, s);
  if (block_q == 64 && block_kv == 64 && block_d == 128)
    return launch_q_bf16<64, 64, 128>(bh, p, s);
  if (block_q == 64 && block_kv == 32 && block_d == 256)
    return launch_q_bf16<64, 32, 256>(bh, p, s);
  return cudaErrorInvalidValue;
}

// K4. dtype, kernel and panels as for K3 (kernel 3 the head-dim-split
// kernel over `panels` panels: one CTA, or a cluster of two); the D-term
// is K3's. (kernel, block_q, block_kv, block_d) must be a row of
// ops/params.py's flash_bwd_kv tables; producer as for K3.
extern "C" int mfa_flash_bwd_kv(const void* q, const void* k, const void* v,
                                const void* d_o, const void* lse,
                                const void* dterm, void* dk, void* dv,
                                int bhkv, int group, int R, int C, int D,
                                int panels, int causal, int window,
                                float scale2, float cap2, float scale,
                                int dtype, int kernel, int block_q,
                                int block_kv, int block_d, int producer,
                                void* stream) {
  if (!mfa::panels_ok(kernel, D, block_d, panels))
    return cudaErrorInvalidValue;
  BwdParams p{q, k, v, nullptr, d_o, static_cast<const float*>(lse),
              const_cast<float*>(static_cast<const float*>(dterm)), nullptr,
              static_cast<float*>(dk), static_cast<float*>(dv), group, R, C,
              D, causal, window, scale2, cap2, scale, 0,
              vec_ok(D, q, k, v, d_o)};
  p.gran = bwd_granule(p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (producer == kCopy) {
    if (!copy_ok(p, dtype, panels, block_d) || block_kv != 64)
      return cudaErrorInvalidValue;
    return launch_kv_copying(bhkv, kernel, block_q, block_d, p, s);
  }
  if (producer != kTma) return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (kernel == 2 && block_q == 32 && block_kv == 16) {
      if (block_d == 128) return launch_kv_f32<16, 128, true>(bhkv, p, s);
      if (block_d == 256) return launch_kv_f32<16, 256, true>(bhkv, p, s);
    }
    if (kernel == 0 && block_q == 32 && block_kv == 16) {
      if (block_d == 64) return launch_kv_f32<16, 64>(bhkv, p, s);
      if (block_d == 128) return launch_kv_f32<16, 128>(bhkv, p, s);
      if (block_d == 256) return launch_kv_f32<16, 256>(bhkv, p, s);
    }
    return cudaErrorInvalidValue;
  }
  if (kernel == 1) {
    if (block_kv != 64 || D > block_d ||
        !tma_ok(D, {q, k, v, d_o}))
      return cudaErrorInvalidValue;
    if (block_q == 32 && block_d == 64) return launch_kv_wgmma<32, 64>(bhkv, p, s);
    if (block_q == 32 && block_d == 128)
      return launch_kv_wgmma<32, 128>(bhkv, p, s);
    if (block_q == 64 && block_d == 64) return launch_kv_wgmma<64, 64>(bhkv, p, s);
    if (block_q == 64 && block_d == 128)
      return launch_kv_wgmma<64, 128>(bhkv, p, s);
    return cudaErrorInvalidValue;
  }
  if (kernel == 3) {
    if (block_q != 32 || block_kv != 64 || !tma_ok(D, {q, k, v, d_o}))
      return cudaErrorInvalidValue;
    if (block_d == 192)
      return panels == 1 ? launch_kv_split<32, 192, false>(bhkv, panels, p, s)
                         : launch_kv_split<32, 192, true>(bhkv, panels, p, s);
    if (block_d == 256)
      return panels == 1 ? launch_kv_split<32, 256, false>(bhkv, panels, p, s)
                         : launch_kv_split<32, 256, true>(bhkv, panels, p, s);
    return cudaErrorInvalidValue;
  }
  if (kernel == 2) {
    if (block_q == 32 && block_kv == 64 && block_d == 256)
      return launch_kv_bf16<32, 64, 256, true>(bhkv, p, s);
    if (block_q == 32 && block_kv == 64 && block_d == 128)
      return launch_kv_bf16<32, 64, 128, true>(bhkv, p, s);
    return cudaErrorInvalidValue;
  }
  if (kernel != 0) return cudaErrorInvalidValue;
  if (block_q == 32 && block_kv == 64) {
    if (block_d == 64) return launch_kv_bf16<32, 64, 64>(bhkv, p, s);
    if (block_d == 128) return launch_kv_bf16<32, 64, 128>(bhkv, p, s);
    if (block_d == 256) return launch_kv_bf16<32, 64, 256>(bhkv, p, s);
  }
  return cudaErrorInvalidValue;
}
