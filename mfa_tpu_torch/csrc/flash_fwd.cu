// Flash-attention forward for Hopper (sm_90a): online softmax over
// streamed K/V tiles, O and the natural-log logsumexp L.
//
// Replaces the TPU kernels mfa_tpu/kernels/flash_fwd.py::_fwd_kernel
// (non-causal) and ::_fwd_tablegrid_kernel (causal / sliding window, which
// walked only the live (q-block, kv-block) pairs from prefetched tables).
// Here one CTA owns one (batch*head, q-block); a loop over kv blocks
// j_min..j_max inside the CTA replaces the sequential grid axis, and the
// bounds are computed exactly as causal_pair_tables does, so dead blocks
// are never visited. A q-block with no live kv block still writes O = 0,
// L = 0. GQA: query head bh reads kv head bh / group.
//
// Conventions kept from the TPU kernel: exp2 with scale*log2(e) folded in
// (bf16: into Q, rounded to bf16; fp32: into S), optional tanh soft-cap,
// masks aligned to the sequence ends (offset = C - R) with the
// large-finite sentinel, P rounded to bf16 before PV for bf16 inputs,
// fp32 accumulation, rows that see no key give O = 0 and L = 0.
//
// What bounds it on an H100: causal prefill at Llama-3-8B widths (32
// heads, N = 2048, D = 128) is about 34 GFLOP per layer, ~35 us at the
// 989 TFLOP/s bf16 tensor-core peak, against ~2 MB of Q/K/V/O traffic
// (~1 us at 3.35 TB/s): the bound is operations, and the softmax's exp2
// (one a score, on the SM's 16 special-function lanes a clock) costs
// about half as many cycles as the two products of a block. So the design
// keeps the tensor cores fed and hides the softmax under products.
//
// bf16, D % 8 == 0 and D <= 128, 16-byte-aligned operands (rows "wgmma"
// of ops/params.py): flash_fwd_wgmma, warp-specialised, 384 threads = two
// consumer warpgroups of 64 query rows (block_q = 128) and one producer
// warpgroup (setmaxnreg 240 / 24 registers), as FlashAttention-3 lays it
// out (arXiv 2407.08608):
// - One producer thread loads Q once and K and V of each live kv block by
//   TMA (cp.async.bulk.tensor, 3-D maps over [BH, R, D] and
//   [BH / group, C, D], 128-byte-swizzled panels; rows past R or C arrive
//   as zeros) into two rings, one of K tiles and one of V tiles, each tile
//   with a full and an empty mbarrier, as deep as the launch's
//   `stages_k` and `stages_v` (ops/params.py fwd_rings: the tiles that
//   fit, each ring at most FWD_RING_STAGES; 3 + 3 at block_kv 128, D 128).
// - Each consumer warpgroup scales its 64 rows of Q in place (bf16(Q *
//   scale * log2e), as the plain version rounds) and walks the blocks:
//   S = Qs K^T on wgmma (A and B K-major), the online softmax in
//   registers, P rounded to bf16 into wgmma's register-A fragment, and
//   O += P V with the same V tile read MN-major (no transposed copy). The
//   PV of block j is issued together with S of block j + 1 and completes
//   under its softmax. A K tile is freed once its S has completed, a V
//   tile once the deferred PV that reads it has, a step later: so the V
//   ring, which holds each tile longer, takes the odd tile where shared
//   memory leaves one (3 V + 2 K tiles at D 256).
// - Ping-pong: warpgroup w issues its products only after named barrier
//   3 + w, which the other warpgroup arrives at once it has issued its
//   own, so one warpgroup's softmax runs while the other's products use
//   the tensor cores. (`pingpong` = 0 lets both issue freely.)
// - Masks are decided per block at compile time: a block wholly visible
//   to the warpgroup's rows runs the unmasked specialisation; only
//   diagonal and window-edge blocks, and a last block past C, test
//   elements. Both warpgroups walk all of the CTA's blocks with no
//   branch around a product: ptxas serialises every wgmma of a kernel in
//   which one sits in a branch it cannot prove uniform (build log
//   C7520), so a block a warpgroup's rows cannot see runs masked (P = 0)
//   rather than being skipped.
// - Epilogue: O / l staged in the warpgroup's Q rows (16-byte chunks
//   XOR-swizzled by row) and stored in 16-byte chunks along each row; an
//   fp32 O (bf16 inputs, dtype 2) is stored from registers; L by plain
//   stores.
// - Grid: the flat tile index on grid.x (no 65535 limit on batch *
//   heads), the last q-blocks (the longest causal walks) first, the
//   heads of one q-block adjacent, so a kv group's CTAs share its K/V
//   tiles in L2.
//
// bf16 at 128 < D <= 512 where TMA maps a row (D % 8 == 0, 16-byte-aligned
// bases and O; rows "wgmma_dblk"): the same kernel on a head-dim panel of
// 192 or 256 columns, DP. Up to D = 256 one CTA holds the whole head dim
// (CL false, a plain launch; columns past D arrive as zeros and are not
// stored). O at 64 x 256 fp32 is 128 registers a consumer thread, S at
// block_kv 64 another 32 and P 16, within setmaxnreg's 240 (ptxas: no
// spill). What bounds it at D 256 (B 1, H 8, N 4096): 4 D
// FLOP a visible pair, 69 GFLOP causal (0.070 ms at the bf16 peak)
// against ~0.07 GB of operands: bound by operations; measured at 1.9x
// that bound causal and 1.6x non-causal (PERF.md), and rings of 2 to 4
// tiles and ping-pong on or off move it by at most 1.1%, so it does not
// wait on its loads.
//
// Past D = 256: a thread-block cluster split across the head dim (CL). A
// cluster of P CTAs owns one (batch * head, q-block) tile; CTA p loads
// panel p (DP columns from p * DP; columns past D arrive as zeros) of Q,
// K and V by TMA and owns that panel of O. Per kv block each consumer
// warpgroup forms its partial S_p = Qs_p K_p^T on wgmma and pushes it
// into its slot of every other CTA's shared memory by st.async
// (hopper.cuh ClusterSum: the bytes are counted on that CTA's mbarrier,
// which is armed locally each block; a plain remote arrival frees the
// slot), then sums the P partials of its rows in rank order 0..P-1 while
// the previous block's PV runs. Every CTA so holds the same bits of S,
// and with them the same soft-cap, masks, row max, sum and P: S is
// formed once a (q-block, kv block) pair, as mfa_tpu's _fwd_kernel does
// (flash_fwd.py:180-260), with no atomics; O_p += P V_p on wgmma (N = DP)
// and rank 0 writes L. The walk, masks and ping-pong are the one-CTA
// kernel's, the same in every CTA of a cluster; clusters start and end
// on barrier.cluster, so no CTA leaves while another may still write its
// slots.
// - Panels: two CTAs of 192 (D <= 384) or 256 (D <= 512) columns, not 3-4
//   of 128: each CTA reads P - 1 partials of S (64 x 64 fp32 a warpgroup
//   and block) over the SM-to-SM network, which bounds the kernel; in
//   utils/bwd_tuning.py's sweep on the H100 the 128-wide clusters took
//   2.1-2.7x the time of the wide ones.
// - What bounds it at D 384 / 512 (B 1, H 8, N 4096): 4 D FLOP a visible
//   pair, 206 / 275 GFLOP non-causal (0.21 / 0.28 ms at the bf16 peak)
//   against ~0.1 GB of operands: bound by operations; measured at
//   3.6-4.8x that bound (PERF.md), the waits for the partner's partials
//   of S its largest cost.
// - The exchange slots (two warpgroups x P - 1 slots of 64 x block_kv
//   fp32) sit between Q and the K ring (fwd_layout); the rings keep 2-3
//   tiles each.
//
// bf16 rows TMA cannot map (D % 8 != 0, a base off 16 bytes) up to D =
// 256, where every base, O's too, and the row stride 2 D share 4 bytes
// (D even; OpenLLaMA-3B's D 100: 200-byte rows, 8-byte aligned): the same
// one-CTA kernel and rows, with a copying producer (PROD, a template flag;
// the TMA instances compile as before). Its 128 threads issue cp.async
// of that granule (8 or 4 bytes) straight into the swizzled slots, rows
// past R or C as zero-source copies (TMA's zeros), each thread's copies
// counted on the slot's full barrier (cp.async.mbarrier.arrive.noinc,
// 128 arrivals). cp.async writes through the generic proxy and wgmma
// reads through the async one, so each consumer thread fences
// (fence.proxy.async) after its full-barrier wait, before the products
// that read the tile. The columns D..DP-1 that no copy writes are zeroed
// once at the start in Q's tile and every ring slot (and fenced): they
// stay zero, so S and PV see zeros there and O's are zero, not stored.
// O is stored from the staged tile at the granule, never past column D.
// The producer warpgroup keeps the TMA producer's 24 registers: the
// launch holds 384 x 168 of them, and 2 x 128 x 240 + 128 x 24 is all of
// it.
// What bounds it at OpenLLaMA-3B's D 100 (Hq = Hkv 32, N 2048, causal):
// the tensor work is D 128's (the panel), 26.8 GFLOP of visible pairs
// (0.027 ms at the bf16 peak), and the producer's copies: 25 8-byte
// cp.async a row of K and of V, issued by four warps that share the
// SMs' schedulers with the consumers' softmax. Each thread walks runs of
// rows 8 apart (hopper.cuh copy_rows), whose swizzle stays fixed, so a
// copy costs two adds (the first loop, row-major with the swizzle
// worked out per copy, took 0.205 ms); rings of 2 + 2 tiles beat 3 + 3.
// On the H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md; utils/bwd_tuning.py
// sweep --only copy): 0.1256 ms causal, 0.1923 non-causal, against the
// mma.sync row's 0.4680 / 1.012; D 128 by TMA at Hkv 8 takes 0.0932 /
// 0.1411 (utils/decode_tuning.py turns --what k1_rows). At D 250 (H 8, N
// 1024, causal) 0.0700 against mma.sync's 0.2092. Dropped after that
// sweep: block_kv 64 at D 100 (0.1424 / 0.2247) and 32 at D 250 (0.1085),
// and a producer that moved each K / V tile by one 1-D bulk copy into a
// staging slot and repacked it into the swizzled tile (0.1555 / 0.2485 at
// D 100, 0.1150 at D 250: the repack is a second pass over the tile).
//
// Other rows keep the first cut: bf16 at odd D, a base only 2-byte
// aligned, or D % 8 != 0 past D = 256 runs warp-level mma.sync (m16n8k16)
// from shared-memory tiles loaded synchronously (rows "mma"); fp32
// inputs take a plain-FMA kernel: the fp32 budget (2e-5) rules out TF32
// tensor cores. Both use the same flat grid. Past D = 256 they run
// D-blocked (DBLK; rows "mma_dblk", "fma_dblk"; see flash_fwd_bf16): a
// CTA per block_d panel of O, S summed once a panel over panels of Q and
// K streamed by cp.async, for what the cluster kernel cannot take (D % 8
// != 0, a misaligned base, D > 512) and fp32.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace mfa;
using bf16 = __nv_bfloat16;
namespace hw = mfa::hopper;
using namespace hw;   // the layout and helpers of hopper.cuh

struct FwdParams {
  const void* q;   // [BH, R, D]
  const void* k;   // [BH / group, C, D]
  const void* v;
  void* o;         // [BH, R, D]
  float* lse;      // [BH, R]
  int group, R, C, D;
  int causal, window;   // window <= 0: none
  float scale2, cap2;   // scale*log2e; soft-cap*log2e (<= 0: none)
  int vec;              // 16-byte global loads allowed
  int o_f32;            // wgmma kernel: O in fp32
  int stages_k;         // wgmma kernel: tiles of the K ring
  int stages_v;         // wgmma kernel: tiles of the V ring
  int pingpong;         // wgmma kernel: consumer warpgroups take turns
  int gran;             // bytes every base and row stride is aligned to
                        // (4, 8 or 16)
};

__device__ __forceinline__ bool visible(const FwdParams& p, int row,
                                        int col) {
  return visible_rc(row, col, p.R, p.C, p.causal, p.window);
}

// The CTA's tile from the flat grid: q-block i of head bh; the heads of
// one q-block are adjacent and the last q-blocks come first.
__device__ __forceinline__ void tile_of(int nqb, int& i, int& bh) {
  const int bhs = gridDim.x / nqb;
  i = nqb - 1 - (int)blockIdx.x / bhs;
  bh = (int)blockIdx.x % bhs;
}

// The same for the D-blocked kernels, whose grid is tiles x panels: the
// panels of one tile are adjacent (they read the same Q and K panels).
__device__ __forceinline__ void panel_tile_of(int nqb, int panels, int& i,
                                              int& bh, int& panel) {
  const int bhs = gridDim.x / panels / nqb;
  const int tile = (int)blockIdx.x / panels;
  panel = (int)blockIdx.x % panels;
  i = nqb - 1 - tile / bhs;
  bh = tile % bhs;
}

// ---------------------------------------------------------------------------
// bf16 inputs the wgmma kernel cannot take (D % 8 != 0, a misaligned
// base; DBLK: D > 256): mma.sync, BQ / 16 warps of 16 rows.
//
// DBLK (rows "mma_dblk"): head-dim blocking, mfa_tpu's D-paged path
// (_fwd_kernel's qk / pv loops over block_d slices, flash_fwd.py:180-252
// and :413-456). The CTA owns O's columns [panel * DP, panel * DP + DP)
// of its q-block. It forms the whole S = Qs K^T of each kv block, summing
// DP-wide panels of Q and K streamed through shared memory, and
// multiplies P by its own panel of V, so shared memory holds one panel of
// Q, K and V^T at any head dim. Every panel CTA of a q-block sums S in
// the same order and so takes the same row max and sum; panel 0 writes L.
// That trades FLOPs (S once a panel) for no atomics and no second pass.
// ---------------------------------------------------------------------------
template <int BQ, int BKV, int DP, bool OUT_F32, bool DBLK>
__global__ void __launch_bounds__(BQ * 2)
flash_fwd_bf16(FwdParams p) {
  constexpr int NT = BQ * 2;        // BQ / 16 warps
  constexpr int QS = DP + 8;        // Q/K tile row stride (bank spread)
  constexpr int VS = BKV + 8;       // transposed-V tile row stride
  constexpr int NKT = BKV / 8;      // S n-tiles
  constexpr int NDT = DP / 8;       // O n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * QS;
  __nv_bfloat16* sVt = sK + BKV * QS;

  int i, bh, panel = 0;
  if constexpr (DBLK)
    panel_tile_of((p.R + BQ - 1) / BQ, (p.D + DP - 1) / DP, i, bh, panel);
  else
    tile_of((p.R + BQ - 1) / BQ, i, bh);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int R = p.R, C = p.C, D = p.D;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + (size_t)bh * R * D;
  const size_t kvoff = (size_t)(bh / p.group) * C * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + kvoff;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + kvoff;
  const int row0 = i * BQ;
  const int dcol = panel * DP;      // this CTA's O columns start here

  // Q tile (DBLK: a panel a step), pre-scaled by scale*log2e and rounded
  // to bf16; zero padded.
  if constexpr (!DBLK) {
    for (int idx = tid; idx < BQ * DP; idx += NT) {
      const int r = idx / DP, d = idx % DP;
      float x = 0.f;
      if (row0 + r < R && d < D)
        x = __bfloat162float(qg[(size_t)(row0 + r) * D + d]) * p.scale2;
      sQ[r * QS + d] = __float2bfloat16(x);
    }
  }

  float o_acc[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;
  float m_r[2] = {kMaskValue, kMaskValue};
  float l_r[2] = {0.f, 0.f};
  const int wrow = row0 + warp * 16 + g;   // rows wrow and wrow + 8

  int lo, hi;
  kv_range(p, i, BQ, BKV, lo, hi);
  for (int j = lo; j <= hi; ++j) {
    const int col0 = j * BKV;
    float s[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    // S = Q K^T for this warp's 16 rows, over the head dim's panels (one
    // panel unless DBLK); V's panel (columns dcol..) arrives with the
    // first.
    for (int d0 = 0; d0 < (DBLK ? D : 1); d0 += DP) {
      __syncthreads();   // previous tiles consumed
      if constexpr (DBLK) {
        load_panel<BQ, DP, NT>(qg, row0, R, D, d0, p.vec, p.scale2, sQ,
                               nullptr, tid);
        load_panel<BKV, DP, NT>(kg, col0, C, D, d0, p.vec, 0.f, sK, nullptr,
                                tid);
        if (d0 == 0)
          load_panel<BKV, DP, NT>(vg, col0, C, D, dcol, p.vec, 0.f, nullptr,
                                  sVt, tid);
        cp_async_wait_all();
      } else if (p.vec) {
        // K: consecutive threads take consecutive 8-wide chunks of a row.
        for (int c = tid; c < BKV * (DP / 8); c += NT) {
          const int r = c / (DP / 8), d = (c % (DP / 8)) * 8;
          uint4 val = make_uint4(0, 0, 0, 0);
          if (col0 + r < C && d < D)
            val = *reinterpret_cast<const uint4*>(kg + (size_t)(col0 + r) * D
                                                  + d);
          *reinterpret_cast<uint4*>(sK + r * QS + d) = val;
        }
        // V, transposed: consecutive threads take consecutive rows so the
        // scattered 2-byte shared stores stay conflict-free.
        for (int c = tid; c < BKV * (DP / 8); c += NT) {
          const int r = c % BKV, d = (c / BKV) * 8;
          uint4 val = make_uint4(0, 0, 0, 0);
          if (col0 + r < C && d < D)
            val = *reinterpret_cast<const uint4*>(vg + (size_t)(col0 + r) * D
                                                  + d);
          const __nv_bfloat16* e8 =
              reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
          for (int e = 0; e < 8; ++e) sVt[(d + e) * VS + r] = e8[e];
        }
      } else {
        for (int idx = tid; idx < BKV * DP; idx += NT) {
          const int r = idx / DP, d = idx % DP;
          __nv_bfloat16 kx = __float2bfloat16(0.f), vx = kx;
          if (col0 + r < C && d < D) {
            kx = kg[(size_t)(col0 + r) * D + d];
            vx = vg[(size_t)(col0 + r) * D + d];
          }
          sK[r * QS + d] = kx;
          sVt[d * VS + r] = vx;
        }
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        if (DBLK && d0 + kk >= D) break;   // the last panel's zero tail
        const __nv_bfloat16* qa = sQ + (warp * 16 + g) * QS + kk + t4 * 2;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(qa);
        a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * QS);
        a[2] = *reinterpret_cast<const uint32_t*>(qa + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * QS + 8);
#pragma unroll
        for (int n = 0; n < NKT; ++n) {
          const __nv_bfloat16* kb = sK + (n * 8 + g) * QS + kk + t4 * 2;
          mma_bf16(s[n], a, *reinterpret_cast<const uint32_t*>(kb),
                   *reinterpret_cast<const uint32_t*>(kb + 8));
        }
      }
    }

    // Soft-cap, mask, online softmax (rows wrow and wrow + 8).
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = col0 + n * 8 + t4 * 2 + (e & 1);
        float x = cap_score(s[n][e], p.cap2);
        if (!visible(p, wrow + 8 * h, col)) x = kMaskValue;
        s[n][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      corr[h] = exp2f(m_r[h] - mx[h]);
      m_r[h] = mx[h];
    }
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[n][e] - m_r[e >> 1]);
        s[n][e] = pe;
        rs[e >> 1] += pe;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(kFull, rs[h], 1);
      rs[h] += __shfl_xor_sync(kFull, rs[h], 2);
      l_r[h] = corr[h] * l_r[h] + rs[h];
    }
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      o_acc[n][0] *= corr[0];
      o_acc[n][1] *= corr[0];
      o_acc[n][2] *= corr[1];
      o_acc[n][3] *= corr[1];
    }

    // O += P V: the S accumulator layout is the A-fragment layout.
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
        if (DBLK && dcol + n * 8 >= D) break;   // past the last column
        const __nv_bfloat16* vb = sVt + (n * 8 + g) * VS + kc * 16 + t4 * 2;
        mma_bf16(o_acc[n], a, *reinterpret_cast<const uint32_t*>(vb),
                 *reinterpret_cast<const uint32_t*>(vb + 8));
      }
    }
  }

  // Finalize: rows that never saw a visible key give O = 0, L = 0.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow + 8 * h;
    if (r >= R) continue;
    const bool empty = m_r[h] == kMaskValue;
    const float l_safe = fmaxf(l_r[h], 1e-37f);
#pragma unroll
    for (int n = 0; n < NDT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = dcol + n * 8 + t4 * 2 + e;
        if (d >= D) continue;
        const float val = empty ? 0.f : o_acc[n][2 * h + e] / l_safe;
        const size_t at = ((size_t)bh * R + r) * D + d;
        if (OUT_F32)
          static_cast<float*>(p.o)[at] = val;
        else
          static_cast<__nv_bfloat16*>(p.o)[at] = __float2bfloat16(val);
      }
    if (t4 == 0 && panel == 0)
      p.lse[(size_t)bh * R + r] =
          empty ? 0.f : (m_r[h] + log2f(l_safe)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// fp32 inputs: plain FMA. Four warps of BQ/4 rows; lane = kv column of the
// 32-wide tile for S, lane = head-dim column for O. DBLK (rows
// "fma_dblk"): head-dim blocking as in flash_fwd_bf16, S summed over
// DP-wide panels of Q and K in one order by every panel CTA.
// ---------------------------------------------------------------------------
template <int BQ, int DP, bool DBLK>
__global__ void __launch_bounds__(128)
flash_fwd_f32(FwdParams p) {
  constexpr int BKV = 32;
  constexpr int RW = BQ / 4;        // rows per warp
  constexpr int ND = DP / 32;       // O columns per lane
  constexpr int KS = DP + 1;        // K/V tile row stride (bank spread)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + BQ * DP;
  float* sV = sK + BKV * KS;

  int i, bh, panel = 0;
  if constexpr (DBLK)
    panel_tile_of((p.R + BQ - 1) / BQ, (p.D + DP - 1) / DP, i, bh, panel);
  else
    tile_of((p.R + BQ - 1) / BQ, i, bh);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = p.R, C = p.C, D = p.D;
  const float* qg = static_cast<const float*>(p.q) + (size_t)bh * R * D;
  const size_t kvoff = (size_t)(bh / p.group) * C * D;
  const float* kg = static_cast<const float*>(p.k) + kvoff;
  const float* vg = static_cast<const float*>(p.v) + kvoff;
  const int row0 = i * BQ;
  const int dcol = panel * DP;      // this CTA's O columns start here

  if constexpr (!DBLK) {
    for (int idx = tid; idx < BQ * DP; idx += 128) {
      const int r = idx / DP, d = idx % DP;
      sQ[idx] = (row0 + r < R && d < D) ? qg[(size_t)(row0 + r) * D + d]
                                        : 0.f;
    }
  }

  float o_acc[RW][ND];
  float m_r[RW], l_r[RW];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    m_r[rr] = kMaskValue;
    l_r[rr] = 0.f;
#pragma unroll
    for (int n = 0; n < ND; ++n) o_acc[rr][n] = 0.f;
  }

  int lo, hi;
  kv_range(p, i, BQ, BKV, lo, hi);
  for (int j = lo; j <= hi; ++j) {
    const int col0 = j * BKV;
    // S of each row, over the head dim's panels (one unless DBLK); V's
    // panel (columns dcol..) arrives with the first.
    float xs[RW];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) xs[rr] = 0.f;
    for (int d0 = 0; d0 < (DBLK ? D : 1); d0 += DP) {
      __syncthreads();
      if constexpr (DBLK) {
        load_panel_f32<BQ, DP, DP, 128>(qg, row0, R, D, d0, sQ, tid);
        load_panel_f32<BKV, DP, KS, 128>(kg, col0, C, D, d0, sK, tid);
        if (d0 == 0)
          load_panel_f32<BKV, DP, KS, 128>(vg, col0, C, D, dcol, sV, tid);
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
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) {
          const float* qr = sQ + (warp * RW + rr) * DP;
          const float* kr = sK + lane * KS;
          float x = xs[rr];
          for (int d = 0; d < min(DP, D - d0); ++d) x = fmaf(qr[d], kr[d], x);
          xs[rr] = x;
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp * RW + rr;
      float x = xs[rr];
      if constexpr (!DBLK) {   // the one panel, a row at a time
        const float* qr = sQ + r * DP;
        const float* kr = sK + lane * KS;
        for (int d = 0; d < DP; ++d) x = fmaf(qr[d], kr[d], x);
      }
      x = cap_score(x * p.scale2, p.cap2);
      if (!visible(p, row0 + r, col0 + lane)) x = kMaskValue;
      const float m_new = fmaxf(m_r[rr], warp_max(x));
      const float corr = exp2f(m_r[rr] - m_new);
      const float pe = exp2f(x - m_new);
      l_r[rr] = corr * l_r[rr] + warp_sum(pe);
      m_r[rr] = m_new;
      float pv[ND];
#pragma unroll
      for (int n = 0; n < ND; ++n) pv[n] = 0.f;
      for (int jj = 0; jj < BKV; ++jj) {
        const float pj = __shfl_sync(kFull, pe, jj);
#pragma unroll
        for (int n = 0; n < ND; ++n)
          pv[n] = fmaf(pj, sV[jj * KS + lane + 32 * n], pv[n]);
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) o_acc[rr][n] = o_acc[rr][n] * corr + pv[n];
    }
  }

#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = row0 + warp * RW + rr;
    if (r >= R) continue;
    const bool empty = m_r[rr] == kMaskValue;
    const float l_safe = fmaxf(l_r[rr], 1e-37f);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = dcol + lane + 32 * n;
      if (d < D)
        static_cast<float*>(p.o)[((size_t)bh * R + r) * D + d] =
            empty ? 0.f : o_acc[rr][n] / l_safe;
    }
    if (lane == 0 && panel == 0)
      p.lse[(size_t)bh * R + r] =
          empty ? 0.f : (m_r[rr] + log2f(l_safe)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// bf16 on wgmma: the warp-specialised kernel (see the note at the top).
// ---------------------------------------------------------------------------
constexpr int kBQ = 128;   // query rows a CTA, 64 a consumer warpgroup

// The wgmma kernel's producer fills Q's tile and the K and V rings by TMA
// or by cp.async (hopper.cuh Producer).

// Shared memory: Q [kBQ x DP], the cluster kernel's exchange slots (two
// consumer warpgroups x `peers` slots of 64 x bkv fp32), `sk` K tiles and
// `sv` V tiles [bkv x DP], then the mbarriers q_full, full_k[sk],
// empty_k[sk], full_v[sv], empty_v[sv], and with peers each warpgroup's
// exchange full and empty (ops/params.py mirrors this).
struct FwdLayout {
  int x, k, v, bar, bytes;
};

// The most head-dim panels (CTAs of a cluster) of the cluster kernel at
// panel width dp: its exchange slots are sized for them (ops/params.py's
// DBLK_MAX_PANELS).
__host__ __device__ constexpr int dblk_max_panels(int dp) {
  return dp == 128 ? 4 : 2;
}

__host__ __device__ constexpr int fwd_exchange_bytes(int bkv, int peers) {
  return 2 * peers * 64 * bkv * 4;
}

__host__ __device__ inline FwdLayout fwd_layout(int bkv, int dp, int sk,
                                                int sv, int peers = 0) {
  FwdLayout L{};
  L.x = tile_bytes(kBQ, dp);
  L.k = L.x + fwd_exchange_bytes(bkv, peers);
  L.v = L.k + sk * tile_bytes(bkv, dp);
  L.bar = L.v + sv * tile_bytes(bkv, dp);
  L.bytes = L.bar + 8 * (1 + 2 * sk + 2 * sv + (peers ? 4 : 0)) + kAlignSlack;
  return L;
}

// Every column of [c0, c0 + nc) is visible to every row of [r0, r0 + 64):
// inside C, below the diagonal, inside the window. Rows past R are never
// stored, so they need no mask.
__device__ __forceinline__ bool block_visible(const FwdParams& p, int r0,
                                              int c0, int nc) {
  if (c0 + nc > p.C) return false;
  if (!(p.causal || p.window > 0)) return true;
  const int offset = p.C - p.R;
  if (c0 + nc - 1 > r0 + offset) return false;
  return !(p.window > 0 && c0 < r0 + 63 + offset - (p.window - 1));
}

// exp2 on the special-function unit, subnormal results flushed to zero
// (exp2f adds a range fix-up around each one).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Max or sum of this thread's 2 NT values of row half h (entries e = 2 h,
// 2 h + 1 of each n-tile) in four independent chains: one chain of 2 NT
// dependent steps would leave the two math warps a scheduler has stalled
// on latency.
template <bool MAX, int NT>
__device__ __forceinline__ float row_reduce(const float (&s)[NT][4], int h) {
  static_assert(NT % 4 == 0, "four chains");
  auto op = [](float a, float b) { return MAX ? fmaxf(a, b) : a + b; };
  float a[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) a[c] = op(s[c][2 * h], s[c][2 * h + 1]);
#pragma unroll
  for (int n = 4; n < NT; ++n)
    a[n % 4] = op(a[n % 4], op(s[n][2 * h], s[n][2 * h + 1]));
  return op(op(a[0], a[1]), op(a[2], a[3]));
}

// The online softmax of one block of S held as a wgmma accumulator (this
// thread's rows ra and ra + 8, columns col0 + 8 n + 2 t4 + e % 2):
// soft-cap and mask, the new running max m, corr = exp2(old m - new m)
// for what came before, P = exp2(S - m) in place of S, and the running sum
// l. MASKED / CAPPED: compile-time, so the unrolled loops do not branch.
template <bool MASKED, bool CAPPED, int NT>
__device__ __forceinline__ void online_softmax(const FwdParams& p,
                                               float (&s)[NT][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2], int ra,
                                               int col0, int t4) {
  if constexpr (CAPPED || MASKED) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
        if constexpr (CAPPED) x = p.cap2 * tanhf(x / p.cap2);
        if constexpr (MASKED) {
          if (!visible(p, ra + 8 * (e >> 1), col0 + n * 8 + t4 * 2 + (e & 1)))
            x = kMaskValue;
        }
        s[n][e] = x;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = fmaxf(m[h], row_reduce<true>(s, h));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    corr[h] = ex2(m[h] - mx);
    m[h] = mx;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = ex2(s[n][e] - m[e >> 1]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float rs = row_reduce<false>(s, h);
    rs += __shfl_xor_sync(kFull, rs, 1);
    rs += __shfl_xor_sync(kFull, rs, 2);
    l[h] = corr[h] * l[h] + rs;
  }
}

// O += P V: A = P from registers, B = a V tile read MN-major; one commit
// group.
template <int BKV, int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 8][4],
                                         const uint32_t (&pa)[BKV / 16][4],
                                         uint32_t v_base) {
#pragma unroll
  for (int kc = 0; kc < BKV / 16; ++kc)
    hw::Wgmma<DP>::template rs<1>(o, pa[kc], desc_mn(v_base, BKV, kc), 1);
  hw::wgmma_commit();
}

// A G-byte value (the copying producers' granule, 4 or 8 bytes).
template <int G>
using Granule = std::conditional_t<G == 4, uint32_t, uint2>;

// The copying producer (kCopy) at granule G, thread pt of the producer
// warpgroup: Q's tile, then K and V of each block of the CTA's walk (lo
// .. hi) into their rings, by cp.async straight into the slot, one
// arrival a thread on the tile's full barrier once its copies land.
template <int BKV, int DP, int G>
__device__ __forceinline__ void produce_copies(
    const FwdParams& p, unsigned char* sm, const FwdLayout& L,
    uint64_t* q_full, uint64_t* full_k, uint64_t* empty_k, uint64_t* full_v,
    uint64_t* empty_v, int i, int bh, int lo, int hi, int pt) {
  constexpr int KV_TILE = tile_bytes(BKV, DP);
  const int rb = 2 * p.D, SK = p.stages_k, SV = p.stages_v;
  const size_t kv0 = (size_t)(bh / p.group) * p.C * rb;
  const auto* k = static_cast<const unsigned char*>(p.k) + kv0;
  const auto* v = static_cast<const unsigned char*>(p.v) + kv0;
  hw::copy_rows<kBQ, G>(sm,
                        static_cast<const unsigned char*>(p.q) +
                            (size_t)bh * p.R * rb,
                        i * kBQ, p.R, rb, pt, kWgThreads);
  hw::cp_async_arrive(q_full);
  for (int j = lo; j <= hi; ++j) {
    const int t = j - lo, sk = t % SK, sv = t % SV;
    hw::mbar_wait(&empty_k[sk], ((t / SK) & 1) ^ 1);
    hw::copy_rows<BKV, G>(sm + L.k + sk * KV_TILE, k, j * BKV, p.C, rb, pt,
                          kWgThreads);
    hw::cp_async_arrive(&full_k[sk]);
    hw::mbar_wait(&empty_v[sv], ((t / SV) & 1) ^ 1);
    hw::copy_rows<BKV, G>(sm + L.v + sv * KV_TILE, v, j * BKV, p.C, rb, pt,
                          kWgThreads);
    hw::cp_async_arrive(&full_v[sv]);
  }
}

// CL: the cluster kernel past D = 256 (rows "wgmma_dblk"; see the note at
// the top): CTA p of a cluster of P owns head-dim panel p (DP columns
// from p * DP) of Q, K, V and O; S is the sum of the P panels' partials
// (ClusterSum), the same bits in every CTA. Without CL one CTA owns the
// whole head dim (D <= DP). PROD: how the producer fills the tiles
// (Producer; the copying one on one CTA only, its maps unused).
template <int BKV, int DP, bool CL = false, int PROD = kTma>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_fwd_wgmma(const FwdParams p, const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv) {
  static_assert(PROD == kTma || !CL, "the copying producer on one CTA only");
  constexpr int KV_TILE = tile_bytes(BKV, DP);
  const int SK = p.stages_k, SV = p.stages_v;
  const int peers = CL ? dblk_max_panels(DP) - 1 : 0;
  const FwdLayout L = fwd_layout(BKV, DP, SK, SV, peers);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_atom(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L.bar);
  uint64_t* full_k = q_full + 1;
  uint64_t* empty_k = full_k + SK;
  uint64_t* full_v = empty_k + SK;
  uint64_t* empty_v = full_v + SV;
  uint64_t* x_full = empty_v + SV;   // [warpgroup] (CL)
  uint64_t* x_empty = x_full + 2;

  int i, bh, rank = 0, size = 1;
  if constexpr (CL) {
    rank = hw::cluster_rank();   // = blockIdx.x % size: the panel
    size = hw::cluster_size();
    int panel;
    panel_tile_of((p.R + kBQ - 1) / kBQ, size, i, bh, panel);
  } else {
    tile_of((p.R + kBQ - 1) / kBQ, i, bh);
  }
  const int dcol = rank * DP;   // this CTA's head-dim panel starts here
  const int bhkv = bh / p.group;
  const int tid = threadIdx.x, wg = hw::warpgroup_index();
  // The CTA's walk. When no row of the CTA sees a key it walks block 0
  // anyway, wholly masked, so that every CTA runs the same unconditional
  // pipeline (its rows keep the sentinel max and write O = 0, L = 0).
  int lo_c, hi_c;
  pair_kv_range(p, i, BKV, lo_c, hi_c);
  if (lo_c > hi_c) lo_c = hi_c = 0;

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
        hw::mbar_init(&x_empty[w], 4 * (size - 1));   // the others' warps
      }
    }
    hw::mbar_init_fence();
  }
  if constexpr (PROD != kTma) {
    // A copying producer writes D columns a row: the chunks past them are
    // zeroed once here, in Q's tile and every ring slot (TMA fills them
    // with zeros itself), and stay zero for the whole walk; the fence
    // makes the zeros visible to wgmma's async proxy.
    const int c0 = p.D / 8;
    hw::zero_chunks(sm, kBQ, DP, c0, tid, kWgmmaThreads);
    for (int s = 0; s < SK; ++s)
      hw::zero_chunks(sm + L.k + s * KV_TILE, BKV, DP, c0, tid,
                      kWgmmaThreads);
    for (int s = 0; s < SV; ++s)
      hw::zero_chunks(sm + L.v + s * KV_TILE, BKV, DP, c0, tid,
                      kWgmmaThreads);
    hw::fence_proxy_async();
  }
  if constexpr (CL)
    hw::cluster_sync();
  else
    __syncthreads();

  if (wg == 2) {
    if constexpr (PROD != kTma) {
      // The copying producer: all 128 threads, at the granule the rows and
      // bases share. It keeps the TMA producer's 24 registers: the launch
      // gives each of the 384 threads 168 of the SM's 65,536, and the
      // consumers' setmaxnreg.inc to 240 waits until the producer has
      // released 128 x (168 - 24), all the consumers take (at 32 they
      // waited forever).
      hw::setmaxnreg_dec<kProducerRegs>();
      const int pt = tid - 2 * kWgThreads;
      if (p.gran >= 8)
        produce_copies<BKV, DP, 8>(p, sm, L, q_full, full_k, empty_k,
                                   full_v, empty_v, i, bh, lo_c, hi_c, pt);
      else
        produce_copies<BKV, DP, 4>(p, sm, L, q_full, full_k, empty_k,
                                   full_v, empty_v, i, bh, lo_c, hi_c, pt);
    } else {
      // Producer: Q once, then K and V of each block of the CTA's walk.
      hw::setmaxnreg_dec<kProducerRegs>();
      if (tid == 2 * kWgThreads) {
        hw::mbar_expect_tx(q_full, tile_bytes(kBQ, DP));
#pragma unroll
        for (int pn = 0; pn < DP / 64; ++pn)
          hw::tma_load_3d(sm + pn * kBQ * kPanelBytes, &mq, q_full,
                          dcol + 64 * pn, i * kBQ, bh);
        for (int j = lo_c; j <= hi_c; ++j) {
          const int t = j - lo_c, sk = t % SK, sv = t % SV;
          hw::mbar_wait(&empty_k[sk], ((t / SK) & 1) ^ 1);
          unsigned char* k_tile = sm + L.k + sk * KV_TILE;
          hw::mbar_expect_tx(&full_k[sk], KV_TILE);
#pragma unroll
          for (int pn = 0; pn < DP / 64; ++pn)
            hw::tma_load_3d(k_tile + pn * BKV * kPanelBytes, &mk,
                            &full_k[sk], dcol + 64 * pn, j * BKV, bhkv);
          hw::mbar_wait(&empty_v[sv], ((t / SV) & 1) ^ 1);
          unsigned char* v_tile = sm + L.v + sv * KV_TILE;
          hw::mbar_expect_tx(&full_v[sv], KV_TILE);
#pragma unroll
          for (int pn = 0; pn < DP / 64; ++pn)
            hw::tma_load_3d(v_tile + pn * BKV * kPanelBytes, &mv,
                            &full_v[sv], dcol + 64 * pn, j * BKV, bhkv);
        }
      }
    }
  } else {
    hw::setmaxnreg_inc<kConsumerRegs>();
    const int w = wg, wt = tid % kWgThreads, wi = wt >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int rw0 = i * kBQ + 64 * w;     // this warpgroup's first row
    const int ra = rw0 + wi * 16 + g;     // this thread's rows ra, ra + 8
    // This warpgroup's rows of Q: 64 rows into each 128-row panel.
    unsigned char* q_rows = sm + 64 * w * kPanelBytes;
    hw::mbar_wait(q_full, 0);
#pragma unroll
    for (int pn = 0; pn < DP / 64; ++pn) {
      unsigned char* rows = q_rows + pn * kBQ * kPanelBytes;
      scale_chunks(rows, rows, 64 * kPanelBytes, p.scale2, wt, kWgThreads);
    }
    hw::fence_proxy_async();
    hw::named_barrier(1 + w, kWgThreads);
    // Turns: warpgroup 0 goes first.
    const int my_turn = 3 + w, their_turn = 4 - w;
    if (p.pingpong && w == 1) hw::named_arrive(3, 2 * kWgThreads);
    const uint32_t q_base = hw::smem_addr(q_rows);
    auto k_base = [&](int stage) {
      return hw::opaque(hw::smem_addr(sm + L.k + stage * KV_TILE));
    };
    auto v_base = [&](int stage) {
      return hw::opaque(hw::smem_addr(sm + L.v + stage * KV_TILE));
    };
    // The exchange of S's partials with this warpgroup's twins in the
    // other CTAs of the cluster: a 16-byte chunk an n-tile of S.
    using Sum = hw::ClusterSum<BKV / 8>;
    Sum xs{hw::smem_addr(sm + L.x + w * peers * Sum::kSlotBytes), &x_full[w],
           &x_empty[w], rank, size, wt, lane};

    float o[DP / 8][4];
    float s[BKV / 8][4];
    uint32_t pa[BKV / 16][4] = {};   // P of the block whose PV is deferred
    zero_acc(o);
    float m[2] = {kMaskValue, kMaskValue};
    float l[2] = {0.f, 0.f};

    // Both warpgroups walk every block of the CTA's walk, with no branch
    // around a product (ptxas serialises every wgmma of a kernel that has
    // one it cannot prove uniform). A block none of a warpgroup's rows
    // sees (at most one at a causal diagonal, or a window's edge) goes
    // through the mask and changes nothing: P = 0, corr = 1.
    const int nblk = hi_c - lo_c + 1;
    for (int t = 0; t < nblk; ++t) {
      const int sk = t % SK;
      // The V tile the deferred PV reads: block t - 1's, or before the
      // first block (P = 0) this block's.
      const int tv = t > 0 ? t - 1 : 0, vs = tv % SV;
      hw::mbar_wait(&full_k[sk], (t / SK) & 1);
      hw::mbar_wait(&full_v[vs], (tv / SV) & 1);
      // cp.async writes through the generic proxy: order them before
      // wgmma's reads (the barrier made them visible to this thread).
      if constexpr (PROD != kTma) hw::fence_proxy_async();
      if (p.pingpong) hw::named_barrier(my_turn, 2 * kWgThreads);
      // S = Qs K^T (A = this warpgroup's rows of Q, B = the K tile, both
      // K-major; the first k-step overwrites S), then the previous
      // block's O += P V (none before the first block: P = 0): two commit
      // groups.
      hw::fence_acc(s);
      hw::fence_acc(o);
      hw::wgmma_fence();
      const uint32_t kb = k_base(sk);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hw::Wgmma<BKV>::template ss<0, 0>(s, desc_k(q_base, kBQ, kk),
                                          desc_k(kb, BKV, kk), kk > 0);
      hw::wgmma_commit();
      issue_pv<BKV, DP>(o, pa, v_base(vs));
      if (p.pingpong) hw::named_arrive(their_turn, 2 * kWgThreads);
      hw::wgmma_wait<1>();   // S; the PV may still run
      hw::fence_acc(s);
      if (lane == 0) hw::mbar_arrive(&empty_k[sk]);   // K read
      if constexpr (CL) {
        // This CTA's S is its panel's partial: the cluster's sum, in rank
        // order, under the PV.
        xs.begin();
        xs.send(s, 0);
        xs.wait();
        xs.sum(s, 0);
        xs.end();
      }
      float corr[2];
      const int col0 = (lo_c + t) * BKV;
      with_flags(!block_visible(p, rw0, col0, BKV), p.cap2 > 0.f,
                 [&](auto masked, auto capped) {
                   online_softmax<decltype(masked)::value,
                                  decltype(capped)::value>(p, s, m, l, corr,
                                                           ra, col0, t4);
                 });
      hw::wgmma_wait<0>();   // the previous block's PV
      hw::fence_acc(o);
      hw::fence_frag(pa);
      if (t > 0 && lane == 0) hw::mbar_arrive(&empty_v[vs]);
      // O to the new running max; this block's P to bf16 for its PV.
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc)
        acc_to_a(pa[kc], s[2 * kc], s[2 * kc + 1]);
    }
    // The last block's PV.
    const int last = (nblk - 1) % SV;
    hw::mbar_wait(&full_v[last], ((nblk - 1) / SV) & 1);
    if constexpr (PROD != kTma) hw::fence_proxy_async();
    hw::fence_acc(o);
    hw::wgmma_fence();
    issue_pv<BKV, DP>(o, pa, v_base(last));
    hw::wgmma_wait<0>();
    hw::fence_acc(o);
    hw::fence_frag(pa);
    if (lane == 0) hw::mbar_arrive(&empty_v[last]);
    // Warpgroup 0 takes warpgroup 1's last arrival, so none is left over.
    if (p.pingpong && w == 0) hw::named_barrier(my_turn, 2 * kWgThreads);

    // Rows that never saw a visible key give O = 0, L = 0.
    bool empty_row[2];
    float l_safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      empty_row[h] = m[h] == kMaskValue;
      l_safe[h] = fmaxf(l[h], 1e-37f);
    }
    const size_t row_base = (size_t)bh * p.R;
    if (p.o_f32) {
      float* og = static_cast<float*>(p.o);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ra + 8 * h;
        if (r >= p.R) continue;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          const int d = dcol + n * 8 + t4 * 2;
          if (d >= p.D) continue;
          float2 val = make_float2(0.f, 0.f);
          if (!empty_row[h])
            val = make_float2(o[n][2 * h] / l_safe[h],
                              o[n][2 * h + 1] / l_safe[h]);
          float* at = og + (row_base + r) * p.D + d;
          if (PROD == kTma || p.gran >= 8) {   // 8-byte-aligned O
            *reinterpret_cast<float2*>(at) = val;
          } else {   // O 4-byte aligned
            at[0] = val.x;
            at[1] = val.y;
          }
        }
      }
    } else {
      // Staged in this warpgroup's Q rows (its products have all read
      // them): 16-byte chunk c of local row rl sits at chunk c ^ (rl % 8)
      // of its panel row, so a warp's 4-byte writes hit 32 banks.
      hw::named_barrier(1 + w, kWgThreads);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wi * 16 + g + 8 * h;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          float v0 = 0.f, v1 = 0.f;
          if (!empty_row[h]) {
            v0 = o[n][2 * h] / l_safe[h];
            v1 = o[n][2 * h + 1] / l_safe[h];
          }
          *reinterpret_cast<uint32_t*>(
              q_rows + (n / 8) * kBQ * kPanelBytes + rl * kPanelBytes +
              ((n % 8) ^ (rl % 8)) * 16 + t4 * 4) = pack_bf16(v0, v1);
        }
      }
      hw::named_barrier(1 + w, kWgThreads);
      if constexpr (PROD != kTma) {
        // Rows of 2 D bytes, stored at the granule they share; nothing
        // past column D.
        const int rb = 2 * p.D;
        unsigned char* og =
            static_cast<unsigned char*>(p.o) + (row_base + rw0) * rb;
        auto store = [&](auto granule) {
          constexpr int G = decltype(granule)::value;
          hw::for_runs<G>(kBQ, rb, wt, kWgThreads, [&](int r0, int c, int at) {
#pragma unroll
            for (int k = 0; k < 8; ++k) {   // the warpgroup's 64 rows
              const int rl = r0 + 8 * k;
              if (rw0 + rl < p.R)
                *reinterpret_cast<Granule<G>*>(og + (size_t)rl * rb + c) =
                    *reinterpret_cast<const Granule<G>*>(
                        q_rows + at + k * 8 * kPanelBytes);
            }
          });
        };
        if (p.gran >= 8)
          store(std::integral_constant<int, 8>{});
        else
          store(std::integral_constant<int, 4>{});
      } else {
        bf16* og = static_cast<bf16*>(p.o);
        constexpr int CH = DP / 8;   // 16-byte chunks a row
        for (int idx = wt; idx < 64 * CH; idx += kWgThreads) {
          const int rl = idx / CH, c = idx % CH, r = rw0 + rl;
          if (r < p.R && dcol + c * 8 < p.D)
            *reinterpret_cast<uint4*>(og + (row_base + r) * p.D + dcol +
                                      c * 8) =
                *reinterpret_cast<const uint4*>(
                    q_rows + (c / 8) * kBQ * kPanelBytes + rl * kPanelBytes +
                    ((c % 8) ^ (rl % 8)) * 16);
        }
      }
    }
    // L: every CTA of a cluster holds the same m and l; rank 0 writes it.
    if (t4 == 0 && rank == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ra + 8 * h;
        if (r < p.R)
          p.lse[row_base + r] =
              empty_row[h] ? 0.f : (m[h] + log2f(l_safe[h])) * kLn2;
      }
    }
  }
  // No CTA leaves while another may still read its slots or arrive on its
  // barriers.
  if constexpr (CL) {
    __syncwarp();
    hw::cluster_sync();
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int grid, int threads, size_t smem,
                   const FwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The first-cut and D-blocked kernels: (q-block, head[, panel]) on
// grid.x; DBLK: ceil(D / DP) panels.
template <int BQ, int BKV, int DP, bool DBLK = false>
cudaError_t launch_bf16(bool out_f32, int bh, const FwdParams& p,
                        cudaStream_t stream) {
  const size_t smem =
      sizeof(bf16) * (BQ * (DP + 8) + BKV * (DP + 8) + DP * (BKV + 8));
  const int grid =
      (p.R + BQ - 1) / BQ * bh * (DBLK ? (p.D + DP - 1) / DP : 1);
  if (out_f32)
    return launch(flash_fwd_bf16<BQ, BKV, DP, true, DBLK>, grid, BQ * 2, smem,
                  p, stream);
  return launch(flash_fwd_bf16<BQ, BKV, DP, false, DBLK>, grid, BQ * 2, smem,
                p, stream);
}

template <int BQ, int DP, bool DBLK = false>
cudaError_t launch_f32(int bh, const FwdParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * DP + 2 * 32 * (DP + 1));
  return launch(flash_fwd_f32<BQ, DP, DBLK>,
                (p.R + BQ - 1) / BQ * bh * (DBLK ? (p.D + DP - 1) / DP : 1),
                128, smem, p, stream);
}

// The wgmma kernel: one CTA a (head, q-block) tile (CL false; DP covers
// D), or a cluster of `panels` CTAs, CTA p on head-dim panel p of DP
// columns (grid.x = tiles x panels, a tile's panels adjacent). Its rings
// hold p.stages_k K and p.stages_v V tiles (ops/params.py fwd_rings);
// PROD its producer (the tensor maps only for kTma).
template <int BKV, int DP, bool CL, int PROD = kTma>
cudaError_t launch_wgmma(int bh, int panels, const FwdParams& p,
                         cudaStream_t s) {
  constexpr int kPeers = CL ? dblk_max_panels(DP) - 1 : 0;
  if (CL ? panels < 2 || panels > kPeers + 1 : panels != 1)
    return cudaErrorInvalidValue;
  const FwdLayout L = fwd_layout(BKV, DP, p.stages_k, p.stages_v, kPeers);
  if (p.stages_k < 1 || p.stages_v < 1 || L.bytes > kSmemOptin)
    return cudaErrorInvalidValue;
  CUtensorMap mq{}, mk{}, mv{};
  const int bhkv = bh / p.group;
  if (PROD == kTma && (!hw::tile_map_bf16(&mq, p.q, p.D, p.R, bh, kBQ) ||
                       !hw::tile_map_bf16(&mk, p.k, p.D, p.C, bhkv, BKV) ||
                       !hw::tile_map_bf16(&mv, p.v, p.D, p.C, bhkv, BKV)))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma<BKV, DP, CL, PROD>;
  const int grid = (p.R + kBQ - 1) / kBQ * bh * panels;
  if constexpr (CL) {
    static int fits[9] = {};
    return hw::launch_clusters(kernel, grid, panels, L.bytes, s, fits, p, mq,
                               mk, mv);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kWgmmaThreads, L.bytes, s>>>(p, mq, mk, mv);
    return cudaGetLastError();
  }
}

}  // namespace

// One CTA of the wgmma kernel with the copying producer at the table's
// (block_kv, block_d) up to D = 256 (ops/params.py _FWD_BF16).
static cudaError_t launch_copying(int bh, int block_kv, int block_d,
                                  const FwdParams& p, cudaStream_t s) {
  if (block_kv == 128 && block_d == 64)
    return launch_wgmma<128, 64, false, kCopy>(bh, 1, p, s);
  if (block_kv == 128 && block_d == 128)
    return launch_wgmma<128, 128, false, kCopy>(bh, 1, p, s);
  if (block_kv == 64 && block_d == 192)
    return launch_wgmma<64, 192, false, kCopy>(bh, 1, p, s);
  if (block_kv == 64 && block_d == 256)
    return launch_wgmma<64, 256, false, kCopy>(bh, 1, p, s);
  return cudaErrorInvalidValue;
}

// dtype: 0 = fp32 in/out, 1 = bf16 in/out, 2 = bf16 in, fp32 out. kernel:
// 0 the first-cut kernels (mma.sync / FMA), 1 the wgmma kernel, whose K
// and V rings hold `stages_k` and `stages_v` tiles and whose consumer
// warpgroups take turns when `pingpong` != 0, 2 the D-blocked kernels
// (mma.sync / FMA) over `panels` = ceil(D / block_d) head-dim panels (1
// for the others), 3 the wgmma kernel on a block_d-wide head-dim panel:
// one CTA for one panel, else a cluster of `panels` CTAs, one a panel
// (rings and turns as for 1). (kernel, block_q, block_kv, block_d) must
// be a row of ops/params.py's flash_fwd tables. producer (kernels 1 and
// 3): 0 TMA, 1 cp.async (Producer; 1 on one CTA, for rows TMA cannot map
// whose bases and row stride share 4 bytes).
extern "C" int mfa_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int group, int R,
                             int C, int D, int panels, int causal,
                             int window, float scale2, float cap2, int dtype,
                             int kernel, int block_q, int block_kv,
                             int block_d, int stages_k, int stages_v,
                             int pingpong, int producer, void* stream) {
  if (!mfa::panels_ok(kernel, D, block_d, panels))
    return cudaErrorInvalidValue;
  FwdParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.group = group;
  p.R = R;
  p.C = C;
  p.D = D;
  p.causal = causal;
  p.window = window;
  p.scale2 = scale2;
  p.cap2 = cap2;
  const uintptr_t ptr_or = reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v);
  p.vec = (D % 8 == 0) && (ptr_or % 16 == 0);
  // The largest of 16, 8, 4 (else 2) bytes that every base, O's too, and
  // the bf16 row stride 2 D are multiples of.
  p.gran = hw::copy_granule(D, ptr_or | reinterpret_cast<uintptr_t>(o));
  p.o_f32 = dtype == 2;
  p.stages_k = stages_k;
  p.stages_v = stages_v;
  p.pingpong = pingpong;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (kernel == 2 && block_q == 16 && block_kv == 32) {
      if (block_d == 128) return launch_f32<16, 128, true>(bh, p, s);
      if (block_d == 256) return launch_f32<16, 256, true>(bh, p, s);
    }
    if (kernel == 0 && block_q == 16 && block_kv == 32) {
      if (block_d == 64) return launch_f32<16, 64>(bh, p, s);
      if (block_d == 128) return launch_f32<16, 128>(bh, p, s);
      if (block_d == 256) return launch_f32<16, 256>(bh, p, s);
    }
    return cudaErrorInvalidValue;
  }
  const bool out_f32 = dtype == 2;
  if ((kernel == 1 || kernel == 3) && producer == kCopy) {
    // One CTA holding the whole head dim; rows and bases of 4 bytes or
    // more.
    if (block_q != kBQ || panels != 1 || D > block_d || p.gran < 4)
      return cudaErrorInvalidValue;
    return launch_copying(bh, block_kv, block_d, p, s);
  }
  if (producer != kTma) return cudaErrorInvalidValue;
  if (kernel == 1) {
    // TMA maps the operands and O takes 16-byte stores: rows of a
    // multiple of 16 bytes, 16-byte-aligned bases.
    if (block_q != kBQ || D > block_d || !p.vec ||
        reinterpret_cast<uintptr_t>(o) % 16 != 0)
      return cudaErrorInvalidValue;
    if (block_kv == 64 && block_d == 64)
      return launch_wgmma<64, 64, false>(bh, 1, p, s);
    if (block_kv == 128 && block_d == 64)
      return launch_wgmma<128, 64, false>(bh, 1, p, s);
    if (block_kv == 64 && block_d == 128)
      return launch_wgmma<64, 128, false>(bh, 1, p, s);
    if (block_kv == 128 && block_d == 128)
      return launch_wgmma<128, 128, false>(bh, 1, p, s);
    return cudaErrorInvalidValue;
  }
  if (kernel == 3) {
    // TMA maps, 16-byte O stores, as for kernel 1. One panel: one CTA, a
    // plain launch (block_kv 64 or 32); more: a cluster (block_kv 64).
    if (block_q != kBQ || !p.vec || reinterpret_cast<uintptr_t>(o) % 16 != 0)
      return cudaErrorInvalidValue;
    if (panels == 1 && block_kv == 64 && block_d == 192)
      return launch_wgmma<64, 192, false>(bh, 1, p, s);
    if (panels == 1 && block_kv == 64 && block_d == 256)
      return launch_wgmma<64, 256, false>(bh, 1, p, s);
    if (panels == 1 && block_kv == 32 && block_d == 192)
      return launch_wgmma<32, 192, false>(bh, 1, p, s);
    if (panels == 1 && block_kv == 32 && block_d == 256)
      return launch_wgmma<32, 256, false>(bh, 1, p, s);
    if (block_kv != 64) return cudaErrorInvalidValue;
    if (block_d == 128)
      return launch_wgmma<64, 128, true>(bh, panels, p, s);
    if (block_d == 192)
      return launch_wgmma<64, 192, true>(bh, panels, p, s);
    if (block_d == 256)
      return launch_wgmma<64, 256, true>(bh, panels, p, s);
    return cudaErrorInvalidValue;
  }
  if (kernel == 2) {
    if (block_q == 64 && block_kv == 32 && block_d == 256)
      return launch_bf16<64, 32, 256, true>(out_f32, bh, p, s);
    if (block_q == 64 && block_kv == 64 && block_d == 128)
      return launch_bf16<64, 64, 128, true>(out_f32, bh, p, s);
    return cudaErrorInvalidValue;
  }
  if (kernel != 0) return cudaErrorInvalidValue;
  if (block_q == 64 && block_kv == 64 && block_d == 64)
    return launch_bf16<64, 64, 64>(out_f32, bh, p, s);
  if (block_q == 64 && block_kv == 64 && block_d == 128)
    return launch_bf16<64, 64, 128>(out_f32, bh, p, s);
  if (block_q == 64 && block_kv == 32 && block_d == 256)
    return launch_bf16<64, 32, 256>(out_f32, bh, p, s);
  return cudaErrorInvalidValue;
}
