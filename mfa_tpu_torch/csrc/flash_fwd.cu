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
// (~1 us at 3.35 TB/s): the bound is operations. This first cut uses
// warp-level mma.sync (m16n8k16, bf16 -> fp32) from shared-memory tiles,
// four warps of 16 query rows each; wgmma, TMA and a pipelined K/V ring
// are later work. fp32 inputs take a plain-FMA kernel: the fp32 budget
// (2e-5) rules out TF32 tensor cores.

#include "common.cuh"

namespace {

using namespace mfa;

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
};

// Live kv blocks [lo, hi] of q-block i (hi < lo: none).
__device__ __forceinline__ void kv_range(const FwdParams& p, int i, int bq,
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

__device__ __forceinline__ bool visible(const FwdParams& p, int row,
                                        int col) {
  return visible_rc(row, col, p.R, p.C, p.causal, p.window);
}

// ---------------------------------------------------------------------------
// bf16 inputs: mma.sync kernel. BQ = 16 rows per warp.
// ---------------------------------------------------------------------------
template <int BQ, int BKV, int DP, bool OUT_F32>
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

  const int i = blockIdx.x, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int R = p.R, C = p.C, D = p.D;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + (size_t)bh * R * D;
  const size_t kvoff = (size_t)(bh / p.group) * C * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + kvoff;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + kvoff;
  const int row0 = i * BQ;

  // Q tile, pre-scaled by scale*log2e and rounded to bf16; zero padded.
  for (int idx = tid; idx < BQ * DP; idx += NT) {
    const int r = idx / DP, d = idx % DP;
    float x = 0.f;
    if (row0 + r < R && d < D)
      x = __bfloat162float(qg[(size_t)(row0 + r) * D + d]) * p.scale2;
    sQ[r * QS + d] = __float2bfloat16(x);
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
    __syncthreads();   // previous tiles consumed
    if (p.vec) {
      // K: consecutive threads take consecutive 8-wide chunks of a row.
      for (int c = tid; c < BKV * (DP / 8); c += NT) {
        const int r = c / (DP / 8), d0 = (c % (DP / 8)) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (col0 + r < C && d0 < D)
          val = *reinterpret_cast<const uint4*>(kg + (size_t)(col0 + r) * D + d0);
        *reinterpret_cast<uint4*>(sK + r * QS + d0) = val;
      }
      // V, transposed: consecutive threads take consecutive rows so the
      // scattered 2-byte shared stores stay conflict-free.
      for (int c = tid; c < BKV * (DP / 8); c += NT) {
        const int r = c % BKV, d0 = (c / BKV) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (col0 + r < C && d0 < D)
          val = *reinterpret_cast<const uint4*>(vg + (size_t)(col0 + r) * D + d0);
        const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
        for (int e = 0; e < 8; ++e) sVt[(d0 + e) * VS + r] = e8[e];
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

    // S = Q K^T for this warp's 16 rows.
    float s[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
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
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
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
        const int d = n * 8 + t4 * 2 + e;
        if (d >= D) continue;
        const float val = empty ? 0.f : o_acc[n][2 * h + e] / l_safe;
        const size_t at = ((size_t)bh * R + r) * D + d;
        if (OUT_F32)
          static_cast<float*>(p.o)[at] = val;
        else
          static_cast<__nv_bfloat16*>(p.o)[at] = __float2bfloat16(val);
      }
    if (t4 == 0)
      p.lse[(size_t)bh * R + r] =
          empty ? 0.f : (m_r[h] + log2f(l_safe)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// fp32 inputs: plain FMA. Four warps of BQ/4 rows; lane = kv column of the
// 32-wide tile for S, lane = head-dim column for O.
// ---------------------------------------------------------------------------
template <int BQ, int DP>
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

  const int i = blockIdx.x, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = p.R, C = p.C, D = p.D;
  const float* qg = static_cast<const float*>(p.q) + (size_t)bh * R * D;
  const size_t kvoff = (size_t)(bh / p.group) * C * D;
  const float* kg = static_cast<const float*>(p.k) + kvoff;
  const float* vg = static_cast<const float*>(p.v) + kvoff;
  const int row0 = i * BQ;

  for (int idx = tid; idx < BQ * DP; idx += 128) {
    const int r = idx / DP, d = idx % DP;
    sQ[idx] = (row0 + r < R && d < D) ? qg[(size_t)(row0 + r) * D + d] : 0.f;
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
      const float* kr = sK + lane * KS;
      float x = 0.f;
      for (int d = 0; d < DP; ++d) x = fmaf(qr[d], kr[d], x);
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
      const int d = lane + 32 * n;
      if (d < D)
        static_cast<float*>(p.o)[((size_t)bh * R + r) * D + d] =
            empty ? 0.f : o_acc[rr][n] / l_safe;
    }
    if (lane == 0)
      p.lse[(size_t)bh * R + r] =
          empty ? 0.f : (m_r[rr] + log2f(l_safe)) * kLn2;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int grid_x, int bh, int threads,
                   size_t smem, const FwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(grid_x, bh), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int BQ, int BKV, int DP>
cudaError_t launch_bf16(bool out_f32, int bh, const FwdParams& p,
                        cudaStream_t stream) {
  const size_t smem =
      sizeof(__nv_bfloat16) * (BQ * (DP + 8) + BKV * (DP + 8) + DP * (BKV + 8));
  const int grid_x = (p.R + BQ - 1) / BQ;
  if (out_f32)
    return launch(flash_fwd_bf16<BQ, BKV, DP, true>, grid_x, bh, BQ * 2, smem,
                  p, stream);
  return launch(flash_fwd_bf16<BQ, BKV, DP, false>, grid_x, bh, BQ * 2, smem,
                p, stream);
}

template <int BQ, int DP>
cudaError_t launch_f32(int bh, const FwdParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * DP + 2 * 32 * (DP + 1));
  return launch(flash_fwd_f32<BQ, DP>, (p.R + BQ - 1) / BQ, bh, 128, smem, p,
                stream);
}

}  // namespace

// dtype: 0 = fp32 in/out, 1 = bf16 in/out, 2 = bf16 in, fp32 out.
// (block_q, block_kv, block_d) must be a row of ops/params.py's tables.
extern "C" int mfa_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int group, int R,
                             int C, int D, int causal, int window,
                             float scale2, float cap2, int dtype, int block_q,
                             int block_kv, int block_d, void* stream) {
  FwdParams p{q, k, v, o, static_cast<float*>(lse), group, R, C, D,
              causal, window, scale2, cap2, 0};
  const uintptr_t ptr_or = reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v);
  p.vec = (D % 8 == 0) && (ptr_or % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (block_q == 16 && block_kv == 32) {
      if (block_d == 64) return launch_f32<16, 64>(bh, p, s);
      if (block_d == 128) return launch_f32<16, 128>(bh, p, s);
      if (block_d == 256) return launch_f32<16, 256>(bh, p, s);
    }
    return cudaErrorInvalidValue;
  }
  const bool out_f32 = dtype == 2;
  if (block_q == 64 && block_kv == 64 && block_d == 64)
    return launch_bf16<64, 64, 64>(out_f32, bh, p, s);
  if (block_q == 64 && block_kv == 64 && block_d == 128)
    return launch_bf16<64, 64, 128>(out_f32, bh, p, s);
  if (block_q == 64 && block_kv == 32 && block_d == 256)
    return launch_bf16<64, 32, 256>(out_f32, bh, p, s);
  return cudaErrorInvalidValue;
}
