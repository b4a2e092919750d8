// Fused decode attention + KV-cache append for Hopper (sm_90a).
//
// Replaces the TPU kernel mfa_tpu/kernels/decode.py::_decode_fused_kernel
// (built by build_decode_fused_append). One CTA per (batch, kv head): the
// G = Hq / Hkv query rows of the group stay together, so one pass over the
// cache's K rows and one over its V rows serve the whole group. Live rows
// are [max(0, len + 1 - W), len); the new token's column comes from the
// unquantized k_new / v_new. The cache is bf16, int8, fp8-e4m3 or
// fp8-e5m2 with per-token scales that multiply S and P, as on the TPU;
// fp8 is widened by Hopper's native conversion (exact, where the TPU
// bit-twiddle mapped subnormals to ~2^-7). The int8 path reproduces the
// TPU kernel's s8 requantization of q and P per row, with integer dot
// products.
//
// The new row is quantized exactly as quantize_int8 / quantize_fp8 do
// (scale = max(amax, 1e-8) * (1/127), * (1/448) for e4m3 or * (1/57344)
// for e5m2, as mfa_tpu keys fp8's maximum on the storage kind; int8
// rounds half to even and clips at +-127) and written with its scales at
// lengths[b]; nothing is written when lengths[b] == max_len. The cache is
// updated in place.
//
// Three passes over the live rows: (1) S into a global scratch row and the
// row max, (2) P = exp2(S - m), the row sum and, for int8, max |P * vs|,
// (3) O = P V. Scratch is G fp32 values per cache row, small next to a
// K row, and stays in L2 between passes. Passes 1 and 3 read the cache in
// 8-value chunks: D / 8 adjacent lanes share a row, each thread keeps
// kUnroll rows in flight, and coalesced 16-byte (bf16) or 8-byte loads
// cover whole rows.
//
// What bounds it on an H100: the bytes of the live K and V rows (bf16 at
// B = 4, Hkv = 8, 2048 rows, D = 128: ~34 MB per layer, ~10 us at
// 3.35 TB/s); its operations (4 G D flops per row) are ~100x below the
// ridge. This first cut keeps one CTA per (batch, kv head), so at small
// batch most SMs idle; splitting the rows over several CTAs with a second
// reduction pass is later work.

#include "common.cuh"

namespace {

using namespace mfa;

constexpr int kMaxG = 8;     // query rows per kv head
constexpr int kUnroll = 8;   // rows in flight per thread
// Scales are amax * (1 / qmax) with the reciprocal rounded to fp32, as
// mfa_tpu computes them under jax.jit (see kernels/quant.py).
constexpr float kInv127 = 1.0f / 127.0f;
constexpr float kInv448 = 1.0f / 448.0f;
constexpr float kInv57344 = 1.0f / 57344.0f;

struct DecodeParams {
  const void* q;        // [BH, G, D] pre-scaled by scale*log2e, q dtype
  void* k;              // [BH, L, D] storage type, updated in place
  void* v;
  float* k_scale;       // [BH, L]
  float* v_scale;
  const void* k_new;    // [BH, D] q dtype
  const void* v_new;
  const int* lengths;   // [B]
  void* o;              // [BH, G, D] q dtype
  float* scratch;       // [BH, G, L]
  int hkv, group, max_len, D, window;
  int q_bf16;
};

// Max of |x[0..D)| over the block (every thread gets the result).
__device__ float block_absmax(const float* x, int D, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  float a = 0.f;
  for (int d = tid; d < D; d += blockDim.x) a = fmaxf(a, fabsf(x[d]));
  a = warp_max(a);
  __syncthreads();
  if (lane == 0) red[warp] = a;
  __syncthreads();
  float r = 0.f;
  for (int w = 0; w < nw; ++w) r = fmaxf(r, red[w]);
  return r;
}

template <int KVF>
__device__ void append_row(const DecodeParams& p, const float* x, void* cache,
                           float* scales, size_t row, float* red) {
  const int D = p.D;
  float scale = 1.f;
  if (KVF != 0) {
    const float amax = block_absmax(x, D, red);
    scale = fmaxf(amax, 1e-8f) *
            (KVF == 1 ? kInv127 : KVF == 2 ? kInv448 : kInv57344);
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const size_t at = row * D + d;
    if constexpr (KVF == 0) {
      static_cast<__nv_bfloat16*>(cache)[at] = __float2bfloat16(x[d]);
    } else if constexpr (KVF == 1) {
      const float r = fminf(fmaxf(rintf(x[d] / scale), -127.f), 127.f);
      static_cast<int8_t*>(cache)[at] = static_cast<int8_t>(r);
    } else if constexpr (KVF == 2) {
      static_cast<__nv_fp8_e4m3*>(cache)[at] = __nv_fp8_e4m3(x[d] / scale);
    } else {
      static_cast<__nv_fp8_e5m2*>(cache)[at] = __nv_fp8_e5m2(x[d] / scale);
    }
  }
  if (threadIdx.x == 0) scales[row] = scale;
}

template <int KVF>
__global__ void __launch_bounds__(256)
decode_fused_append(DecodeParams p) {
  const int bh = blockIdx.x, b = bh / p.hkv;
  const int G = p.group, D = p.D, L = p.max_len;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  extern __shared__ __align__(16) float sm[];
  float* sq = sm;                    // [G][D]  q (int8 path: s8 values)
  float* skn = sq + G * D;           // [D]
  float* svn = skn + D;              // [D]
  float* red = svn + D;              // [nw][kMaxG]
  float* s_new = red + nw * kMaxG;   // [G]
  float* qsc = s_new + kMaxG;        // [G] q scales (int8)
  float* m_g = qsc + kMaxG;          // [G]
  float* l_g = m_g + kMaxG;          // [G]
  float* psc = l_g + kMaxG;          // [G] P scales (int8)
  float* sacc = psc + kMaxG;         // [RG][G][D]

  const int len = min(max(p.lengths[b], 0), L);
  const int lo = p.window > 0 ? max(0, len + 1 - p.window) : 0;
  const size_t qoff = (size_t)bh * G * D;
  for (int idx = tid; idx < G * D; idx += blockDim.x)
    sq[idx] = load_q(p.q, qoff + idx, p.q_bf16);
  for (int d = tid; d < D; d += blockDim.x) {
    skn[d] = load_q(p.k_new, (size_t)bh * D + d, p.q_bf16);
    svn[d] = load_q(p.v_new, (size_t)bh * D + d, p.q_bf16);
  }
  __syncthreads();

  // New token's score from the unquantized q and k_new; int8 q scales.
  for (int g = warp; g < G; g += nw) {
    float dot = 0.f, qa = 0.f;
    for (int d = lane; d < D; d += 32) {
      dot = fmaf(sq[g * D + d], skn[d], dot);
      qa = fmaxf(qa, fabsf(sq[g * D + d]));
    }
    dot = warp_sum(dot);
    qa = warp_max(qa);
    if (lane == 0) {
      s_new[g] = dot;
      qsc[g] = fmaxf(qa, 1e-30f) * kInv127;
    }
  }
  __syncthreads();
  if (KVF == 1) {
    for (int idx = tid; idx < G * D; idx += blockDim.x) {
      const float r = rintf(sq[idx] / qsc[idx / D]);
      sq[idx] = fminf(fmaxf(r, -127.f), 127.f);
    }
    __syncthreads();
  }

  const size_t kvrow0 = (size_t)bh * L;
  float* sc = p.scratch + (size_t)bh * G * L;

  // Row-group layout: a row of D values is CPR = D / 8 chunks of 8; lane
  // group rg (CPR adjacent lanes) takes rows lo + rg, lo + rg + RG, ...
  // and lane cc of the group one chunk of each. Each thread keeps its
  // chunk of q in registers and has kUnroll row loads in flight.
  const int CPR = D / 8, RG = blockDim.x / CPR;
  const int cc = tid % CPR, rg = tid / CPR;
  float qr[kMaxG][8];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) qr[g][e] = g < G ? sq[g * D + cc * 8 + e] : 0.f;

  // Pass 1: S over the live rows. Every thread runs the same iterations
  // (the shuffles need whole warps); rows past len are computed as zeros
  // and dropped.
  float mloc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) mloc[g] = kMaskValue;
  for (int base = lo; base < len; base += RG * kUnroll) {
    typename Chunk<KVF>::type raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + rg + u * RG;
      if (l < len) raw[u] = load_chunk<KVF>(p.k, (kvrow0 + l) * D + cc * 8);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + rg + u * RG;
      const bool valid = l < len;
      float x[8];
      if (valid) to_float8<KVF>(raw[u], x);
#pragma unroll
      for (int e = 0; e < 8; ++e) if (!valid) x[e] = 0.f;
      const float ks = valid ? p.k_scale[kvrow0 + l] : 0.f;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qr[g][e], x[e], dot);
        for (int o = CPR / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(kFull, dot, o);
        if (!valid) continue;
        float s;
        if constexpr (KVF == 1) s = dot * qsc[g] * ks;   // exact integer dot
        else if constexpr (KVF >= 2) s = dot * ks;
        else s = dot;
        mloc[g] = fmaxf(mloc[g], s);
        if (cc == 0) sc[(size_t)g * L + l] = s;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) mloc[g] = warp_max(mloc[g]);
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) red[warp * kMaxG + g] = mloc[g];
  __syncthreads();
  if (tid < G) {
    float m = s_new[tid];
    for (int w = 0; w < nw; ++w) m = fmaxf(m, red[w * kMaxG + tid]);
    m_g[tid] = m;
  }
  __syncthreads();

  // Pass 2: P, its row sum, and (int8) the P scale.
  for (int g = 0; g < G; ++g) {
    float sum = 0.f, pa = 0.f;
    const float m = m_g[g];
    for (int l = lo + tid; l < len; l += blockDim.x) {
      float pe = exp2f(sc[(size_t)g * L + l] - m);
      sum += pe;
      if (KVF != 0) {
        pe *= p.v_scale[kvrow0 + l];
        pa = fmaxf(pa, fabsf(pe));
      }
      sc[(size_t)g * L + l] = pe;
    }
    sum = warp_sum(sum);
    pa = warp_max(pa);
    __syncthreads();
    if (lane == 0) {
      red[warp * kMaxG] = sum;
      red[warp * kMaxG + 1] = pa;
    }
    __syncthreads();
    if (tid == 0) {
      float ts = 0.f, tp = 0.f;
      for (int w = 0; w < nw; ++w) {
        ts += red[w * kMaxG];
        tp = fmaxf(tp, red[w * kMaxG + 1]);
      }
      const float p_new = exp2f(s_new[g] - m);
      l_g[g] = fmaxf(ts + p_new, 1e-37f);
      psc[g] = fmaxf(tp, 1e-30f) * kInv127;
    }
  }
  __syncthreads();

  // Pass 3: O = P V in the same row-group layout, then a sum over the
  // row groups through shared memory.
  using Acc = typename std::conditional<KVF == 1, int, float>::type;
  Acc acc[kMaxG][8];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0;
  for (int base = lo; base < len; base += RG * kUnroll) {
    typename Chunk<KVF>::type raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + rg + u * RG;
      if (l < len) raw[u] = load_chunk<KVF>(p.v, (kvrow0 + l) * D + cc * 8);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + rg + u * RG;
      if (l >= len) continue;
      float x[8];
      to_float8<KVF>(raw[u], x);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float w = sc[(size_t)g * L + l];
        if constexpr (KVF == 1) {
          const int pq = static_cast<int>(
              fminf(fmaxf(rintf(w / psc[g]), -127.f), 127.f));
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] += pq * static_cast<int>(x[e]);
        } else {
          const float pw = p.q_bf16 ? bf16_round(w) : w;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pw, x[e], acc[g][e]);
        }
      }
    }
  }
  Acc* sacc_t = reinterpret_cast<Acc*>(sacc);   // [RG][G][D]
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      sacc_t[((size_t)rg * G + g) * D + cc * 8 + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    Acc tot = 0;
    for (int r = 0; r < RG; ++r) tot += sacc_t[(size_t)r * G * D + idx];
    const float p_new = exp2f(s_new[g] - m_g[g]);
    float o;
    if constexpr (KVF == 1)
      o = (static_cast<float>(tot) * psc[g] + p_new * svn[d]) / l_g[g];
    else
      o = (static_cast<float>(tot) + p_new * svn[d]) / l_g[g];
    const size_t at = qoff + idx;
    if (p.q_bf16)
      static_cast<__nv_bfloat16*>(p.o)[at] = __float2bfloat16(o);
    else
      static_cast<float*>(p.o)[at] = o;
  }

  // Append the new row at len (nothing once the slot is full).
  if (len < L) {
    append_row<KVF>(p, skn, p.k, p.k_scale, kvrow0 + len, red);
    append_row<KVF>(p, svn, p.v, p.v_scale, kvrow0 + len, red);
  }
}

}  // namespace

// q_bf16: 1 if q, k_new, v_new and o are bf16, 0 if fp32.
// kv_format: 0 bf16, 1 int8, 2 fp8-e4m3, 3 fp8-e5m2. group <= 8; D / 8 a power of
// two <= 32 (D in 8, 16, ..., 256); 16-byte aligned cache rows.
extern "C" int mfa_decode_fused_append(
    const void* q, void* k, void* v, void* k_scale, void* v_scale,
    const void* k_new, const void* v_new, const void* lengths, void* o,
    void* scratch, int bh, int hkv, int group, int max_len, int D, int window,
    int q_bf16, int kv_format, int threads, void* stream) {
  const int cpr = D / 8;
  if (group < 1 || group > kMaxG || D % 8 != 0 || cpr > 32 ||
      (cpr & (cpr - 1)) != 0 || threads % 32 != 0 || threads % cpr != 0 ||
      threads < 32 || threads > 256)
    return cudaErrorInvalidValue;
  DecodeParams p{q, k, v, static_cast<float*>(k_scale),
                 static_cast<float*>(v_scale), k_new, v_new,
                 static_cast<const int*>(lengths), o,
                 static_cast<float*>(scratch), hkv, group, max_len, D,
                 window, q_bf16};
  const int nw = threads / 32;
  const size_t smem = sizeof(float) * ((size_t)group * D + 2 * D +
                                       nw * kMaxG + 5 * kMaxG +
                                       (size_t)(threads / cpr) * group * D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kernel)(DecodeParams) = nullptr;
  if (kv_format == 0) kernel = decode_fused_append<0>;
  else if (kv_format == 1) kernel = decode_fused_append<1>;
  else if (kv_format == 2) kernel = decode_fused_append<2>;
  else if (kv_format == 3) kernel = decode_fused_append<3>;
  else return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<bh, threads, smem, s>>>(p);
  return cudaGetLastError();
}
