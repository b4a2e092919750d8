// One-token GQA decode attention over a KV cache, read directly (K5) or
// through page tables (K6), for Hopper (sm_90a).
//
// K5 `mfa_decode_attend` replaces the TPU kernels
// mfa_tpu/kernels/decode.py::_decode_kernel_single and ::_decode_kernel
// (built by build_decode): decode over a contiguous cache [BH, L, D].
// K6 `mfa_paged_decode` replaces
// mfa_tpu/kernels/paged_decode.py::_paged_decode_kernel (built by
// build_paged_decode): decode over a page pool [P, Hkv, page, D] whose
// pages each sequence names in its row of a page table.
//
// One templated body serves both. A row-address functor turns (sequence,
// kv head, position) into a cache row: position l of the contiguous cache,
// or row l % page of page tables[b][l / page]. The CTA reads its own
// page-table row from device memory as it goes (the TPU kernel's scalar
// prefetch has no counterpart), and only for live positions: rows past the
// length or before the window, and so the pages that hold only such rows,
// are never touched. Table entries past the live pages (0, the null page)
// are never read as data.
//
// Live rows are [max(0, len - W), len). One rounding rule for every
// storage type (bf16, int8, fp8-e4m3, fp8-e5m2) and every length:
// S = q . K_raw, then times the per-token K scale; P = exp2(S - max);
// P times the per-token V scale, rounded to q's type, before P V; the
// row sum is of the unscaled P. This is _decode_kernel's and
// _paged_decode_kernel's arithmetic with the scales folded into S and P,
// without _decode_kernel_single's int8 requantization of q and P (a v5e
// workaround: Hopper converts int8 and fp8 natively). q arrives
// pre-scaled by scale * log2e. A sequence with no live row gets O = 0.
//
// Layout: one CTA per (sequence, kv head) and chunk of up to kMaxG query
// rows (grid.y > 1 only for groups above 8). Two passes over the live
// rows, in the row-group layout of the fused decode kernel: D / 8
// adjacent lanes share a cache row, each reading one 8-value chunk (a
// 16-byte load for bf16, 8 bytes for int8 and fp8), and each thread keeps
// kUnroll rows in flight. Pass 1 computes S into a global scratch row
// (G fp32 values per cache row, small beside a K row, L2-resident) and the
// row max; pass 2 computes P against that final max, its row sum, and
// O = P V; the row groups' partial O and sums meet in shared memory. With
// one CTA of 8 warps on an SM, latency is what such a kernel must hide:
// each pass issues a tile's loads (K, or V with its scores) together, and
// pass 1 interleaves the tile's shuffle reductions.
// Taking the final max first (rather than an online softmax) rounds P at
// the same points as the plain version, which keeps the kernel within the
// fused decode kernel's budget against it.
//
// What bounds it on an H100: the bytes of the live K and V rows (bf16 at
// 4 sequences, Hkv = 8, 2048 rows, D = 128: ~34 MB, ~10 us at 3.35 TB/s);
// its operations (4 G D flops per row) are ~100x below the ridge. This
// first cut keeps one CTA per (sequence, kv head), so at a few sequences
// most of the 132 SMs idle; splitting the rows over several CTAs with a
// combining pass, and TMA page gathers, are later work.

#include "common.cuh"

namespace {

using namespace mfa;

constexpr int kMaxG = 8;     // query rows a CTA keeps in registers
constexpr int kUnroll = 8;   // rows in flight per thread

struct AttendParams {
  const void* q;          // [N, G, D] pre-scaled by scale*log2e, q dtype
  const void* k;          // cache rows (storage type), D values each
  const void* v;
  const float* k_scale;   // one per cache row
  const float* v_scale;
  const int* lengths;     // [sequences]
  void* o;                // [N, G, D] q dtype
  float* scratch;         // [N, G, capacity]
  int hkv, group, D, window, q_bf16;
};

// K5: row l of (batch, head) bh in [BH, L, D].
struct ContiguousRows {
  int max_len;
  __device__ __forceinline__ int capacity() const { return max_len; }
  __device__ __forceinline__ size_t operator()(int bh, int, int,
                                               int l) const {
    return (size_t)bh * max_len + l;
  }
};

// K6: row l % page of page tables[b][l / page] in [P, Hkv, page, D].
struct PagedRows {
  const int* tables;      // [sequences, max_pages]
  int max_pages, page_size, hkv;
  __device__ __forceinline__ int capacity() const {
    return max_pages * page_size;
  }
  __device__ __forceinline__ size_t operator()(int, int b, int h,
                                               int l) const {
    const int page = __ldg(tables + (size_t)b * max_pages + l / page_size);
    return ((size_t)page * hkv + h) * page_size + l % page_size;
  }
};

template <int KVF, class Rows>
__global__ void __launch_bounds__(256)
decode_attend(AttendParams p, Rows rows) {
  constexpr bool kQuant = KVF != 0;
  const int bh = blockIdx.x, b = bh / p.hkv, h = bh - b * p.hkv;
  const int g0 = blockIdx.y * kMaxG;
  const int G = min(kMaxG, p.group - g0), D = p.D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  // Row-group layout: lane group rg (CPR adjacent lanes) takes rows
  // lo + rg, lo + rg + RG, ...; lane cc of the group one chunk of each.
  const int CPR = D / 8, RG = blockDim.x / CPR;
  const int cc = tid % CPR, rg = tid / CPR;
  extern __shared__ __align__(16) float sm[];
  float* red = sm;                   // [nw][kMaxG] row max per warp
  float* m_g = red + nw * kMaxG;     // [kMaxG] row max
  float* l_g = m_g + kMaxG;          // [kMaxG] row sum
  float* sl = l_g + kMaxG;           // [RG][kMaxG] row sums per row group
  float* sacc = sl + RG * kMaxG;     // [RG][G][D] partial O per row group

  const int cap = rows.capacity();
  const int len = min(max(p.lengths[b], 0), cap);
  const int lo = p.window > 0 ? max(0, len - p.window) : 0;
  const size_t qrow0 = (size_t)bh * p.group + g0;
  float* sc = p.scratch + qrow0 * cap;            // [G][cap]

  float qr[kMaxG][8];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qr[g][e] = g < G ? load_q(p.q, (qrow0 + g) * D + cc * 8 + e, p.q_bf16)
                       : 0.f;

  // Pass 1: S = (q . K_raw) * ks over the live rows, and the row max.
  // Every thread runs the same iterations (the shuffles need whole warps);
  // rows past len are computed as zeros and dropped.
  float mloc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) mloc[g] = kMaskValue;
  for (int base = lo; base < len; base += RG * kUnroll) {
    typename Chunk<KVF>::type raw[kUnroll];
    float ks[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + rg + u * RG;
      if (l < len) {
        const size_t r = rows(bh, b, h, l);
        raw[u] = load_chunk<KVF>(p.k, r * D + cc * 8);
        ks[u] = kQuant ? p.k_scale[r] : 1.f;
      }
    }
    // Each lane's part of every (row, query row) dot product (qr is 0
    // past G), then the sums over the row's CPR lanes with all the
    // tile's shuffle chains interleaved.
    float dot[kUnroll][kMaxG];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float x[8];
      if (base + rg + u * RG < len) {
        to_float8<KVF>(raw[u], x);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        dot[u][g] = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dot[u][g] = fmaf(qr[g][e], x[e], dot[u][g]);
      }
    }
    for (int o = CPR / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          dot[u][g] += __shfl_xor_sync(kFull, dot[u][g], o);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + rg + u * RG;
      if (l >= len) continue;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float s = kQuant ? dot[u][g] * ks[u] : dot[u][g];
        mloc[g] = fmaxf(mloc[g], s);
        if (cc == 0) sc[(size_t)g * cap + l] = s;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) mloc[g] = warp_max(mloc[g]);
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) red[warp * kMaxG + g] = mloc[g];
  __syncthreads();
  if (tid < G) {
    float m = kMaskValue;
    for (int w = 0; w < nw; ++w) m = fmaxf(m, red[w * kMaxG + tid]);
    m_g[tid] = m;
  }
  __syncthreads();

  // Pass 2: P = exp2(S - m), its row sum, and O = round(P * vs) V, in the
  // same row-group layout (each row goes to the row group that scored it,
  // so a lane group reads back the scratch values its own lane 0 wrote).
  float acc[kMaxG][8], lsum[kMaxG], m_r[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    lsum[g] = 0.f;
    m_r[g] = g < G ? m_g[g] : 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }
  for (int base = lo; base < len; base += RG * kUnroll) {
    // The tile's V chunks, V scales and scores all load together.
    typename Chunk<KVF>::type raw[kUnroll];
    float vs[kUnroll], sv[kUnroll][kMaxG];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + rg + u * RG;
      if (l < len) {
        const size_t r = rows(bh, b, h, l);
        raw[u] = load_chunk<KVF>(p.v, r * D + cc * 8);
        vs[u] = kQuant ? p.v_scale[r] : 1.f;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g >= G) break;
          sv[u][g] = sc[(size_t)g * cap + l];
        }
      }
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
        const float pe = exp2f(sv[u][g] - m_r[g]);
        lsum[g] += pe;
        float pw = kQuant ? pe * vs[u] : pe;
        if (p.q_bf16) pw = bf16_round(pw);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pw, x[e], acc[g][e]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (cc == 0) sl[rg * kMaxG + g] = lsum[g];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      sacc[((size_t)rg * G + g) * D + cc * 8 + e] = acc[g][e];
  }
  __syncthreads();
  if (tid < G) {
    float tot = 0.f;
    for (int r = 0; r < RG; ++r) tot += sl[r * kMaxG + tid];
    l_g[tid] = fmaxf(tot, 1e-37f);
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    float tot = 0.f;
    for (int r = 0; r < RG; ++r) tot += sacc[(size_t)r * G * D + idx];
    // No live row: the max is still the sentinel; the output is inert.
    const float o = m_g[g] == kMaskValue ? 0.f : tot / l_g[g];
    const size_t at = qrow0 * D + idx;
    if (p.q_bf16)
      static_cast<__nv_bfloat16*>(p.o)[at] = __float2bfloat16(o);
    else
      static_cast<float*>(p.o)[at] = o;
  }
}

// Checks the launch shape, picks the storage format's instance, sets its
// shared memory and launches on the caller's stream.
template <class Rows>
int launch(const AttendParams& p, const Rows& rows, int n, int kv_format,
           int threads, void* stream) {
  const int cpr = p.D / 8;
  if (p.group < 1 || p.hkv < 1 || n % p.hkv != 0 || p.D % 8 != 0 ||
      cpr > 32 || (cpr & (cpr - 1)) != 0 || threads % 32 != 0 ||
      threads % cpr != 0 || threads < 32 || threads > 256)
    return cudaErrorInvalidValue;
  void (*kernel)(AttendParams, Rows) = nullptr;
  if (kv_format == 0) kernel = decode_attend<0, Rows>;
  else if (kv_format == 1) kernel = decode_attend<1, Rows>;
  else if (kv_format == 2) kernel = decode_attend<2, Rows>;
  else if (kv_format == 3) kernel = decode_attend<3, Rows>;
  else return cudaErrorInvalidValue;
  const int g_chunk = p.group < kMaxG ? p.group : kMaxG;
  const int rg = threads / cpr;
  const size_t smem = sizeof(float) * ((size_t)(threads / 32) * kMaxG +
                                       2 * kMaxG + (size_t)rg * kMaxG +
                                       (size_t)rg * g_chunk * p.D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n, (p.group + kMaxG - 1) / kMaxG);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p,
                                                                      rows);
  return cudaGetLastError();
}

}  // namespace

// K5. q, o: [bh, group, D] (q_bf16: bf16, else fp32); k, v: [bh, max_len,
// D] storage (kv_format: 0 bf16, 1 int8, 2 fp8-e4m3, 3 fp8-e5m2); scales
// [bh, max_len] fp32; lengths [bh / hkv] int32; scratch [bh, group,
// max_len] fp32. D / 8 a power of two <= 32; 16-byte aligned cache rows.
extern "C" int mfa_decode_attend(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, void* o, void* scratch, int bh,
    int hkv, int group, int max_len, int D, int window, int q_bf16,
    int kv_format, int threads, void* stream) {
  const AttendParams p{q, k, v, static_cast<const float*>(k_scale),
                       static_cast<const float*>(v_scale),
                       static_cast<const int*>(lengths), o,
                       static_cast<float*>(scratch), hkv, group, D, window,
                       q_bf16};
  return launch(p, ContiguousRows{max_len}, bh, kv_format, threads, stream);
}

// K6. q, o: [n = sequences * hkv, group, D]; k, v pages: [num_pages, hkv,
// page_size, D] storage; scales [num_pages, hkv, page_size] fp32; tables
// [sequences, max_pages] int32; lengths [sequences] int32; scratch [n,
// group, max_pages * page_size] fp32. Otherwise as K5.
extern "C" int mfa_paged_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* o, void* scratch, int n, int hkv, int group,
    int max_pages, int page_size, int D, int window, int q_bf16,
    int kv_format, int threads, void* stream) {
  if (max_pages < 1 || page_size < 1) return cudaErrorInvalidValue;
  const AttendParams p{q, k_pages, v_pages,
                       static_cast<const float*>(k_scale),
                       static_cast<const float*>(v_scale),
                       static_cast<const int*>(lengths), o,
                       static_cast<float*>(scratch), hkv, group, D, window,
                       q_bf16};
  return launch(p,
                PagedRows{static_cast<const int*>(tables), max_pages,
                          page_size, hkv},
                n, kv_format, threads, stream);
}
