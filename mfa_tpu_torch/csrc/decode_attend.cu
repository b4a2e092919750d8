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
// or row l % page of page tables[b][l / page]. Only live positions are
// read: rows past the length or before the window, and so the pages that
// hold only such rows, are never touched. Table entries past the live
// pages (0, the null page) are never read as data.
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
// What bounds it on an H100: the bytes of the live K and V rows (bf16 at
// 4 sequences of up to 8192 rows, Hkv = 8, D = 128: ~70 MB, ~21 us at
// 3.35 TB/s); its operations (4 G D flops a row) are ~100x below the
// ridge. So the whole card has to be reading: every SM needs many loads
// in flight, even when a few sequences are decoded.
//
// Split-KV layout. The grid is (sequence x kv head, chunk of up to GC
// query rows, split): split s takes positions [s R, (s + 1) R) of the live
// rows, R a power of two that the host chooses from the shapes alone
// (ops/params.py::decode_split_rows), so that a few sequences still give
// the card a few CTAs per SM. Two kernels a call, in stream order:
//  1. decode_score: S for the split's rows into a global scratch row (GC
//     fp32 values per cache row, small beside a K row, L2-resident) and
//     the split's row max into m_part.
//  2. decode_attend: the row max over the live splits' maxes (exact in any
//     order), then P = exp2(S - max) against that final max, its sum and
//     O = round(P vs) V over the split's rows; each split writes its
//     partial O and sum, and the last split of a (sequence, kv head,
//     chunk) to arrive (an integer counter, zeroed by decode_score) sums
//     the live splits' partials in split order and writes O.
// Taking the final max first (rather than an online softmax per split)
// rounds P at the same points as the plain version, which keeps the
// kernel within the fused decode kernel's budget against it. Splits with
// no live row exit at once. Nothing is summed with atomics, so O is
// deterministic and K6 equals K5 bit for bit on the same rows.
//
// Inside a CTA: D / 8 adjacent lanes share a cache row, each taking one
// 8-value chunk (16 bytes of bf16, 8 of int8 and fp8); a tile is kUnroll
// rows a lane group. The tiles stream through a ring of kStages in shared
// memory by cp.async, two in flight while a third is used: each thread
// copies its own chunks, and a lane group's first lane the row's scale
// and scores; a warp reads only rows its own lanes copied, after a warp
// barrier, so no CTA barrier sits in the loop. In K6 a split reads the
// page ids its rows need into shared memory once.
//
// Two arithmetic paths, chosen by the launch (K5 and K6 alike):
//  - bf16 q over a bf16 cache, D = 64 or 128 (the served shapes): tensor
//    cores. A warp takes S^T = K q^T and O^T = V^T P^T for its 16 or 32
//    rows with mma.sync m16n8k16 (K and V by ldmatrix from the ring, its
//    chunks swizzled so that ldmatrix reads no bank twice; q^T and P^T in
//    registers, the query rows padded to 8). Products are exact and sums
//    fp32, as in the FMA path; P is rounded to bf16 against the final max.
//    The FMA path spent ~40 instructions a row per warp on dot products,
//    their 16-lane shuffle sums and one exp2 per lane: issue, not bytes,
//    bounded it (int8 caches, half the bytes, took as long as bf16).
//  - everything else (fp32 q, int8 and fp8 caches, other head dims): FMA,
//    the row's 8-value chunks summed over its lanes by shuffles.
// Row groups and warps meet in a fixed order. TMA page gathers and fusing
// the append are later work.

#include "common.cuh"

namespace {

using namespace mfa;

constexpr int kUnroll = 8;   // rows of a tile a lane group takes
constexpr int kStages = 3;   // tiles in the ring: two in flight, one used

struct AttendParams {
  const void* q;          // [N, group, D] pre-scaled by scale*log2e, q dtype
  const void* k;          // cache rows (storage type), D values each
  const void* v;
  const float* k_scale;   // one per cache row
  const float* v_scale;
  const int* lengths;     // [sequences]
  void* o;                // [N, group, D] q dtype
  float* scratch;         // [N, chunks, capacity, GC] scores
  float* m_part;          // [N, group, splits] row max of each split
  float* l_part;          // [N, group, splits] row sum of each split
  float* o_part;          // [N, group, splits, D] partial O of each split
  int* arrived;           // [N, chunks] splits done (decode_score zeroes)
  int hkv, group, D, window, q_bf16, split_rows, splits;
};

// K5: row l of (batch, head) bh in [BH, L, D].
struct ContiguousRows {
  int max_len;
  __host__ __device__ int capacity() const { return max_len; }
  __host__ __device__ int table_ints(int) const { return 0; }
  __device__ void bind(int*, int, int, int) {}
  __device__ __forceinline__ size_t operator()(int bh, int, int l) const {
    return (size_t)bh * max_len + l;
  }
};

// K6: row l % page of page tables[b][l / page] in [P, Hkv, page, D].
struct PagedRows {
  const int* tables;      // [sequences, max_pages]
  int max_pages, page_size, hkv;
  const int* ids;         // the split's page ids, in shared memory
  int first_page;
  __host__ __device__ int capacity() const {
    return max_pages * page_size;
  }
  // Page ids a split of `rows` consecutive positions can touch.
  __host__ __device__ int table_ints(int rows) const {
    return rows / page_size + 2;
  }
  // Reads the page ids of positions [lo, hi) of sequence b into shared
  // memory (each once); the caller syncs before the first row.
  __device__ void bind(int* smem, int b, int lo, int hi) {
    first_page = lo / page_size;
    const int n = (hi - 1) / page_size - first_page + 1;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      smem[i] = __ldg(tables + (size_t)b * max_pages + first_page + i);
    ids = smem;
  }
  __device__ __forceinline__ size_t operator()(int, int h, int l) const {
    const int page = ids[l / page_size - first_page];
    return ((size_t)page * hkv + h) * page_size + l % page_size;
  }
};

// The live rows [lo, len) of sequence b, its live splits [first, last]
// (none: last < first) and split s's rows [s_lo, s_hi).
struct Split {
  int len, lo, first, last, s_lo, s_hi;
};

__device__ __forceinline__ Split split_of(const AttendParams& p, int cap,
                                          int b, int s) {
  Split t;
  t.len = min(max(p.lengths[b], 0), cap);
  t.lo = p.window > 0 ? max(0, t.len - p.window) : 0;
  t.first = t.lo / p.split_rows;
  t.last = t.len > t.lo ? (t.len - 1) / p.split_rows : t.first - 1;
  t.s_lo = max(t.lo, s * p.split_rows);
  t.s_hi = min(t.len, (s + 1) * p.split_rows);
  return t;
}

__device__ __forceinline__ void store_o(const AttendParams& p, size_t at,
                                        float o) {
  if (p.q_bf16)
    static_cast<__nv_bfloat16*>(p.o)[at] = __float2bfloat16(o);
  else
    static_cast<float*>(p.o)[at] = o;
}

// The ring of kStages tiles in shared memory, for `threads` threads and
// rg row groups: each thread's chunks [kStages][kUnroll][threads], then
// (scores) each row's GC scores [kStages][kUnroll][rg][GC], then each
// row's scale [kStages][kUnroll][rg]. Every part is 16-byte aligned.
template <int KVF, int GC>
struct Ring {
  using C = typename Chunk<KVF>::type;
  C* chunk;
  float* score;
  float* scale;

  __host__ __device__ static size_t bytes(int threads, int rg, bool scores) {
    return (size_t)kStages * kUnroll *
           ((size_t)threads * sizeof(C) + (scores ? rg * GC * 4 : 0) +
            rg * 4);
  }
  __device__ Ring(void* base, int threads, int rg, bool scores) {
    char* b = static_cast<char*>(base);
    chunk = reinterpret_cast<C*>(b);
    b += (size_t)kStages * kUnroll * threads * sizeof(C);
    score = reinterpret_cast<float*>(b);
    b += scores ? (size_t)kStages * kUnroll * rg * GC * 4 : 0;
    scale = reinterpret_cast<float*>(b);
  }
};

// The shared memory of the attend pass: the ring, which the warps' partial
// O [nw][GC][D] reuses after the loop, then the row max [GC], the row sums
// [nw][GC], the last-to-arrive flag and the page ids.
template <int KVF, int GC>
__host__ __device__ size_t attend_union_bytes(int threads, int D) {
  const size_t ring = Ring<KVF, GC>::bytes(threads, threads / (D / 8), true);
  const size_t o_w = (size_t)(threads / 32) * GC * D * 4;
  return ring > o_w ? ring : o_w;
}

// End of pass 1: the split's row max over the warps' maxes red [nw][GC]
// (written before a barrier) into m_part.
template <int GC>
__device__ __forceinline__ void put_split_max(const AttendParams& p,
                                              const float* red,
                                              size_t qrow0, int s, int G) {
  const int tid = threadIdx.x, nw = blockDim.x >> 5;
  if (tid < G) {
    float m = kMaskValue;
    for (int w = 0; w < nw; ++w) m = fmaxf(m, red[w * GC + tid]);
    p.m_part[(qrow0 + tid) * p.splits + s] = m;
  }
}

// Start of pass 2: the row max over the live splits' maxes (exact in any
// order) into m_g [G], one warp a query row; the caller syncs.
__device__ __forceinline__ void final_max(const AttendParams& p,
                                          const Split& t, size_t qrow0,
                                          int G, float* m_g) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int g = threadIdx.x >> 5; g < G; g += nw) {
    float m = kMaskValue;
    for (int j = t.first + lane; j <= t.last; j += 32)
      m = fmaxf(m, p.m_part[(qrow0 + g) * p.splits + j]);
    m = warp_max(m);
    if (lane == 0) m_g[g] = m;
  }
}

// End of pass 2, from the warps' partial O o_w [nw][GC][D] and row sums
// l_w [nw][GC] (written before a barrier): the only live split writes O
// at once; otherwise the split writes its partials, counts itself in, and
// the last to arrive sums the live splits' partials in split order and
// writes O. A max still at the sentinel saw no score: its O is 0.
template <int GC>
__device__ void finish_attend(const AttendParams& p, const Split& t,
                              const float* m_g, float* l_w, const float* o_w,
                              int* last, size_t qrow0, int s, int G) {
  const int tid = threadIdx.x, nw = blockDim.x >> 5, D = p.D;
  if (t.first == t.last) {
    for (int idx = tid; idx < G * D; idx += blockDim.x) {
      const int g = idx / D, d = idx - g * D;
      float tot = 0.f, l = 0.f;
      for (int w = 0; w < nw; ++w) {
        tot += o_w[((size_t)w * GC + g) * D + d];
        l += l_w[w * GC + g];
      }
      store_o(p, qrow0 * D + idx,
              m_g[g] == kMaskValue ? 0.f : tot / fmaxf(l, 1e-37f));
    }
    return;
  }
  for (int idx = tid; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx - g * D;
    float tot = 0.f;
    for (int w = 0; w < nw; ++w) tot += o_w[((size_t)w * GC + g) * D + d];
    p.o_part[((qrow0 + g) * p.splits + s) * D + d] = tot;
  }
  if (tid < G) {
    float l = 0.f;
    for (int w = 0; w < nw; ++w) l += l_w[w * GC + tid];
    p.l_part[(qrow0 + tid) * p.splits + s] = l;
  }
  // Publish the partials, then count this split in.
  __threadfence();
  __syncthreads();
  if (tid == 0)
    *last = atomicAdd(p.arrived + blockIdx.x * gridDim.y + blockIdx.y, 1) ==
            t.last - t.first;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  if (tid < G) {
    float l = 0.f;
    for (int j = t.first; j <= t.last; ++j)
      l += __ldcg(p.l_part + (qrow0 + tid) * p.splits + j);
    l_w[tid] = fmaxf(l, 1e-37f);
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx - g * D;
    const float* part = p.o_part + (qrow0 + g) * p.splits * D + d;
    // Eight partials in flight at a time, summed in split order.
    float tot = 0.f;
    int j = t.first;
    for (; j + 8 <= t.last + 1; j += 8) {
      float x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = __ldcg(part + (size_t)(j + k) * D);
#pragma unroll
      for (int k = 0; k < 8; ++k) tot += x[k];
    }
    for (; j <= t.last; ++j) tot += __ldcg(part + (size_t)j * D);
    store_o(p, qrow0 * D + idx, m_g[g] == kMaskValue ? 0.f : tot / l_w[g]);
  }
}

// Pass 1: S = (q . K_raw) * ks over the split's rows into the scratch row,
// and the split's row max into m_part.
template <int KVF, int GC, class Rows>
__global__ void __launch_bounds__(256)
decode_score(AttendParams p, Rows rows) {
  constexpr bool kQuant = KVF != 0;
  using C = typename Chunk<KVF>::type;
  const int bh = blockIdx.x, b = bh / p.hkv, h = bh - b * p.hkv;
  const int g0 = blockIdx.y * GC, G = min(GC, p.group - g0), s = blockIdx.z;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, nw = T >> 5, D = p.D;
  // Row-group layout: lane group rg (CPR adjacent lanes) takes rows
  // base + rg, base + rg + RG, ... of a tile; lane cc one chunk of each.
  const int CPR = D / 8, RG = T / CPR, TR = RG * kUnroll;
  const int cc = tid % CPR, rg = tid / CPR;
  extern __shared__ __align__(16) unsigned char smem[];
  const Ring<KVF, GC> ring(smem, T, RG, false);
  float* red = reinterpret_cast<float*>(
      smem + Ring<KVF, GC>::bytes(T, RG, false));   // [nw][GC]
  int* ids = reinterpret_cast<int*>(red + nw * GC);  // page ids

  griddep_launch_dependents();           // decode_attend may start its V
  const int cap = rows.capacity();
  const Split t = split_of(p, cap, b, s);
  if (s == 0 && tid == 0) p.arrived[bh * gridDim.y + blockIdx.y] = 0;
  if (t.s_lo >= t.s_hi) return;
  Rows at = rows;
  at.bind(ids, b, t.s_lo, t.s_hi);
  __syncthreads();
  const size_t qrow0 = (size_t)bh * p.group + g0;
  float* sc = p.scratch + ((size_t)bh * gridDim.y + blockIdx.y) * cap * GC;
  const int ntiles = (t.s_hi - t.s_lo + TR - 1) / TR;
  const char* kb = static_cast<const char*>(p.k);

  // Tile i's K chunks (and scales) into ring stage i % kStages; one
  // commit group a tile, empty past the last.
  auto issue = [&](int i) {
    if (i < ntiles) {
      const int base = t.s_lo + i * TR, st = i % kStages;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int l = base + rg + u * RG;
        if (l < t.s_hi) {
          const size_t r = at(bh, h, l);
          cp_async<sizeof(C)>(ring.chunk + (st * kUnroll + u) * T + tid,
                              kb + (r * D + cc * 8) * sizeof(C) / 8);
          if (kQuant && cc == 0)
            cp_async<4>(ring.scale + (st * kUnroll + u) * RG + rg,
                        p.k_scale + r);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  float qr[GC][8];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qr[g][e] = g < G ? load_q(p.q, (qrow0 + g) * D + cc * 8 + e, p.q_bf16)
                       : 0.f;

  // Every thread runs the same iterations (the shuffles need whole warps);
  // rows past the split are computed as zeros and dropped.
  float mloc[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) mloc[g] = kMaskValue;
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncwarp();
    issue(i + kStages - 1);
    const int base = t.s_lo + i * TR, st = i % kStages;
    // Each lane's part of every (row, query row) dot product (qr is 0
    // past G), then the sums over the row's CPR lanes with all the
    // tile's shuffle chains interleaved.
    float dot[kUnroll][GC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float x[8];
      if (base + rg + u * RG < t.s_hi) {
        to_float8<KVF>(ring.chunk[(st * kUnroll + u) * T + tid], x);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        dot[u][g] = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dot[u][g] = fmaf(qr[g][e], x[e], dot[u][g]);
      }
    }
    for (int o = CPR / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          dot[u][g] += __shfl_xor_sync(kFull, dot[u][g], o);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + rg + u * RG;
      if (l >= t.s_hi) continue;
      const float ks =
          kQuant ? ring.scale[(st * kUnroll + u) * RG + rg] : 1.f;
      float sv[GC];
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        sv[g] = kQuant ? dot[u][g] * ks : dot[u][g];
        if (g < G) mloc[g] = fmaxf(mloc[g], sv[g]);
      }
      if (cc == 0)
#pragma unroll
        for (int g = 0; g < GC; g += 4)
          *reinterpret_cast<float4*>(sc + (size_t)l * GC + g) =
              make_float4(sv[g], sv[g + 1], sv[g + 2], sv[g + 3]);
    }
  }
#pragma unroll
  for (int g = 0; g < GC; ++g) mloc[g] = warp_max(mloc[g]);
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GC; ++g) red[warp * GC + g] = mloc[g];
  __syncthreads();
  put_split_max<GC>(p, red, qrow0, s, G);
}

// Pass 2: the final row max, then P = exp2(S - m), its row sum and
// O = round(P * vs) V over the split's rows, in pass 1's row-group layout;
// then the partials of the live splits meet in split order.
template <int KVF, int GC, class Rows>
__global__ void __launch_bounds__(256)
decode_attend(AttendParams p, Rows rows) {
  constexpr bool kQuant = KVF != 0;
  using C = typename Chunk<KVF>::type;
  const int bh = blockIdx.x, b = bh / p.hkv, h = bh - b * p.hkv;
  const int g0 = blockIdx.y * GC, G = min(GC, p.group - g0), s = blockIdx.z;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, nw = T >> 5, D = p.D;
  const int CPR = D / 8, RG = T / CPR, TR = RG * kUnroll;
  const int cc = tid % CPR, rg = tid / CPR;
  extern __shared__ __align__(16) unsigned char smem[];
  const Ring<KVF, GC> ring(smem, T, RG, true);
  float* o_w = reinterpret_cast<float*>(smem);  // [nw][GC][D], after the loop
  float* m_g = reinterpret_cast<float*>(
      smem + attend_union_bytes<KVF, GC>(T, D));  // [GC] row max
  float* l_w = m_g + GC;                          // [nw][GC] row sums
  int* last = reinterpret_cast<int*>(l_w + nw * GC);
  int* ids = last + 1;                            // page ids

  const int cap = rows.capacity();
  const Split t = split_of(p, cap, b, s);
  const size_t qrow0 = (size_t)bh * p.group + g0;
  if (t.last < t.first) {                // no live row: O = 0, by split 0
    if (s == 0)
      for (int idx = tid; idx < G * D; idx += blockDim.x)
        store_o(p, qrow0 * D + idx, 0.f);
    return;
  }
  if (t.s_lo >= t.s_hi) return;
  Rows at = rows;
  at.bind(ids, b, t.s_lo, t.s_hi);
  __syncthreads();
  const float* sc =
      p.scratch + ((size_t)bh * gridDim.y + blockIdx.y) * cap * GC;
  const int ntiles = (t.s_hi - t.s_lo + TR - 1) / TR;
  const char* vb = static_cast<const char*>(p.v);

  // Tile i's V chunks and scales (issue_v), and each row's scores
  // (issue_s, written by decode_score), into ring stage i % kStages.
  auto issue_v = [&](int i) {
    if (i >= ntiles) return;
    const int base = t.s_lo + i * TR, st = i % kStages;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + rg + u * RG;
      if (l < t.s_hi) {
        const size_t r = at(bh, h, l);
        cp_async<sizeof(C)>(ring.chunk + (st * kUnroll + u) * T + tid,
                            vb + (r * D + cc * 8) * sizeof(C) / 8);
        if (kQuant && cc == 0)
          cp_async<4>(ring.scale + (st * kUnroll + u) * RG + rg,
                      p.v_scale + r);
      }
    }
  };
  auto issue_s = [&](int i) {
    if (i >= ntiles || cc != 0) return;
    const int base = t.s_lo + i * TR, st = i % kStages;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + rg + u * RG;
      if (l < t.s_hi)
#pragma unroll
        for (int g = 0; g < GC; g += 4)
          cp_async<16>(ring.score + ((st * kUnroll + u) * RG + rg) * GC + g,
                       sc + (size_t)l * GC + g);
    }
  };
  // The first tiles' V while decode_score may still run (one commit group
  // each), then, once its writes are visible, their scores (one group
  // each): tile i's data is complete when all but kStages - 2 groups are.
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    issue_v(i);
    cp_async_commit();
  }
  griddep_wait();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    issue_s(i);
    cp_async_commit();
  }
  auto issue = [&](int i) {
    issue_v(i);
    issue_s(i);
    cp_async_commit();
  };

  final_max(p, t, qrow0, G, m_g);
  __syncthreads();

  float acc[GC][8], lsum[GC], m_r[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    lsum[g] = 0.f;
    m_r[g] = g < G ? m_g[g] : 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncwarp();
    issue(i + kStages - 1);
    const int base = t.s_lo + i * TR, st = i % kStages;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + rg + u * RG;
      if (l >= t.s_hi) continue;
      const int slot = (st * kUnroll + u) * RG + rg;
      float x[8];
      to_float8<KVF>(ring.chunk[(st * kUnroll + u) * T + tid], x);
      const float vs = kQuant ? ring.scale[slot] : 1.f;
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g >= G) break;
        const float pe = exp2f(ring.score[slot * GC + g] - m_r[g]);
        lsum[g] += pe;
        float pw = kQuant ? pe * vs : pe;
        if (p.q_bf16) pw = bf16_round(pw);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pw, x[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();

  // The row groups of a warp meet by a butterfly (every lane ends with the
  // same sums), then the warps in shared memory, in warp order.
  for (int o = CPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g >= G) break;
      lsum[g] += __shfl_xor_sync(kFull, lsum[g], o);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], o);
    }
  }
  __syncthreads();                       // the ring is free: o_w reuses it
  if (lane < CPR) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g >= G) break;
      if (cc == 0) l_w[warp * GC + g] = lsum[g];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o_w[((size_t)warp * GC + g) * D + cc * 8 + e] = acc[g][e];
    }
  }
  __syncthreads();
  finish_attend<GC>(p, t, m_g, l_w, o_w, last, qrow0, s, G);
}

// A warp's rows of a tile for the tensor-core path: j = u * (32 / CPR) +
// the warp's row group, so that each warp takes 16 (D = 128) or 32 (D =
// 64) rows; chunk cc of such a row sits at cc ^ (j % 8) in its row group's
// slots, so that the 8 rows an ldmatrix reads fall in 8 bank groups.
template <int CPR>
__device__ __forceinline__ int mma_slot(int rg, int cc, int u) {
  constexpr int kWRG = 32 / CPR;
  return rg * CPR + (cc ^ ((u * kWRG + rg % kWRG) & 7));
}

// Pass 1 on tensor cores (bf16 q over a bf16 cache; D = DD, 64 or 128):
// each warp takes S^T = K q^T for its rows with mma.sync m16n8k16 (A = K
// rows by ldmatrix, B = q^T held in registers, the GC query rows padded to
// 8), exact products summed in fp32. Otherwise as decode_score.
template <int GC, int DD, class Rows>
__global__ void __launch_bounds__(256)
decode_score_mma(AttendParams p, Rows rows) {
  constexpr int CPR = DD / 8, kWRG = 32 / CPR, kBlocks = kWRG * kUnroll / 16;
  const int bh = blockIdx.x, b = bh / p.hkv, h = bh - b * p.hkv;
  const int g0 = blockIdx.y * GC, G = min(GC, p.group - g0), s = blockIdx.z;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, nw = T >> 5;
  const int RG = T / CPR, TR = RG * kUnroll;
  const int cc = tid % CPR, rg = tid / CPR;
  extern __shared__ __align__(16) unsigned char smem[];
  const Ring<0, GC> ring(smem, T, RG, false);
  float* red = reinterpret_cast<float*>(
      smem + Ring<0, GC>::bytes(T, RG, false));      // [nw][GC]
  int* ids = reinterpret_cast<int*>(red + nw * GC);  // page ids

  griddep_launch_dependents();           // decode_attend may start its V
  const int cap = rows.capacity();
  const Split t = split_of(p, cap, b, s);
  if (s == 0 && tid == 0) p.arrived[bh * gridDim.y + blockIdx.y] = 0;
  if (t.s_lo >= t.s_hi) return;
  Rows at = rows;
  at.bind(ids, b, t.s_lo, t.s_hi);
  __syncthreads();
  const size_t qrow0 = (size_t)bh * p.group + g0;
  float* sc = p.scratch + ((size_t)bh * gridDim.y + blockIdx.y) * cap * GC;
  const int ntiles = (t.s_hi - t.s_lo + TR - 1) / TR;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k);

  auto issue = [&](int i) {
    if (i < ntiles) {
      const int base = t.s_lo + i * TR, st = i % kStages;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int l = base + rg + u * RG;
        if (l < t.s_hi)
          cp_async<16>(ring.chunk + (st * kUnroll + u) * T +
                           mma_slot<CPR>(rg, cc, u),
                       kb + at(bh, h, l) * DD + cc * 8);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // q^T as B fragments: query row lane / 4 (zero past G), columns
  // 16 ks + 2 (lane % 4) + {0, 1} and those + 8.
  const int gq = lane >> 2, dq = (lane & 3) * 2;
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(p.q) +
                            (qrow0 + min(gq, G - 1)) * DD + dq;
  uint32_t qb[DD / 16][2];
#pragma unroll
  for (int ks = 0; ks < DD / 16; ++ks) {
    const float x0 = __bfloat162float(qp[ks * 16]),
                x1 = __bfloat162float(qp[ks * 16 + 1]),
                x8 = __bfloat162float(qp[ks * 16 + 8]),
                x9 = __bfloat162float(qp[ks * 16 + 9]);
    qb[ks][0] = gq < G ? pack_bf16(x0, x1) : 0u;
    qb[ks][1] = gq < G ? pack_bf16(x8, x9) : 0u;
  }

  // This lane's C entries: rows j = 16 nb + lane / 4 (+ 8), query rows
  // gc and gc + 1.
  const int gc = (lane & 3) * 2;
  float m0 = kMaskValue, m1 = kMaskValue;
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncwarp();
    issue(i + kStages - 1);
    const int base = t.s_lo + i * TR, st = i % kStages;
    const uint4* tile = ring.chunk + (st * kUnroll) * T;
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      // ldmatrix rows: j = 16 nb + lane % 8 (+ 8 for matrices 1 and 3),
      // chunk 2 ks (+ 1 for matrices 2 and 3).
      const int j = nb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int u = j / kWRG, r = warp * kWRG + j % kWRG;
#pragma unroll
      for (int ks = 0; ks < DD / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, tile + u * T + mma_slot<CPR>(r, ks * 2 + (lane >> 4), u));
        mma_bf16(c, a, qb[ks][0], qb[ks][1]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int jr = nb * 16 + (lane >> 2) + hh * 8;
        const int l = base + warp * kWRG + jr % kWRG + (jr / kWRG) * RG;
        if (l < t.s_hi && gc < GC) {
          if (gc < G) m0 = fmaxf(m0, c[2 * hh]);
          if (gc + 1 < G) m1 = fmaxf(m1, c[2 * hh + 1]);
          *reinterpret_cast<float2*>(sc + (size_t)l * GC + gc) =
              make_float2(c[2 * hh], c[2 * hh + 1]);
        }
      }
    }
  }
  // Row max over the lanes that hold the same query rows, then the warps.
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(kFull, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(kFull, m1, o));
  }
  if (lane < 4 && gc < GC) {
    red[warp * GC + gc] = m0;
    red[warp * GC + gc + 1] = m1;
  }
  __syncthreads();
  put_split_max<GC>(p, red, qrow0, s, G);
}

// Pass 2 on tensor cores (bf16 q over a bf16 cache): each warp takes
// O^T += V^T P^T for its rows with mma.sync (A = V^T by ldmatrix.trans,
// B = P^T formed in registers: each lane exponentiates its four (row,
// query row) pairs a block against the final max and rounds them to
// bf16). Rows past the split are zero-filled in the ring. Otherwise as
// decode_attend.
template <int GC, int DD, class Rows>
__global__ void __launch_bounds__(256)
decode_attend_mma(AttendParams p, Rows rows) {
  constexpr int CPR = DD / 8, kWRG = 32 / CPR, kBlocks = kWRG * kUnroll / 16;
  const int bh = blockIdx.x, b = bh / p.hkv, h = bh - b * p.hkv;
  const int g0 = blockIdx.y * GC, G = min(GC, p.group - g0), s = blockIdx.z;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, nw = T >> 5;
  const int RG = T / CPR, TR = RG * kUnroll;
  const int cc = tid % CPR, rg = tid / CPR;
  extern __shared__ __align__(16) unsigned char smem[];
  const Ring<0, GC> ring(smem, T, RG, true);
  float* o_w = reinterpret_cast<float*>(smem);  // [nw][GC][D], after the loop
  float* m_g = reinterpret_cast<float*>(
      smem + attend_union_bytes<0, GC>(T, DD));   // [GC] row max
  float* l_w = m_g + GC;                          // [nw][GC] row sums
  int* last = reinterpret_cast<int*>(l_w + nw * GC);
  int* ids = last + 1;                            // page ids

  const int cap = rows.capacity();
  const Split t = split_of(p, cap, b, s);
  const size_t qrow0 = (size_t)bh * p.group + g0;
  if (t.last < t.first) {                // no live row: O = 0, by split 0
    if (s == 0)
      for (int idx = tid; idx < G * DD; idx += blockDim.x)
        store_o(p, qrow0 * DD + idx, 0.f);
    return;
  }
  if (t.s_lo >= t.s_hi) return;
  Rows at = rows;
  at.bind(ids, b, t.s_lo, t.s_hi);
  __syncthreads();
  const float* sc =
      p.scratch + ((size_t)bh * gridDim.y + blockIdx.y) * cap * GC;
  const int ntiles = (t.s_hi - t.s_lo + TR - 1) / TR;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v);

  // As decode_attend's, with the V rows past the split zero-filled.
  auto issue_v = [&](int i) {
    if (i >= ntiles) return;
    const int base = t.s_lo + i * TR, st = i % kStages;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + rg + u * RG;
      const bool live = l < t.s_hi;
      cp_async16(ring.chunk + (st * kUnroll + u) * T +
                     mma_slot<CPR>(rg, cc, u),
                 live ? vb + at(bh, h, l) * DD + cc * 8 : vb, live ? 16 : 0);
    }
  };
  auto issue_s = [&](int i) {
    if (i >= ntiles || cc != 0) return;
    const int base = t.s_lo + i * TR, st = i % kStages;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + rg + u * RG;
      if (l < t.s_hi)
#pragma unroll
        for (int g = 0; g < GC; g += 4)
          cp_async<16>(ring.score + ((st * kUnroll + u) * RG + rg) * GC + g,
                       sc + (size_t)l * GC + g);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    issue_v(i);
    cp_async_commit();
  }
  griddep_wait();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    issue_s(i);
    cp_async_commit();
  }
  auto issue = [&](int i) {
    issue_v(i);
    issue_s(i);
    cp_async_commit();
  };

  final_max(p, t, qrow0, G, m_g);
  __syncthreads();

  // B = P^T: this lane's query row gp = lane / 4 and rows
  // 16 nb + 2 (lane % 4) + {0, 1, 8, 9}.
  const int gp = lane >> 2;
  const float m_r = gp < G ? m_g[gp] : 0.f;
  float acc[DD / 16][4];
#pragma unroll
  for (int db = 0; db < DD / 16; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[db][e] = 0.f;
  float lsum = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncwarp();
    issue(i + kStages - 1);
    const int base = t.s_lo + i * TR, st = i % kStages;
    const uint4* tile = ring.chunk + (st * kUnroll) * T;
    const float* scores = ring.score + (st * kUnroll) * RG * GC;
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb) {
      float pw[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = nb * 16 + (lane & 3) * 2 + (e & 1) + (e >> 1) * 8;
        const int u = jj / kWRG, r = warp * kWRG + jj % kWRG;
        float pe = 0.f;
        if (gp < G && base + r + u * RG < t.s_hi)
          pe = exp2f(scores[(u * RG + r) * GC + gp] - m_r);
        lsum += pe;
        pw[e] = pe;
      }
      const uint32_t b0 = pack_bf16(pw[0], pw[1]), b1 = pack_bf16(pw[2], pw[3]);
      // ldmatrix.trans rows: j = 16 nb + lane % 8 (+ 8 for matrices 2 and
      // 3), chunk 2 db (+ 1 for matrices 1 and 3).
      const int j = nb * 16 + (lane & 7) + (lane >> 4) * 8;
      const int u = j / kWRG, r = warp * kWRG + j % kWRG;
#pragma unroll
      for (int db = 0; db < DD / 16; ++db) {
        uint32_t a[4];
        ldsm_x4_t(a, tile + u * T +
                         mma_slot<CPR>(r, db * 2 + ((lane >> 3) & 1), u));
        mma_bf16(acc[db], a, b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // Row sums over the four lanes of a query row; then each warp's
  // partial O^T (rows d, columns gc and gc + 1) and sums into shared
  // memory, which the ring no longer needs.
  lsum += __shfl_xor_sync(kFull, lsum, 1);
  lsum += __shfl_xor_sync(kFull, lsum, 2);
  __syncthreads();
  if ((lane & 3) == 0 && gp < G) l_w[warp * GC + gp] = lsum;
  const int gc = (lane & 3) * 2;
#pragma unroll
  for (int db = 0; db < DD / 16; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = db * 16 + (lane >> 2) + (e >> 1) * 8, g = gc + (e & 1);
      if (g < G) o_w[((size_t)warp * GC + g) * DD + d] = acc[db][e];
    }
  __syncthreads();
  finish_attend<GC>(p, t, m_g, l_w, o_w, last, qrow0, s, G);
}

// Sets a kernel's shared memory and launches it on the caller's stream;
// `overlap`: as a programmatic dependent of the kernel before it (its
// CTAs may start before that kernel ends, and wait in griddep_wait).
template <class Rows>
cudaError_t launch_one(void (*kernel)(AttendParams, Rows), dim3 grid,
                       int threads, size_t smem, cudaStream_t stream,
                       bool overlap, const AttendParams& p,
                       const Rows& rows) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = overlap ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, p, rows);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int KVF, int GC, class Rows>
int launch_pair(const AttendParams& p, const Rows& rows, dim3 grid,
                int threads, cudaStream_t stream) {
  const int nw = threads / 32, rg = threads / (p.D / 8);
  const size_t table = sizeof(int) * rows.table_ints(p.split_rows);
  void (*score)(AttendParams, Rows) = decode_score<KVF, GC, Rows>;
  void (*attend)(AttendParams, Rows) = decode_attend<KVF, GC, Rows>;
  // bf16 q over a bf16 cache at D = 64 or 128: the tensor-core pair.
  if constexpr (KVF == 0) {
    if (p.q_bf16 && p.D == 64) {
      score = decode_score_mma<GC, 64, Rows>;
      attend = decode_attend_mma<GC, 64, Rows>;
    } else if (p.q_bf16 && p.D == 128) {
      score = decode_score_mma<GC, 128, Rows>;
      attend = decode_attend_mma<GC, 128, Rows>;
    }
  }
  cudaError_t err = launch_one(
      score, grid, threads,
      Ring<KVF, GC>::bytes(threads, rg, false) + sizeof(float) * nw * GC +
          table,
      stream, false, p, rows);
  if (err != cudaSuccess) return err;
  return launch_one(attend, grid, threads,
                    attend_union_bytes<KVF, GC>(threads, p.D) +
                        sizeof(float) * (GC + nw * GC) + sizeof(int) + table,
                    stream, true, p, rows);
}

// Checks the launch shape, carves the workspace, picks the storage
// format's and query chunk's instances and launches both passes.
template <class Rows>
int launch(AttendParams p, const Rows& rows, void* workspace, int n,
           int kv_format, int group_chunk, int threads, void* stream) {
  const int cpr = p.D / 8, cap = rows.capacity();
  if (p.group < 1 || p.hkv < 1 || n < 1 || n % p.hkv != 0 || p.D % 8 != 0 ||
      cpr > 32 || (cpr & (cpr - 1)) != 0 || threads % 32 != 0 ||
      threads % cpr != 0 || threads < 32 || threads > 256 || cap < 0 ||
      p.split_rows < 1 || (p.split_rows & (p.split_rows - 1)) != 0 ||
      (group_chunk != 4 && group_chunk != 8))
    return cudaErrorInvalidValue;
  p.splits = cap > 0 ? (cap + p.split_rows - 1) / p.split_rows : 1;
  const int chunks = (p.group + group_chunk - 1) / group_chunk;
  if (p.splits > 65535 || chunks > 65535) return cudaErrorInvalidValue;
  // Workspace (fp32): scratch, m_part, l_part, o_part, then the counters.
  const size_t qrows = (size_t)n * p.group;
  float* ws = static_cast<float*>(workspace);
  p.scratch = ws;
  ws += (size_t)n * chunks * cap * group_chunk;
  p.m_part = ws;
  ws += qrows * p.splits;
  p.l_part = ws;
  ws += qrows * p.splits;
  p.o_part = ws;
  ws += qrows * p.splits * p.D;
  p.arrived = reinterpret_cast<int*>(ws);

  const dim3 grid(n, chunks, p.splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = group_chunk == 8;
  switch (kv_format) {
    case 0: return wide ? launch_pair<0, 8>(p, rows, grid, threads, st)
                        : launch_pair<0, 4>(p, rows, grid, threads, st);
    case 1: return wide ? launch_pair<1, 8>(p, rows, grid, threads, st)
                        : launch_pair<1, 4>(p, rows, grid, threads, st);
    case 2: return wide ? launch_pair<2, 8>(p, rows, grid, threads, st)
                        : launch_pair<2, 4>(p, rows, grid, threads, st);
    case 3: return wide ? launch_pair<3, 8>(p, rows, grid, threads, st)
                        : launch_pair<3, 4>(p, rows, grid, threads, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K5. q, o: [bh, group, D] (q_bf16: bf16, else fp32); k, v: [bh, max_len,
// D] storage (kv_format: 0 bf16, 1 int8, 2 fp8-e4m3, 3 fp8-e5m2); scales
// [bh, max_len] fp32; lengths [bh / hkv] int32. workspace: fp32, bh *
// (chunks * max_len * group_chunk + group * (splits * (D + 2) + 1))
// values, chunks = ceil(group / group_chunk), splits = ceil(max_len /
// split_rows) (at least 1); 16-byte aligned. split_rows a power of two;
// group_chunk 4 or 8 query rows a CTA. D / 8 a power of two <= 32;
// 16-byte aligned cache rows.
extern "C" int mfa_decode_attend(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, void* o, void* workspace,
    int bh, int hkv, int group, int max_len, int D, int window, int q_bf16,
    int kv_format, int split_rows, int group_chunk, int threads,
    void* stream) {
  AttendParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lengths = static_cast<const int*>(lengths);
  p.o = o;
  p.hkv = hkv;
  p.group = group;
  p.D = D;
  p.window = window;
  p.q_bf16 = q_bf16;
  p.split_rows = split_rows;
  return launch(p, ContiguousRows{max_len}, workspace, bh, kv_format,
                group_chunk, threads, stream);
}

// K6. q, o: [n = sequences * hkv, group, D]; k, v pages: [num_pages, hkv,
// page_size, D] storage; scales [num_pages, hkv, page_size] fp32; tables
// [sequences, max_pages] int32; lengths [sequences] int32; workspace as
// K5's with max_len = max_pages * page_size. Otherwise as K5.
extern "C" int mfa_paged_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* o, void* workspace, int n, int hkv,
    int group, int max_pages, int page_size, int D, int window, int q_bf16,
    int kv_format, int split_rows, int group_chunk, int threads,
    void* stream) {
  if (max_pages < 1 || page_size < 1) return cudaErrorInvalidValue;
  AttendParams p{};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lengths = static_cast<const int*>(lengths);
  p.o = o;
  p.hkv = hkv;
  p.group = group;
  p.D = D;
  p.window = window;
  p.q_bf16 = q_bf16;
  p.split_rows = split_rows;
  PagedRows rows{static_cast<const int*>(tables), max_pages, page_size, hkv,
                 nullptr, 0};
  return launch(p, rows, workspace, n, kv_format, group_chunk, threads,
                stream);
}
