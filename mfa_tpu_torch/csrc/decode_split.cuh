// The split-KV decode body shared by K5 / K6 (csrc/decode_attend.cu and
// csrc/paged_decode.cu; the layout and rounding rule are described in
// the first) and K2, the fused decode + append (csrc/decode.cu). Every
// kernel takes a kFused flag; K5 and K6 instantiate it false, K2 true,
// with its own parameters (FusedParams) and helpers (final_max_fused,
// finish_attend_fused): shared, they changed how ptxas compiled K5's and
// K6's loops. What the fused flavour adds:
//  - live rows [max(0, len + 1 - W), len) (split_of<true>);
//  - the new token's column s_new = q . k_new from the unquantized k_new,
//    in the final max and the row sum, and p_new v_new added where the
//    partials meet (finish_attend_fused);
//  - the append of row len, by the score CTA of chunk 0 whose split owns
//    position len (append_new_row); no CTA reads row len as data;
//  - for an int8 cache, the TPU kernel's s8 requantization of q (score)
//    and of P (attend) per query row, with the P scale taken over every
//    live row by a third pass (decode_pmax).
//
// Which launches take which pass pair (launch_passes; the host names the
// path, ops/params.py::decode_path, and a launch on another is refused):
//  - the tensor-core pair (decode_score_mma, decode_attend_mma): bf16 q
//    at 64 <= D <= 512 over every storage type (bf16, int8, fp8-e4m3,
//    fp8-e5m2), K2, K5 and K6 alike, whose rows and bases share a copy
//    granule g of 4 bytes or more (mma_granule: the largest of 16, 8, 4
//    dividing the row bytes and the k and v bases). 1-byte storage is
//    widened to bf16 by each warp (exact). D 64 and 128 at g 16 keep
//    their own instances (GR 0); every other such launch up to D 128 (D
//    80, 96, 112 at g 16; OpenLLaMA-3B's D 100 at g 8 in bf16, 4 in int8
//    and fp8; bases 8 or 4 bytes off) runs the 128-wide instance of its
//    granule, every one past D 128 up to 256 (D 192 and 256; D 250 in
//    bf16 at g 4) the 256-wide instance and every one past D 256 (D 300,
//    384, 512) the 512-wide one; those two read their granule from the
//    bases at run time (GR kGrAny) and run CTAs of 128 threads
//    (ops/params.py::decode_threads: at DD 256 a ring of ~100
//    KB, two CTAs an SM; at DD 512 ~200 KB, one), rows padded with zeros
//    to 128, 256 or 512 values in shared memory;
//  - the FMA pair (decode_score / decode_attend in RowLayout's rows,
//    their _exact instances at D = 8 * 2^k <= 256): everything else
//    (fp32 q, which the 2e-5 budget keeps unrounded; odd D and g < 4, so
//    D 250 and 302 over int8 and fp8; D < 64), over 16-byte aligned cache
//    storage.
// K2 over int8 gives the same bits on either pair: its q and P are s8
// integers (exact as bf16 operands), their products with K and V are
// integers whose sums stay below 2^24 (512 * 127^2 a score, 1024 * 127^2
// a split's P V: DECODE_SPLIT_MAX_ROWS), so exact in fp32 in any order,
// and what is not an integer (the scales' products, P's row sum) the
// pair computes in the FMA pair's order; only D 64 off 16 bytes, whose
// 128-wide padded rows the pair groups otherwise than FMA, sums P's row
// sum in another order. Over the other storage types the pair sums in
// another order than FMA (another result within the budget).
// What bounds K6 and K2 at D 100 on an H100: the bytes of the live K and
// V rows (200 each in bf16, 100 in int8 and fp8), as at D 128; on FMA
// they ran 6-8x that bound on an H100 (PERF.md), issue-bound by their dot
// products and shuffles, and the padded pair adds only copies (two 8-byte
// copies a 16-byte chunk at D 100) and zeros that only shared memory and
// the tensor cores see.

#pragma once

#include "common.cuh"

namespace {

using namespace mfa;

constexpr int kUnroll = 8;   // rows of a tile a lane group takes
constexpr int kMaxHeadDim = 512;  // two 8-value chunks a lane of 32
constexpr int kStages = 3;   // tiles in the ring: two in flight, one used
// Scales are amax * (1 / qmax) with the reciprocal rounded to fp32, as
// mfa_tpu computes them under jax.jit (see kernels/quant.py).
constexpr float kInv127 = 1.0f / 127.0f;
constexpr float kInv448 = 1.0f / 448.0f;
constexpr float kInv57344 = 1.0f / 57344.0f;

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

// K2's parameters: K5's, then the new token's K and V ([N, D], q dtype)
// and each split's max of |P vs| (int8). A struct of its own: grown by
// these fields,
// AttendParams changed how ptxas compiled K5's and K6's loops (14% slower
// on int8 and fp8 caches).
struct FusedParams : AttendParams {
  const void* k_new;
  const void* v_new;
  float* pa_part;         // [N, group, splits]
};

template <bool kFused>
using Par = typename std::conditional<kFused, FusedParams, AttendParams>::type;

// K5: row l of (batch, head) bh in [BH, L, D].
struct ContiguousRows {
  int max_len;
  __host__ __device__ int capacity() const { return max_len; }
  __host__ __device__ int table_ints(int) const { return 0; }
  __device__ void bind(int*, int, int, int) {}
  __device__ __forceinline__ size_t operator()(int bh, int, int l) const {
    return (size_t)bh * max_len + l;
  }
  // The end of the run of rows adjacent in the cache from l (below hi),
  // and whether, for rows of rb bytes, every run starts at the same
  // offset mod 16 in the cache as in its slot (copy_run).
  __device__ __forceinline__ int run_end(int, int hi) const { return hi; }
  __device__ __forceinline__ bool granular(int) const { return true; }
};

// K2: K5's rows under a name of their own, which K2's kernels carry (a
// profile tells them from K5's by it).
struct FusedRows : ContiguousRows {};

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
  __device__ __forceinline__ int run_end(int l, int hi) const {
    return min(hi, (l / page_size + 1) * page_size);
  }
  // Pages of whole 16-byte granules start aligned.
  __device__ __forceinline__ bool granular(int rb) const {
    return (size_t)page_size * rb % 16 == 0;
  }
};

// The live rows [lo, len) of sequence b, its live splits [first, last]
// (none: last < first) and split s's rows [s_lo, s_hi).
struct Split {
  int len, lo, first, last, s_lo, s_hi;
};

template <bool kFused>
__device__ __forceinline__ Split split_of(const AttendParams& p, int cap,
                                          int b, int s) {
  Split t;
  t.len = min(max(p.lengths[b], 0), cap);
  if constexpr (kFused)
    t.lo = p.window > 0 ? max(0, t.len + 1 - p.window) : 0;
  else
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

// Rows of a tile a lane group takes on the FMA passes: kUnroll up to D =
// 256 (one chunk a lane), half past it (two chunks a lane, twice the
// registers for q and the partial O).
template <int NC>
constexpr int kUnrollOf = NC == 1 ? kUnroll : kUnroll / 2;

// The FMA passes' row layout for any head dim D <= 512 over storage of E
// bytes a value (2 bf16, 1 int8 / fp8), with `threads` threads:
//  - a row is nch = ceil(D / 8) chunks of 8 values, the last one read as
//    zeros past D; W = min(32, next power of two >= nch) adjacent lanes
//    take it, lane cc its chunks cc and cc + W (nc() = ceil(nch / W) <= 2
//    of them: past D = 256 a row has more chunks than a warp has lanes);
//  - row group rg = tid / W takes rows base + rg + u RG of a tile (RG =
//    threads / W), so that for each u the row groups of a warp take a run
//    of rpr = 32 / W consecutive rows;
//  - the warp copies each of its runs itself, as whole 16-byte granules of
//    the cache (copy_run), into a slot of `run` bytes, the run's first
//    byte at the slot plus that byte's cache offset mod 16: granules are
//    16-byte aligned in the cache and in shared memory whatever D, the
//    first row and the window. A row of D 100 is 200 bytes (8-byte
//    aligned) in bf16, 100 (4-byte) in int8 and fp8; so a chunk sits in
//    shared memory at `al`, the alignment every row start and chunk start
//    shares (16 bytes, 8 for 1-byte storage, where rb is a multiple of
//    16: the layout of the kernel before, D = 8 * 2^k).
// A run's slot holds its rpr rows, rounded up to 16 bytes, plus (rows not
// 16-byte multiples) 32 bytes for the offset (< 16) and the last chunk's
// read past D (< 16). At D = 8 * 2^k <= 256 (`exact`: one whole chunk a
// lane, rows aligned to a chunk) the kernels keep the kernel before's
// code (kExact): each thread copies its own chunk by cp.async and reads
// it back, with no offset, mask or alignment to reckon per row (the
// general code cost K5 15-45% over int8 and fp8 at D 128 on an H100,
// issue-bound).
struct RowLayout {
  int rb;         // bytes of a cache row, D * E
  int nch;        // 8-value chunks of a row
  int W;          // lanes a row
  int rpr;        // rows of a warp's run
  int RG;         // row groups of the CTA
  int run;        // shared bytes of a run's slot
  int al;         // alignment of a chunk in shared memory
  bool aligned;   // rb % 16 == 0: every run at offset 0 of its slot
  bool exact;     // D = 8 W: the kernel before's per-thread chunks

  __host__ __device__ RowLayout(int D, int E, int threads) {
    rb = D * E;
    nch = (D + 7) / 8;
    W = 1;
    while (W < nch && W < 32) W <<= 1;
    rpr = 32 / W;
    RG = threads / W;
    aligned = rb % 16 == 0;
    exact = D == 8 * W;
    run = exact ? 32 * 8 * E : (rpr * rb + 15) / 16 * 16 + (aligned ? 0 : 32);
    int g = 16;
    while (rb % g != 0) g >>= 1;
    al = g < 8 * E ? g : 8 * E;
  }
  __host__ __device__ int nc() const { return (nch + W - 1) / W; }
};

// The ring of kStages tiles in shared memory, `unroll` rows a row group
// a tile and rg row groups: the chunks [kStages][unroll] of `chunk_bytes`
// each (FMA: the warps' run slots [nw][run]; tensor cores: each thread's
// chunk [threads]), then (scores) each row's GC scores
// [kStages][unroll][rg][GC], then each row's scale [kStages][unroll][rg].
// Every part is 16-byte aligned.
template <int KVF, int GC>
struct Ring {
  using C = typename Chunk<KVF>::type;
  C* chunk;
  float* score;
  float* scale;

  __host__ __device__ static size_t bytes(size_t chunk_bytes, int unroll,
                                          int rg, bool scores) {
    return (size_t)kStages * unroll *
           (chunk_bytes + (scores ? rg * GC * 4 : 0) + rg * 4);
  }
  __device__ Ring(void* base, size_t chunk_bytes, int unroll, int rg,
                  bool scores) {
    char* b = static_cast<char*>(base);
    chunk = reinterpret_cast<C*>(b);
    b += (size_t)kStages * unroll * chunk_bytes;
    score = reinterpret_cast<float*>(b);
    b += scores ? (size_t)kStages * unroll * rg * GC * 4 : 0;
    scale = reinterpret_cast<float*>(b);
  }
};

// The FMA passes' ring (the warps' run slots a stage and row).
template <int KVF, int GC>
__host__ __device__ size_t fma_ring_bytes(const RowLayout& lay, int unroll,
                                          int threads, bool scores) {
  return Ring<KVF, GC>::bytes((size_t)(threads / 32) * lay.run, unroll,
                              lay.RG, scores);
}

// The shared memory of the FMA attend pass: the ring, which the warps'
// partial O [nw][GC][D] reuses after the loop, then the row max [GC], the
// row sums [nw][GC], the last-to-arrive flag and the page ids.
template <int KVF, int GC>
__host__ __device__ size_t attend_union_bytes(int threads, int D) {
  const RowLayout lay(D, KVF == 0 ? 2 : 1, threads);
  const size_t ring = fma_ring_bytes<KVF, GC>(
      lay, lay.nc() == 1 ? kUnrollOf<1> : kUnrollOf<2>, threads, true);
  const size_t o_w = (size_t)(threads / 32) * GC * D * 4;
  return ring > o_w ? ring : o_w;
}

// Copies rows [l0, l1) of kv head h of (sequence, kv head) bh, one warp's
// run, from the cache at `src` into `slot` (16-byte aligned), row l0's
// first byte at slot + its cache offset mod 16, by the warp's lanes. The
// run is cut where the rows stop being adjacent in the cache (a page
// ends). Granular rows (every page start 16-byte aligned; a contiguous
// cache) go by whole 16-byte granules, aligned on both sides: the
// first and last may hold bytes of the rows around the run, which no
// lane reads as data (and a granule never leaves the allocation: the
// storage starts 16-byte aligned, and device memory is mapped in pages).
// Otherwise (pages of rows whose bytes are not a multiple of 16) byte by
// byte.
template <class Rows>
__device__ __forceinline__ void copy_run(const Rows& at, const char* src,
                                         unsigned char* slot, int rb,
                                         int bh, int h, int l0, int l1,
                                         int lane) {
  const size_t first = at(bh, h, l0) * (size_t)rb;
  unsigned char* dst = slot + (first & 15);
  for (int l = l0; l < l1;) {
    const int e = at.run_end(l, l1);
    const size_t gs = l == l0 ? first : at(bh, h, l) * (size_t)rb;
    const int n = (e - l) * rb;
    unsigned char* ds = dst + (size_t)(l - l0) * rb;
    if (at.granular(rb)) {
      const size_t a = gs & ~(size_t)15;
      const int span = (int)(((gs + n + 15) & ~(size_t)15) - a);
      unsigned char* d0 = ds - (gs & 15);
      for (int x = lane * 16; x < span; x += 32 * 16)
        cp_async<16>(d0 + x, src + a + x);
    } else {
      for (int x = lane; x < n; x += 32) ds[x] = src[gs + x];
    }
    l = e;
  }
}

// One stored chunk from shared memory at an address aligned to `al`
// bytes (the layout's, the same for every chunk of a launch).
template <int KVF>
__device__ __forceinline__ typename Chunk<KVF>::type smem_chunk(
    const unsigned char* s, int al) {
  using C = typename Chunk<KVF>::type;
  constexpr int kN = sizeof(C);
  if (al >= kN) return *reinterpret_cast<const C*>(s);
  union {
    C c;
    uint2 d[kN / 8];
    uint32_t w[kN / 4];
    uint16_t h[kN / 2];
    uint8_t b[kN];
  } u;
  if (al == 8) {
#pragma unroll
    for (int i = 0; i < kN / 8; ++i)
      u.d[i] = reinterpret_cast<const uint2*>(s)[i];
  } else if (al == 4) {
#pragma unroll
    for (int i = 0; i < kN / 4; ++i)
      u.w[i] = reinterpret_cast<const uint32_t*>(s)[i];
  } else if (al == 2) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i)
      u.h[i] = reinterpret_cast<const uint16_t*>(s)[i];
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) u.b[i] = s[i];
  }
  return u.c;
}

// Chunk c of a row (lane's chunks), widened: zeros for a chunk past the
// row (`live` false: also a row past the split) and for the values past
// D of the last one.
template <int KVF>
__device__ __forceinline__ void row_chunk(const unsigned char* row, int c,
                                          const RowLayout& lay, int D,
                                          bool live, float* x) {
  if (live && c < lay.nch) {
    to_float8<KVF>(smem_chunk<KVF>(row + c * 8 * (KVF == 0 ? 2 : 1),
                                   lay.al), x);
    if (c * 8 + 8 > D)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (c * 8 + e >= D) x[e] = 0.f;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = 0.f;
  }
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

// K2's start of pass 2: final_max, then each query row's new-token score
// s_new = q . k_new into sn_g, which enters the max, and (kRequant, an
// int8 cache) P's s8 scale from the live splits' max |P vs| into ps_g.
// The caller syncs. (K2's helpers are kept apart from K5's and K6's so
// that those compile as before.)
template <bool kRequant>
__device__ __forceinline__ void final_max_fused(const FusedParams& p,
                                                const Split& t, size_t qrow0,
                                                size_t bh, int G, float* m_g,
                                                float* sn_g, float* ps_g) {
  final_max(p, t, qrow0, G, m_g);
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int g = threadIdx.x >> 5; g < G; g += nw) {
    float dot = 0.f;
    for (int d = lane; d < p.D; d += 32)
      dot = fmaf(load_q(p.q, (qrow0 + g) * p.D + d, p.q_bf16),
                 load_q(p.k_new, bh * p.D + d, p.q_bf16), dot);
    dot = warp_sum(dot);
    if constexpr (kRequant) {
      float a = 0.f;
      for (int j = t.first + lane; j <= t.last; j += 32)
        a = fmaxf(a, p.pa_part[(qrow0 + g) * p.splits + j]);
      a = warp_max(a);
      if (lane == 0) ps_g[g] = fmaxf(a, 1e-30f) * kInv127;
    }
    if (lane == 0) {                     // lane 0 wrote m_g[g] above
      sn_g[g] = dot;
      m_g[g] = fmaxf(m_g[g], dot);
    }
  }
}

// K2's O at (query row g, column d) from the summed P V (int8: of the s8
// P) `tot` and row sum `l` of the live rows: the new token's p_new =
// exp2(s_new - m) joins the sum and p_new v_new the product, in
// decode_fused_append_plain's order.
template <bool kRequant>
__device__ __forceinline__ float final_o(const FusedParams& p, float tot,
                                         float l, float m, float sn,
                                         float ps, size_t bh, int d) {
  const float pn = exp2f(sn - m);
  const float vn = load_q(p.v_new, bh * p.D + d, p.q_bf16);
  return ((kRequant ? tot * ps : tot) + pn * vn) / fmaxf(l + pn, 1e-37f);
}

// K2's end of pass 2: finish_attend's partials, counter and split-order
// sums, with O from final_o.
template <int GC, bool kRequant>
__device__ void finish_attend_fused(const FusedParams& p, const Split& t,
                                    const float* m_g, const float* sn_g,
                                    const float* ps_g, float* l_w,
                                    const float* o_w, int* last,
                                    size_t qrow0, size_t bh, int s, int G) {
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
              final_o<kRequant>(p, tot, l, m_g[g], sn_g[g], ps_g[g], bh, d));
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
    l_w[tid] = l;
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx - g * D;
    const float* part = p.o_part + (qrow0 + g) * p.splits * D + d;
    float tot = 0.f;
    for (int j = t.first; j <= t.last; ++j)
      tot += __ldcg(part + (size_t)j * D);
    store_o(p, qrow0 * D + idx,
            final_o<kRequant>(p, tot, l_w[g], m_g[g], sn_g[g], ps_g[g], bh,
                              d));
  }
}

// K2: the new token's K and V quantized into cache row `row` with their
// scales, bit-equal to kernels/quant.py::quantize_for (scale =
// max(amax, 1e-8) * (1 / qmax); int8 rounds half to even and clips at
// +-127; bf16 is cast, scale 1). The whole CTA takes part; red holds one
// float a warp.
template <int KVF>
__device__ void append_new_row(const FusedParams& p, size_t bh, size_t row,
                               float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5, D = p.D;
  for (int which = 0; which < 2; ++which) {
    const void* src = which ? p.v_new : p.k_new;
    void* cache = const_cast<void*>(which ? p.v : p.k);
    float* scales = const_cast<float*>(which ? p.v_scale : p.k_scale);
    float scale = 1.f;
    if constexpr (KVF != 0) {
      float a = 0.f;
      for (int d = tid; d < D; d += blockDim.x)
        a = fmaxf(a, fabsf(load_q(src, bh * D + d, p.q_bf16)));
      a = warp_max(a);
      __syncthreads();                   // red's last readers are done
      if (lane == 0) red[warp] = a;
      __syncthreads();
      float amax = 0.f;
      for (int w = 0; w < nw; ++w) amax = fmaxf(amax, red[w]);
      scale = fmaxf(amax, 1e-8f) *
              (KVF == 1 ? kInv127 : KVF == 2 ? kInv448 : kInv57344);
    }
    for (int d = tid; d < D; d += blockDim.x) {
      const float x = load_q(src, bh * D + d, p.q_bf16);
      const size_t at = row * D + d;
      if constexpr (KVF == 0) {
        static_cast<__nv_bfloat16*>(cache)[at] = __float2bfloat16(x);
      } else if constexpr (KVF == 1) {
        const float r = fminf(fmaxf(rintf(x / scale), -127.f), 127.f);
        static_cast<int8_t*>(cache)[at] = static_cast<int8_t>(r);
      } else if constexpr (KVF == 2) {
        static_cast<__nv_fp8_e4m3*>(cache)[at] = __nv_fp8_e4m3(x / scale);
      } else {
        static_cast<__nv_fp8_e5m2*>(cache)[at] = __nv_fp8_e5m2(x / scale);
      }
    }
    if (tid == 0) scales[row] = scale;
  }
  __syncthreads();                       // red is free again
}

// Pass 1: S = (q . K_raw) * ks over the split's rows into the scratch row,
// and the split's row max into m_part, in RowLayout's rows (NC chunks a
// lane at most; kExact: its exact layout). Fused over an int8 cache: q
// requantized to s8 per query row first, S = (q_s8 . K) * q scale * ks
// (an exact integer dot). Fused: the append, by one CTA (split_of's owner
// of position len, chunk 0).
template <int KVF, int GC, int NC, bool kExact, class Rows, bool kFused>
__device__ __forceinline__ void score_pass(const Par<kFused>& p,
                                           const Rows& rows) {
  constexpr bool kQuant = KVF != 0;
  constexpr bool kRequant = kFused && KVF == 1;
  constexpr int U = kUnrollOf<NC>;
  using C = typename Chunk<KVF>::type;
  const int bh = blockIdx.x, b = bh / p.hkv, h = bh - b * p.hkv;
  const int g0 = blockIdx.y * GC, G = min(GC, p.group - g0), s = blockIdx.z;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, nw = T >> 5, D = p.D;
  const RowLayout lay(D, KVF == 0 ? 2 : 1, T);
  // Lane group rg (W adjacent lanes) takes rows base + rg + u RG of a
  // tile; lane cc its chunks cc + k W of each. (kExact: W = D / 8, and
  // each thread's chunk a tile row of the ring.)
  const int W = kExact ? D / 8 : lay.W, RG = T / W, TR = RG * U;
  const int cc = tid % W, rg = tid / W;
  const size_t chunks = kExact ? T * sizeof(C) : (size_t)nw * lay.run;
  extern __shared__ __align__(16) unsigned char smem[];
  const Ring<KVF, GC> ring(smem, chunks, U, RG, false);
  unsigned char* slots = reinterpret_cast<unsigned char*>(ring.chunk);
  float* red = reinterpret_cast<float*>(
      smem + Ring<KVF, GC>::bytes(chunks, U, RG, false));  // [nw][GC]
  int* ids = reinterpret_cast<int*>(red + nw * GC);       // page ids

  griddep_launch_dependents();           // decode_attend may start its V
  const int cap = rows.capacity();
  const Split t = split_of<kFused>(p, cap, b, s);
  if (s == 0 && tid == 0) p.arrived[bh * gridDim.y + blockIdx.y] = 0;
  if constexpr (kFused)
    if (blockIdx.y == 0 && t.len < cap && s == t.len / p.split_rows)
      append_new_row<KVF>(p, bh, rows(bh, h, t.len), red);
  if (t.s_lo >= t.s_hi) return;
  Rows at = rows;
  at.bind(ids, b, t.s_lo, t.s_hi);
  __syncthreads();
  const size_t qrow0 = (size_t)bh * p.group + g0;
  float* sc = p.scratch + ((size_t)bh * gridDim.y + blockIdx.y) * cap * GC;
  const int ntiles = (t.s_hi - t.s_lo + TR - 1) / TR;
  const char* kb = static_cast<const char*>(p.k);
  // Run u of this warp in stage st: its slot and its rows' first row.
  auto slot = [&](int st, int u) {
    return slots + ((size_t)(st * U + u) * nw + warp) * lay.run;
  };
  auto run0 = [&](int base, int u) { return base + u * RG + warp * lay.rpr; };

  // Tile i's K runs (and scales) into ring stage i % kStages; one commit
  // group a tile, empty past the last.
  auto issue = [&](int i) {
    if (i < ntiles) {
      const int base = t.s_lo + i * TR, st = i % kStages;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int l = base + rg + u * RG;
        if constexpr (kExact) {
          if (l < t.s_hi) {
            const size_t r = at(bh, h, l);
            cp_async<sizeof(C)>(ring.chunk + (st * U + u) * T + tid,
                                kb + (r * D + cc * 8) * sizeof(C) / 8);
            if (kQuant && cc == 0)
              cp_async<4>(ring.scale + (st * U + u) * RG + rg,
                          p.k_scale + r);
          }
        } else {
          const int l0 = run0(base, u);
          if (l0 < t.s_hi)
            copy_run(at, kb, slot(st, u), lay.rb, bh, h, l0,
                     min(l0 + lay.rpr, t.s_hi), lane);
          if (kQuant && cc == 0 && l < t.s_hi)
            cp_async<4>(ring.scale + (st * U + u) * RG + rg,
                        p.k_scale + at(bh, h, l));
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  float qr[NC][GC][8];
#pragma unroll
  for (int k = 0; k < NC; ++k)
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int d = (cc + k * W) * 8 + e;
        qr[k][g][e] = g < G && d < D
                          ? load_q(p.q, (qrow0 + g) * D + d, p.q_bf16)
                          : 0.f;
      }
  // kRequant: each query row's s8 scale over its D values (the row's W
  // lanes), then q_s8 = round(q / scale) clipped at +-127.
  float qsc[kRequant ? GC : 1];
  if constexpr (kRequant) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k)
#pragma unroll
        for (int e = 0; e < 8; ++e) a = fmaxf(a, fabsf(qr[k][g][e]));
      for (int o = W / 2; o > 0; o >>= 1)
        a = fmaxf(a, __shfl_xor_sync(kFull, a, o));
      qsc[g] = fmaxf(a, 1e-30f) * kInv127;
#pragma unroll
      for (int k = 0; k < NC; ++k)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          qr[k][g][e] =
              fminf(fmaxf(rintf(qr[k][g][e] / qsc[g]), -127.f), 127.f);
    }
  }

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
    // past G and past D), then the sums over the row's W lanes with all
    // the tile's shuffle chains interleaved.
    float dot[U][GC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool live = base + rg + u * RG < t.s_hi;
#pragma unroll
      for (int g = 0; g < GC; ++g) dot[u][g] = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        float x[8];
        if constexpr (kExact) {
          if (live) {
            to_float8<KVF>(ring.chunk[(st * U + u) * T + tid], x);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) x[e] = 0.f;
          }
        } else {
          const int l0 = run0(base, u);
          const int off =
              lay.aligned || l0 >= t.s_hi
                  ? 0
                  : (int)((at(bh, h, l0) * (size_t)lay.rb) & 15);
          row_chunk<KVF>(slot(st, u) + off +
                             (size_t)(rg - warp * lay.rpr) * lay.rb,
                         cc + k * W, lay, D, live, x);
        }
#pragma unroll
        for (int g = 0; g < GC; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dot[u][g] = fmaf(qr[k][g][e], x[e], dot[u][g]);
      }
    }
    for (int o = W / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int u = 0; u < U; ++u)
          dot[u][g] += __shfl_xor_sync(kFull, dot[u][g], o);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = base + rg + u * RG;
      if (l >= t.s_hi) continue;
      const float ks = kQuant ? ring.scale[(st * U + u) * RG + rg] : 1.f;
      float sv[GC];
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if constexpr (kRequant) sv[g] = dot[u][g] * qsc[g] * ks;
        else sv[g] = kQuant ? dot[u][g] * ks : dot[u][g];
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
// O = round(P * vs) V over the split's rows, in pass 1's row layout;
// then the partials of the live splits meet in split order.
template <int KVF, int GC, int NC, bool kExact, class Rows, bool kFused>
__device__ __forceinline__ void attend_pass(const Par<kFused>& p,
                                            const Rows& rows) {
  constexpr bool kQuant = KVF != 0;
  constexpr bool kRequant = kFused && KVF == 1;
  constexpr int U = kUnrollOf<NC>;
  using C = typename Chunk<KVF>::type;
  const int bh = blockIdx.x, b = bh / p.hkv, h = bh - b * p.hkv;
  const int g0 = blockIdx.y * GC, G = min(GC, p.group - g0), s = blockIdx.z;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, nw = T >> 5, D = p.D;
  const RowLayout lay(D, KVF == 0 ? 2 : 1, T);
  const int W = kExact ? D / 8 : lay.W, RG = T / W, TR = RG * U;
  const int cc = tid % W, rg = tid / W;
  const size_t chunks = kExact ? T * sizeof(C) : (size_t)nw * lay.run;
  extern __shared__ __align__(16) unsigned char smem[];
  const Ring<KVF, GC> ring(smem, chunks, U, RG, true);
  unsigned char* slots = reinterpret_cast<unsigned char*>(ring.chunk);
  // The partial O [nw][GC][D] reuses the ring after the loop
  // (attend_union_bytes).
  const size_t ring_bytes = Ring<KVF, GC>::bytes(chunks, U, RG, true);
  const size_t o_bytes = (size_t)nw * GC * D * 4;
  float* o_w = reinterpret_cast<float*>(smem);
  float* m_g = reinterpret_cast<float*>(
      smem + (ring_bytes > o_bytes ? ring_bytes : o_bytes));  // [GC] row max
  float* l_w = m_g + GC;                          // [nw][GC] row sums
  int* last = reinterpret_cast<int*>(l_w + nw * GC);
  int* ids = last + 1;                            // page ids
  float* sn_g = reinterpret_cast<float*>(
      ids + rows.table_ints(p.split_rows));       // K2: [GC] s_new
  float* ps_g = sn_g + GC;                        // K2: [GC] P scale

  const int cap = rows.capacity();
  const Split t = split_of<kFused>(p, cap, b, s);
  const size_t qrow0 = (size_t)bh * p.group + g0;
  if (t.last < t.first) {                // no live row: O = 0 (fused:
    if (s == 0)                          // v_new), by split 0
      for (int idx = tid; idx < G * D; idx += blockDim.x) {
        float o = 0.f;
        if constexpr (kFused)
          o = load_q(p.v_new, (size_t)bh * D + idx % D, p.q_bf16);
        store_o(p, qrow0 * D + idx, o);
      }
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
  auto slot = [&](int st, int u) {
    return slots + ((size_t)(st * U + u) * nw + warp) * lay.run;
  };
  auto run0 = [&](int base, int u) { return base + u * RG + warp * lay.rpr; };

  // Tile i's V runs and scales (issue_v), and each row's scores
  // (issue_s, written by decode_score), into ring stage i % kStages.
  auto issue_v = [&](int i) {
    if (i >= ntiles) return;
    const int base = t.s_lo + i * TR, st = i % kStages;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = base + rg + u * RG;
      if constexpr (kExact) {
        if (l < t.s_hi) {
          const size_t r = at(bh, h, l);
          cp_async<sizeof(C)>(ring.chunk + (st * U + u) * T + tid,
                              vb + (r * D + cc * 8) * sizeof(C) / 8);
          if (kQuant && cc == 0)
            cp_async<4>(ring.scale + (st * U + u) * RG + rg,
                        p.v_scale + r);
        }
      } else {
        const int l0 = run0(base, u);
        if (l0 < t.s_hi)
          copy_run(at, vb, slot(st, u), lay.rb, bh, h, l0,
                   min(l0 + lay.rpr, t.s_hi), lane);
        if (kQuant && cc == 0 && l < t.s_hi)
          cp_async<4>(ring.scale + (st * U + u) * RG + rg,
                      p.v_scale + at(bh, h, l));
      }
    }
  };
  auto issue_s = [&](int i) {
    if (i >= ntiles || cc != 0) return;
    const int base = t.s_lo + i * TR, st = i % kStages;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = base + rg + u * RG;
      if (l < t.s_hi)
#pragma unroll
        for (int g = 0; g < GC; g += 4)
          cp_async<16>(ring.score + ((st * U + u) * RG + rg) * GC + g,
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

  if constexpr (kFused)
    final_max_fused<kRequant>(p, t, qrow0, bh, G, m_g, sn_g, ps_g);
  else
    final_max(p, t, qrow0, G, m_g);
  __syncthreads();

  float acc[NC][GC][8], lsum[GC], m_r[GC];
  float ps_r[kRequant ? GC : 1];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    lsum[g] = 0.f;
    m_r[g] = g < G ? m_g[g] : 0.f;
    if constexpr (kRequant) ps_r[g] = g < G ? ps_g[g] : 1.f;
#pragma unroll
    for (int k = 0; k < NC; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[k][g][e] = 0.f;
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncwarp();
    issue(i + kStages - 1);
    const int base = t.s_lo + i * TR, st = i % kStages;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = base + rg + u * RG;
      if (l >= t.s_hi) continue;
      const int sl = (st * U + u) * RG + rg;
      float x[NC][8];
      if constexpr (kExact) {
        to_float8<KVF>(ring.chunk[(st * U + u) * T + tid], x[0]);
      } else {
        const int l0 = run0(base, u);
        const int off = lay.aligned
                            ? 0
                            : (int)((at(bh, h, l0) * (size_t)lay.rb) & 15);
        const unsigned char* row =
            slot(st, u) + off + (size_t)(rg - warp * lay.rpr) * lay.rb;
#pragma unroll
        for (int k = 0; k < NC; ++k)
          row_chunk<KVF>(row, cc + k * W, lay, D, true, x[k]);
      }
      const float vs = kQuant ? ring.scale[sl] : 1.f;
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g >= G) break;
        const float pe = exp2f(ring.score[sl * GC + g] - m_r[g]);
        lsum[g] += pe;
        float pw = kQuant ? pe * vs : pe;
        // K2 over int8: P vs as s8 against the scale over every live row
        // (integer products, exact in fp32 within a split of <= 1024 rows).
        if constexpr (kRequant)
          pw = fminf(fmaxf(rintf(pw / ps_r[g]), -127.f), 127.f);
        else if (p.q_bf16)
          pw = bf16_round(pw);
#pragma unroll
        for (int k = 0; k < NC; ++k)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[k][g][e] = fmaf(pw, x[k][e], acc[k][g][e]);
      }
    }
  }
  cp_async_wait<0>();

  // The row groups of a warp meet by a butterfly (every lane ends with the
  // same sums), then the warps in shared memory, in warp order.
  for (int o = W; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g >= G) break;
      lsum[g] += __shfl_xor_sync(kFull, lsum[g], o);
#pragma unroll
      for (int k = 0; k < NC; ++k)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[k][g][e] += __shfl_xor_sync(kFull, acc[k][g][e], o);
    }
  }
  __syncthreads();                       // the ring is free: o_w reuses it
  if (lane < W) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g >= G) break;
      if (cc == 0) l_w[warp * GC + g] = lsum[g];
#pragma unroll
      for (int k = 0; k < NC; ++k)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int d = (cc + k * W) * 8 + e;
          if (d < D) o_w[((size_t)warp * GC + g) * D + d] = acc[k][g][e];
        }
    }
  }
  __syncthreads();
  if constexpr (kFused)
    finish_attend_fused<GC, kRequant>(p, t, m_g, sn_g, ps_g, l_w, o_w, last,
                                      qrow0, bh, s, G);
  else
    finish_attend<GC>(p, t, m_g, l_w, o_w, last, qrow0, s, G);
}

// The FMA passes' kernels. In the exact layout ptxas is told that one
// CTA an SM will do (__launch_bounds__(256, 1)): left to itself it held
// K6's int8 and fp8 attend pass to 80 registers and spilled (K6 14-16%
// slower than the kernel before, on an H100); with the bound they take
// 95. The general layout keeps the plain bound: with the other, its
// instances ran 19-44% slower.
template <int KVF, int GC, int NC, class Rows, bool kFused>
__global__ void __launch_bounds__(256)
decode_score(Par<kFused> p, Rows rows) {
  score_pass<KVF, GC, NC, false, Rows, kFused>(p, rows);
}
template <int KVF, int GC, class Rows, bool kFused>
__global__ void __launch_bounds__(256, 1)
decode_score_exact(Par<kFused> p, Rows rows) {
  score_pass<KVF, GC, 1, true, Rows, kFused>(p, rows);
}
template <int KVF, int GC, int NC, class Rows, bool kFused>
__global__ void __launch_bounds__(256)
decode_attend(Par<kFused> p, Rows rows) {
  attend_pass<KVF, GC, NC, false, Rows, kFused>(p, rows);
}
template <int KVF, int GC, class Rows, bool kFused>
__global__ void __launch_bounds__(256, 1)
decode_attend_exact(Par<kFused> p, Rows rows) {
  attend_pass<KVF, GC, 1, true, Rows, kFused>(p, rows);
}

// Chunks of 8 values a thread takes of a DD-wide row on the tensor-core
// pair: one up to DD 128, DD / 128 past it (two at DD 256, four at 512).
__host__ __device__ constexpr int mma_cpt(int DD) {
  return DD > 128 ? DD / 128 : 1;
}

// The tensor-core pair's rows DD values wide in shared memory: CPR chunks
// of 8 values, kCPT of them a thread (chunks cc + k TPR of its row, k <
// kCPT; past DD 128 TPR stays 16, so that a warp again takes 16 rows, one
// m16 block, a tile), TPR threads a row, kWRG row groups a warp, kBlocks
// m16 blocks a warp a tile.
template <int DD>
struct MmaRows {
  static constexpr int CPR = DD / 8;
  static constexpr int kCPT = mma_cpt(DD);
  static constexpr int TPR = CPR / kCPT;
  static constexpr int kWRG = 32 / TPR;
  static constexpr int kBlocks = kWRG * kUnroll / 16;
};

// GR of the 256- and 512-wide instances: the launch's copy granule, read
// from the bases at run time (one instance for 16, 8 and 4 keeps the
// build short).
constexpr int kGrAny = 1;

// A warp's rows of a tile for the tensor-core path: j = u * kWRG + the
// warp's row group, so that each warp takes 16 (DD 128, 256 and 512) or
// 32 (DD 64) rows; chunk cc of such a row sits at cc ^ (j % 8) in its row
// group's slots, so that the 8 rows an ldmatrix reads fall in 8 bank
// groups.
template <int CPR, int kWRG = 32 / CPR>
__device__ __forceinline__ int mma_slot(int rg, int cc, int u) {
  return rg * CPR + (cc ^ ((u * kWRG + rg % kWRG) & 7));
}

// The cache row of the tile at `base` that a warp's j-th row (j = u kWRG
// + rg % kWRG) holds: base + rg + u RG up to DD 128; past it base + warp
// + nw j. The FMA pair past D 128 takes one row group a warp, 8 warps,
// row group f the rows f mod 8; the 256- and 512-wide pairs run 4 warps
// (nw), so a warp's even rows are FMA row group warp's and its odd rows
// row group warp + 4's, each in order, and K2's int8 row sum keeps FMA's
// order.
template <int DD>
__device__ __forceinline__ int mma_row(int base, int warp, int j, int RG,
                                       int nw) {
  constexpr int kWRG = MmaRows<DD>::kWRG;
  if constexpr (DD > 128)
    return base + warp + nw * j;
  else
    return base + warp * kWRG + j % kWRG + (j / kWRG) * RG;
}

// 1-byte storage on tensor cores: the 4 stored values of a word widened
// to bf16 (exact: int8's integers and every fp8 value are bf16 values),
// values 0, 1 into lo and 2, 3 into hi. int8 takes no conversion
// instruction: each byte x, biased to x + 128, becomes the low byte of the
// fp32 2^23 + x + 128, less 2^23 + 128 gives x exactly, and an integer of
// at most 8 bits keeps its bf16 in the upper half of its fp32 bits. fp8
// goes through Hopper's pairwise conversion to f16.
template <int KVF>
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  uint32_t h[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if constexpr (KVF == 1) {
      const uint32_t u = w ^ 0x80808080u;
      const float f0 = __uint_as_float(__byte_perm(
                           u, 0x4B000000u, 0x7540 | (2 * i))) - 8388736.f;
      const float f1 = __uint_as_float(__byte_perm(
                           u, 0x4B000000u, 0x7540 | (2 * i + 1))) - 8388736.f;
      h[i] = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
    } else {
      const __nv_fp8x2_storage_t pair =
          static_cast<__nv_fp8x2_storage_t>(w >> (16 * i));
      const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
          pair, KVF == 2 ? __NV_E4M3 : __NV_E5M2)));
      h[i] = pack_bf16(f.x, f.y);
    }
  }
  lo = h[0];
  hi = h[1];
}

// One stored chunk of 8 values widened to bf16, or zeros for a row past
// the split.
template <int KVF>
__device__ __forceinline__ uint4 widen_chunk(const uint2& c, bool live) {
  if (!live) return make_uint4(0u, 0u, 0u, 0u);
  uint4 r;
  widen4<KVF>(c.x, r.x, r.y);
  widen4<KVF>(c.y, r.z, r.w);
  return r;
}

// Bytes of the tensor-core pair's ring of `slots` chunks a row step
// (threads * kCPT): Ring's, plus (1-byte storage) the bf16 tile
// [kUnroll][slots] of the stage in use, widened from it.
template <int KVF, int GC>
__host__ __device__ size_t mma_ring_bytes(int slots, int rg, bool scores) {
  return Ring<KVF, GC>::bytes(
             (size_t)slots * sizeof(typename Chunk<KVF>::type), kUnroll,
             rg, scores) +
         (KVF != 0 ? (size_t)kUnroll * slots * 16 : 0);
}

// The shared memory of the tensor-core attend pass before its row max:
// the ring of DD-wide rows (and widened tile), which the warps' partial O
// [nw][GC][D] of the D live columns reuses.
template <int KVF, int GC>
__host__ __device__ size_t mma_union_bytes(int threads, int DD, int D) {
  const int slots = threads * mma_cpt(DD);
  const size_t ring = mma_ring_bytes<KVF, GC>(slots, slots / (DD / 8), true);
  const size_t o_w = (size_t)(threads / 32) * GC * D * 4;
  return ring > o_w ? ring : o_w;
}

// The copy granule of the tensor-core pair over rows of `rb` bytes at
// bases k and v: the largest of 16, 8 and 4 dividing rb and both
// addresses (every row start shares it), or 0 (rows or bases 2- or
// 1-byte aligned: the pair does not take them).
__host__ __device__ inline int mma_granule(const void* k, const void* v,
                                           int rb) {
  const size_t a = (size_t)rb | reinterpret_cast<size_t>(k) |
                   reinterpret_cast<size_t>(v);
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 0;
}

// A thread's chunk of a padded row (kPad): bytes [0, lb) of its kCB hold
// the row's values (lb = (D - 8 cc) E, clamped to [0, kCB]; a multiple of
// GR, which divides every row's bytes and base), copied GR bytes at a
// time into its slot; bytes [lb, kCB) are zeroed once (zero_pad) and
// never written after.
template <int GR, int kCB>
__device__ __forceinline__ void copy_live(void* dst, const char* src,
                                          int lb) {
#pragma unroll
  for (int j = 0; j < kCB / GR; ++j)
    if (j * GR < lb)
      cp_async<GR>(static_cast<char*>(dst) + j * GR, src + j * GR);
}
// f(std::integral_constant<int, G>) at the copy granule G of a launch:
// the instance's GR, or (GR kGrAny) the launch's gr (16, 8 or 4; at most
// kCB), chosen once for a tile's copies: a branch at each of a thread's
// 16 copies a tile made the 256-wide pair slower than the FMA pair.
template <int GR, int kCB, class F>
__device__ __forceinline__ void at_granule(int gr, F&& f) {
  if constexpr (GR != kGrAny)
    f(std::integral_constant<int, GR>{});
  else if (gr >= kCB)
    f(std::integral_constant<int, kCB>{});
  else if (gr == 8)
    f(std::integral_constant<int, 8>{});
  else
    f(std::integral_constant<int, 4>{});
}
template <int kCB>
__device__ __forceinline__ void zero_pad(void* dst, int lb) {
  for (int b = lb; b < kCB; b += 4)
    *reinterpret_cast<uint32_t*>(static_cast<char*>(dst) + b) = 0u;
}

// Pass 1 on tensor cores (bf16 q): each warp takes S^T = K q^T for its
// rows with mma.sync m16n8k16 (A = K rows by ldmatrix, B = q^T held in
// registers, the GC query rows padded to 8), exact products summed in
// fp32. Otherwise as decode_score. Over 1-byte storage (kByte: int8,
// fp8-e4m3, fp8-e5m2; K2, K5 and K6 alike) the ring holds the stored
// chunks and their K scales; each warp widens its own rows of the stage
// in use into a bf16 tile (exact; the bf16 path's slots), then S = (q .
// K_raw) * ks. K2 over int8 (kRequant) first requantizes q to s8 per
// query row as score_pass does, and holds q_s8 as bf16 (integers up to
// 127, exact): the products are integers and their sums, at most 512 *
// 127^2 < 2^24, exact in fp32 in any order, so S = (dot * q scale) * ks
// is score_pass's S bit for bit.
// Rows are DD (64, 128, 256 or 512) values wide in shared memory
// (MmaRows; at DD 256 a thread takes two chunks of its row, at 512
// four). GR 0: D = DD, rows whole 16-byte chunks (8-byte for 1-byte
// storage), each copied by one cp.async. GR 16, 8 or 4 (kPad: 64 <= D <=
// 128 on the 128-wide instances), and kGrAny (128 < D <= 256 on the
// 256-wide ones, 256 < D <= 512 on the 512-wide ones): rows of D values
// at stride D in the cache, padded with zeros to DD in the slots
// (zero_pad, once a CTA); a thread copies the live bytes of its chunks GR
// at a time (copy_live, at_granule), and column blocks past D are
// skipped. Past DD 256 each k step's products start from zero and are
// added in fp32: chained in one accumulator over 17-32 steps, the tensor
// cores' sums drifted from fp64 further than FMA's, and a P rounded to
// bf16 on the other side of a step moved O past its budget where O
// cancels. The fresh form is as close to fp64 at DD 256 and below too;
// those widths keep the chained accumulator only so that their machine
// code, and the output bits chip_smoke.py records, stay as they were.
template <int KVF, int GC, int DD, int GR, class Rows, bool kFused>
__global__ void __launch_bounds__(256)
decode_score_mma(Par<kFused> p, Rows rows) {
  using L = MmaRows<DD>;
  constexpr bool kByte = KVF != 0, kPad = GR != 0;
  constexpr bool kRequant = kFused && KVF == 1;
  constexpr int CPR = L::CPR, kCPT = L::kCPT, TPR = L::TPR;
  constexpr int kWRG = L::kWRG, kBlocks = L::kBlocks;
  constexpr int kE = kByte ? 1 : 2, kCB = 8 * kE;  // bytes a value, a chunk
  const int bh = blockIdx.x, b = bh / p.hkv, h = bh - b * p.hkv;
  const int g0 = blockIdx.y * GC, G = min(GC, p.group - g0), s = blockIdx.z;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, nw = T >> 5, D = kPad ? p.D : DD;
  const int RG = T / TPR, TR = RG * kUnroll, TS = T * kCPT;
  const int cc = tid % TPR, rg = tid / TPR;
  // kPad: the live bytes of this thread's chunks cc + k TPR.
  int lb[kCPT];
#pragma unroll
  for (int k = 0; k < kCPT; ++k)
    lb[k] = kPad ? min(kCB, max(0, (D - (cc + k * TPR) * 8) * kE)) : kCB;
  const int gr = GR == kGrAny ? mma_granule(p.k, p.v, D * kE) : GR;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr size_t kTile = sizeof(typename Chunk<KVF>::type);
  const Ring<KVF, GC> ring(smem, TS * kTile, kUnroll, RG, false);
  uint4* wide = reinterpret_cast<uint4*>(
      smem + Ring<KVF, GC>::bytes(TS * kTile, kUnroll, RG,
                                  false));        // kByte: [kUnroll][TS]
  float* red = reinterpret_cast<float*>(
      smem + mma_ring_bytes<KVF, GC>(TS, RG, false));  // [nw][GC]
  int* ids = reinterpret_cast<int*>(red + nw * GC);  // page ids

  griddep_launch_dependents();           // decode_attend may start its V
  const int cap = rows.capacity();
  const Split t = split_of<kFused>(p, cap, b, s);
  if (s == 0 && tid == 0) p.arrived[bh * gridDim.y + blockIdx.y] = 0;
  if constexpr (kFused)
    if (blockIdx.y == 0 && t.len < cap && s == t.len / p.split_rows)
      append_new_row<KVF>(p, bh, rows(bh, h, t.len), red);
  if (t.s_lo >= t.s_hi) return;
  Rows at = rows;
  at.bind(ids, b, t.s_lo, t.s_hi);
  // The slot of this thread's chunk k in stage st, row u of its group.
  auto kslot = [&](int st, int u, int k) -> void* {
    return kByte ? (void*)(ring.chunk + (st * kUnroll + u) * TS + k * T + tid)
                 : (void*)(reinterpret_cast<uint4*>(ring.chunk) +
                           (st * kUnroll + u) * TS +
                           mma_slot<CPR, kWRG>(rg, cc + k * TPR, u));
  };
  // This thread's row of step u in the tile at base (mma_row).
  auto own_row = [&](int base, int u) {
    if constexpr (DD > 128)
      return base + warp + nw * (u * kWRG + rg % kWRG);
    else
      return base + rg + u * RG;
  };
  if constexpr (kPad) {
#pragma unroll
    for (int k = 0; k < kCPT; ++k)
      if (lb[k] < kCB)
#pragma unroll
        for (int st = 0; st < kStages; ++st)
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            zero_pad<kCB>(kslot(st, u, k), lb[k]);
  }
  __syncthreads();
  const size_t qrow0 = (size_t)bh * p.group + g0;
  float* sc = p.scratch + ((size_t)bh * gridDim.y + blockIdx.y) * cap * GC;
  const int ntiles = (t.s_hi - t.s_lo + TR - 1) / TR;
  // This thread's chunk in the cache, from a row's first byte.
  const char* kb = static_cast<const char*>(p.k) + cc * kCB;
  const size_t rb = (size_t)D * kE;

  auto issue = [&](int i) {
    at_granule<GR, kCB>(gr, [&](auto g) {
      constexpr int kG = decltype(g)::value;
      if (i < ntiles) {
        const int base = t.s_lo + i * TR, st = i % kStages;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int l = own_row(base, u);
          if (l < t.s_hi) {
            const size_t r = at(bh, h, l);
#pragma unroll
            for (int k = 0; k < kCPT; ++k) {
              if constexpr (kPad)
                copy_live<kG, kCB>(kslot(st, u, k),
                                   kb + r * rb + k * TPR * kCB, lb[k]);
              else
                cp_async<kCB>(kslot(st, u, k), kb + r * rb + k * TPR * kCB);
            }
            if (kByte && cc == 0)
              cp_async<4>(ring.scale + (st * kUnroll + u) * RG + rg,
                          p.k_scale + r);
          }
        }
      }
    });
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // q^T as B fragments: query row lane / 4 (zero past G), columns
  // 16 ks + 2 (lane % 4) + {0, 1} and those + 8 (zero past D; D is even
  // wherever the pair runs, so a pair of columns is live or dead whole).
  const int gq = lane >> 2, dq = (lane & 3) * 2;
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(p.q) +
                            (qrow0 + min(gq, G - 1)) * D + dq;
  float qx[DD / 16][4];
#pragma unroll
  for (int ks = 0; ks < DD / 16; ++ks) {
    const bool lo = !kPad || ks * 16 + dq < D,
               hi = !kPad || ks * 16 + 8 + dq < D;
    qx[ks][0] = lo ? __bfloat162float(qp[ks * 16]) : 0.f;
    qx[ks][1] = lo ? __bfloat162float(qp[ks * 16 + 1]) : 0.f;
    qx[ks][2] = hi ? __bfloat162float(qp[ks * 16 + 8]) : 0.f;
    qx[ks][3] = hi ? __bfloat162float(qp[ks * 16 + 9]) : 0.f;
  }
  // kRequant: the query row's s8 scale over its D values (its four
  // lanes), then q_s8 = round(q / scale) clipped at +-127, as score_pass.
  float qsc = 1.f;
  if constexpr (kRequant) {
    float a = 0.f;
#pragma unroll
    for (int ks = 0; ks < DD / 16; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) a = fmaxf(a, fabsf(qx[ks][e]));
    a = fmaxf(a, __shfl_xor_sync(kFull, a, 1));
    a = fmaxf(a, __shfl_xor_sync(kFull, a, 2));
    qsc = fmaxf(a, 1e-30f) * kInv127;
#pragma unroll
    for (int ks = 0; ks < DD / 16; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qx[ks][e] = fminf(fmaxf(rintf(qx[ks][e] / qsc), -127.f), 127.f);
  }
  uint32_t qb[DD / 16][2];
#pragma unroll
  for (int ks = 0; ks < DD / 16; ++ks) {
    qb[ks][0] = gq < G ? pack_bf16(qx[ks][0], qx[ks][1]) : 0u;
    qb[ks][1] = gq < G ? pack_bf16(qx[ks][2], qx[ks][3]) : 0u;
  }

  // This lane's C entries: rows j = 16 nb + lane / 4 (+ 8), query rows
  // gc and gc + 1.
  const int gc = (lane & 3) * 2;
  // kRequant: their q scales (query row g's is lane 4 g's).
  float qs0 = 1.f, qs1 = 1.f;
  if constexpr (kRequant) {
    qs0 = __shfl_sync(kFull, qsc, 4 * gc);
    qs1 = __shfl_sync(kFull, qsc, 4 * gc + 4);
  }
  float m0 = kMaskValue, m1 = kMaskValue;
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncwarp();
    issue(i + kStages - 1);
    const int base = t.s_lo + i * TR, st = i % kStages;
    const uint4* tile;
    if constexpr (kByte) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool live = own_row(base, u) < t.s_hi;
#pragma unroll
        for (int k = 0; k < kCPT; ++k)
          wide[u * TS + mma_slot<CPR, kWRG>(rg, cc + k * TPR, u)] =
              widen_chunk<KVF>(
                  ring.chunk[(st * kUnroll + u) * TS + k * T + tid], live);
      }
      __syncwarp();
      tile = wide;
    } else {
      tile =
          reinterpret_cast<const uint4*>(ring.chunk) + (st * kUnroll) * TS;
    }
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      // ldmatrix rows: j = 16 nb + lane % 8 (+ 8 for matrices 1 and 3),
      // chunk 2 ks (+ 1 for matrices 2 and 3).
      const int j = nb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int u = j / kWRG, r = warp * kWRG + j % kWRG;
#pragma unroll
      for (int ks = 0; ks < DD / 16; ++ks) {
        if (kPad && ks * 16 >= D) break;
        uint32_t a[4];
        ldsm_x4(a, tile + u * TS +
                       mma_slot<CPR, kWRG>(r, ks * 2 + (lane >> 4), u));
        if constexpr (DD > 256) {
          float z[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(z, a, qb[ks][0], qb[ks][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) c[e] += z[e];
        } else {
          mma_bf16(c, a, qb[ks][0], qb[ks][1]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int jr = nb * 16 + (lane >> 2) + hh * 8;
        const int l = mma_row<DD>(base, warp, jr, RG, nw);
        if (l < t.s_hi && gc < GC) {
          if constexpr (kByte) {
            const float ks = ring.scale[(st * kUnroll + jr / kWRG) * RG +
                                        warp * kWRG + jr % kWRG];
            // score_pass's order: (dot * q scale) * ks.
            if constexpr (kRequant) {
              c[2 * hh] = c[2 * hh] * qs0 * ks;
              c[2 * hh + 1] = c[2 * hh + 1] * qs1 * ks;
            } else {
              c[2 * hh] *= ks;
              c[2 * hh + 1] *= ks;
            }
          }
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

// Pass 2 on tensor cores (bf16 q): each warp takes O^T += V^T P^T for
// its rows with mma.sync (A = V^T by ldmatrix.trans, B = P^T formed in
// registers: each lane exponentiates its four (row, query row) pairs a
// block against the final max and rounds them to bf16). Rows past the
// split are zero-filled in the ring. Otherwise as decode_attend. Over
// 1-byte storage as decode_score_mma: the stored V chunks and scales in
// the ring, each warp's rows widened to bf16 (rows past the split as
// zeros), and P times the V scale before its rounding. K2 over int8
// (kRequant) keeps attend_pass's arithmetic bit for bit: P vs becomes
// s8 against the P scale of decode_pmax (integers up to 127, exact in
// bf16), so P V sums integers, at most 1024 * 127^2 < 2^24 a split
// (DECODE_SPLIT_MAX_ROWS), exact in fp32 in any order; the row sum of P,
// not an integer, is summed in attend_pass's order, by lanes of its own:
// up to DD 128 each row group's rows in tile and row order, then the row
// groups of a warp pairwise, as its butterfly; past DD 128 each of the
// FMA pair's row groups in row order (mma_row: a warp's even and odd
// rows), then the groups in order through shared memory.
// GR and the padded rows as decode_score_mma's; the partial O holds the
// D live columns (finish_attend's stride).
template <int KVF, int GC, int DD, int GR, class Rows, bool kFused>
__global__ void __launch_bounds__(256)
decode_attend_mma(Par<kFused> p, Rows rows) {
  using L = MmaRows<DD>;
  constexpr bool kByte = KVF != 0, kPad = GR != 0;
  constexpr bool kRequant = kFused && KVF == 1;
  constexpr int CPR = L::CPR, kCPT = L::kCPT, TPR = L::TPR;
  constexpr int kWRG = L::kWRG, kBlocks = L::kBlocks;
  constexpr int kE = kByte ? 1 : 2, kCB = 8 * kE;  // bytes a value, a chunk
  const int bh = blockIdx.x, b = bh / p.hkv, h = bh - b * p.hkv;
  const int g0 = blockIdx.y * GC, G = min(GC, p.group - g0), s = blockIdx.z;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, nw = T >> 5, D = kPad ? p.D : DD;
  const int RG = T / TPR, TR = RG * kUnroll, TS = T * kCPT;
  const int cc = tid % TPR, rg = tid / TPR;
  int lb[kCPT];
#pragma unroll
  for (int k = 0; k < kCPT; ++k)
    lb[k] = kPad ? min(kCB, max(0, (D - (cc + k * TPR) * 8) * kE)) : kCB;
  const int gr = GR == kGrAny ? mma_granule(p.k, p.v, D * kE) : GR;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr size_t kTile = sizeof(typename Chunk<KVF>::type);
  const Ring<KVF, GC> ring(smem, TS * kTile, kUnroll, RG, true);
  uint4* wide = reinterpret_cast<uint4*>(
      smem + Ring<KVF, GC>::bytes(TS * kTile, kUnroll, RG,
                                  true));         // kByte: [kUnroll][TS]
  float* o_w = reinterpret_cast<float*>(smem);  // [nw][GC][D], after the loop
  float* m_g = reinterpret_cast<float*>(
      smem + mma_union_bytes<KVF, GC>(T, DD, D));  // [GC] row max
  float* l_w = m_g + GC;                          // [nw][GC] row sums
  int* last = reinterpret_cast<int*>(l_w + nw * GC);
  int* ids = last + 1;                            // page ids
  float* sn_g = reinterpret_cast<float*>(
      ids + rows.table_ints(p.split_rows));       // K2: [GC] s_new
  float* ps_g = sn_g + GC;                        // K2: [GC] P scale

  const int cap = rows.capacity();
  const Split t = split_of<kFused>(p, cap, b, s);
  const size_t qrow0 = (size_t)bh * p.group + g0;
  if (t.last < t.first) {                // no live row: O = 0 (fused:
    if (s == 0)                          // v_new), by split 0
      for (int idx = tid; idx < G * D; idx += blockDim.x) {
        float o = 0.f;
        if constexpr (kFused)
          o = load_q(p.v_new, (size_t)bh * D + idx % D, p.q_bf16);
        store_o(p, qrow0 * D + idx, o);
      }
    return;
  }
  if (t.s_lo >= t.s_hi) return;
  Rows at = rows;
  at.bind(ids, b, t.s_lo, t.s_hi);
  auto vslot = [&](int st, int u, int k) -> void* {
    return kByte ? (void*)(ring.chunk + (st * kUnroll + u) * TS + k * T + tid)
                 : (void*)(reinterpret_cast<uint4*>(ring.chunk) +
                           (st * kUnroll + u) * TS +
                           mma_slot<CPR, kWRG>(rg, cc + k * TPR, u));
  };
  auto own_row = [&](int base, int u) {
    if constexpr (DD > 128)
      return base + warp + nw * (u * kWRG + rg % kWRG);
    else
      return base + rg + u * RG;
  };
  if constexpr (kPad) {
#pragma unroll
    for (int k = 0; k < kCPT; ++k)
      if (lb[k] < kCB)
#pragma unroll
        for (int st = 0; st < kStages; ++st)
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            zero_pad<kCB>(vslot(st, u, k), lb[k]);
  }
  __syncthreads();
  const float* sc =
      p.scratch + ((size_t)bh * gridDim.y + blockIdx.y) * cap * GC;
  const int ntiles = (t.s_hi - t.s_lo + TR - 1) / TR;
  const char* vb = static_cast<const char*>(p.v);

  // As decode_attend's, with the V rows past the split zero-filled (kByte:
  // when widened; kPad: whole chunks holding live columns, by a
  // zero-source copy that reads nothing).
  auto issue_v_at = [&](int i, auto g) {
    constexpr int kG = decltype(g)::value;
    if (i >= ntiles) return;
    const int base = t.s_lo + i * TR, st = i % kStages;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = own_row(base, u);
      const bool live = l < t.s_hi;
      if constexpr (kPad) {
        if (live) {
          const size_t r = at(bh, h, l);
#pragma unroll
          for (int k = 0; k < kCPT; ++k)
            copy_live<kG, kCB>(vslot(st, u, k),
                               vb + r * D * kE + (cc + k * TPR) * kCB,
                               lb[k]);
          if (kByte && cc == 0)
            cp_async<4>(ring.scale + (st * kUnroll + u) * RG + rg,
                        p.v_scale + r);
        } else if (!kByte) {
#pragma unroll
          for (int k = 0; k < kCPT; ++k)
            if (lb[k] > 0)
              // The source is read by no byte; its address is kept
              // aligned.
              cp_async16(vslot(st, u, k),
                         reinterpret_cast<const void*>(
                             reinterpret_cast<size_t>(vb) & ~(size_t)15),
                         0);
        }
      } else if constexpr (kByte) {
        if (live) {
          const size_t r = at(bh, h, l);
#pragma unroll
          for (int k = 0; k < kCPT; ++k)
            cp_async<8>(ring.chunk + (st * kUnroll + u) * TS + k * T + tid,
                        vb + r * DD + (cc + k * TPR) * 8);
          if (cc == 0)
            cp_async<4>(ring.scale + (st * kUnroll + u) * RG + rg,
                        p.v_scale + r);
        }
      } else {
        const __nv_bfloat16* v16 = static_cast<const __nv_bfloat16*>(p.v);
#pragma unroll
        for (int k = 0; k < kCPT; ++k)
          cp_async16(vslot(st, u, k),
                     live ? v16 + at(bh, h, l) * DD + (cc + k * TPR) * 8
                          : v16,
                     live ? 16 : 0);
      }
    }
  };
  auto issue_v = [&](int i) {
    at_granule<GR, kCB>(gr, [&](auto g) { issue_v_at(i, g); });
  };
  auto issue_s = [&](int i) {
    if (i >= ntiles || cc != 0) return;
    const int base = t.s_lo + i * TR, st = i % kStages;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = own_row(base, u);
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

  if constexpr (kFused)
    final_max_fused<kRequant>(p, t, qrow0, bh, G, m_g, sn_g, ps_g);
  else
    final_max(p, t, qrow0, G, m_g);
  __syncthreads();

  // B = P^T: this lane's query row gp = lane / 4 and rows
  // 16 nb + 2 (lane % 4) + {0, 1, 8, 9}.
  const int gp = lane >> 2;
  const float m_r = gp < G ? m_g[gp] : 0.f;
  float ps_r = 1.f;                      // kRequant: P's s8 scale
  if constexpr (kRequant) ps_r = gp < G ? ps_g[gp] : 1.f;
  // kRequant: this lane sums the row sum of query row lg over the rows of
  // the warp's row group lr (attend_pass's lanes of that row group; past
  // DD 128 over the warp's rows).
  const int lg = lane & 7, lr = warp * kWRG + ((lane >> 3) & (kWRG - 1));
  const float m_l = kRequant && lg < G ? m_g[lg] : 0.f;
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
    const uint4* tile;
    if constexpr (kByte) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool live = own_row(base, u) < t.s_hi;
#pragma unroll
        for (int k = 0; k < kCPT; ++k)
          wide[u * TS + mma_slot<CPR, kWRG>(rg, cc + k * TPR, u)] =
              widen_chunk<KVF>(
                  ring.chunk[(st * kUnroll + u) * TS + k * T + tid], live);
      }
      __syncwarp();
      tile = wide;
    } else {
      tile =
          reinterpret_cast<const uint4*>(ring.chunk) + (st * kUnroll) * TS;
    }
    const float* scores = ring.score + (st * kUnroll) * RG * GC;
    if constexpr (kRequant && DD > 128) {
      // Lanes 8 h + lg: the warp's rows of parity h (rows warp + 4 h mod
      // 8 of the split: the FMA pair's row group warp + nw h) in order.
#pragma unroll
      for (int j = 0; j < kWRG * kUnroll; ++j)
        if ((j & 1) == ((lane >> 3) & 1) && lg < G &&
            mma_row<DD>(base, warp, j, RG, nw) < t.s_hi)
          lsum += exp2f(scores[((j / kWRG) * RG + warp * kWRG + j % kWRG) *
                                   GC + lg] - m_l);
    } else if constexpr (kRequant) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (lg < G && base + lr + u * RG < t.s_hi)
          lsum += exp2f(scores[(u * RG + lr) * GC + lg] - m_l);
    }
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb) {
      float pw[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = nb * 16 + (lane & 3) * 2 + (e & 1) + (e >> 1) * 8;
        const int u = jj / kWRG, r = warp * kWRG + jj % kWRG;
        float pe = 0.f, vs = 1.f;
        if (gp < G && (DD > 128 ? mma_row<DD>(base, warp, jj, RG, nw)
                                : base + r + u * RG) < t.s_hi) {
          pe = exp2f(scores[(u * RG + r) * GC + gp] - m_r);
          if constexpr (kByte) vs = ring.scale[(st * kUnroll + u) * RG + r];
        }
        if constexpr (kRequant) {
          pw[e] = fminf(fmaxf(rintf(pe * vs / ps_r), -127.f), 127.f);
        } else {
          lsum += pe;
          pw[e] = kByte ? pe * vs : pe;
        }
      }
      const uint32_t b0 = pack_bf16(pw[0], pw[1]), b1 = pack_bf16(pw[2], pw[3]);
      // ldmatrix.trans rows: j = 16 nb + lane % 8 (+ 8 for matrices 2 and
      // 3), chunk 2 db (+ 1 for matrices 1 and 3).
      const int j = nb * 16 + (lane & 7) + (lane >> 4) * 8;
      const int u = j / kWRG, r = warp * kWRG + j % kWRG;
#pragma unroll
      for (int db = 0; db < DD / 16; ++db) {
        if (kPad && db * 16 >= D) break;
        uint32_t a[4];
        ldsm_x4_t(a, tile + u * TS +
                         mma_slot<CPR, kWRG>(r, db * 2 + ((lane >> 3) & 1),
                                             u));
        mma_bf16(acc[db], a, b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // Row sums over the four lanes of a query row (kRequant: over the
  // warp's row groups, as attend_pass's butterfly; past DD 128 one lane a
  // query row and FMA row group holds them); then each warp's partial
  // O^T (rows d, columns gc and gc + 1) and sums into shared memory, which
  // the ring no longer needs.
  if constexpr (kRequant) {
    if constexpr (DD <= 128)
#pragma unroll
      for (int o = 8; o < 8 * kWRG; o <<= 1)
        lsum += __shfl_xor_sync(kFull, lsum, o);
  } else {
    lsum += __shfl_xor_sync(kFull, lsum, 1);
    lsum += __shfl_xor_sync(kFull, lsum, 2);
  }
  __syncthreads();
  if constexpr (kRequant && DD > 128) {
    // The FMA pair's 2 nw row groups' sums (part, past the partial O in
    // the ring's space), added in its order into l_w's first row; the
    // other warps' rows add zeros (exact) where the partials meet.
    float* part = o_w + (size_t)nw * GC * D;    // [2 nw][GC]
    if (lane < 16 && lg < G)
      part[(warp + ((lane >> 3) & 1) * nw) * GC + lg] = lsum;
    __syncthreads();
    if (tid < G) {
      float l = 0.f;
      for (int f = 0; f < 2 * nw; ++f) l += part[f * GC + tid];
      for (int w = 0; w < nw; ++w) l_w[w * GC + tid] = w == 0 ? l : 0.f;
    }
  } else if constexpr (kRequant) {
    if (lane < G) l_w[warp * GC + lane] = lsum;
  } else if ((lane & 3) == 0 && gp < G) {
    l_w[warp * GC + gp] = lsum;
  }
  const int gc = (lane & 3) * 2;
#pragma unroll
  for (int db = 0; db < DD / 16; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = db * 16 + (lane >> 2) + (e >> 1) * 8, g = gc + (e & 1);
      if (g < G && (!kPad || d < D))
        o_w[((size_t)warp * GC + g) * D + d] = acc[db][e];
    }
  __syncthreads();
  if constexpr (kFused)
    finish_attend_fused<GC, kRequant>(p, t, m_g, sn_g, ps_g, l_w, o_w,
                                      last, qrow0, bh, s, G);
  else
    finish_attend<GC>(p, t, m_g, l_w, o_w, last, qrow0, s, G);
}

// K2 over an int8 cache, between the two passes: each split's max of
// |P vs| = exp2(S - m) vs over its rows, against the final max m (s_new
// included), into pa_part; decode_attend takes the max over the live
// splits as P's s8 scale, so that P rounds against the scale of every
// live row, as the plain version's does. Every CTA waits for
// decode_score first, so that this grid's end implies decode_score's.
template <int GC>
__global__ void __launch_bounds__(256)
decode_pmax(FusedParams p, FusedRows rows) {
  griddep_launch_dependents();           // decode_attend may start its V
  griddep_wait();
  const int bh = blockIdx.x, b = bh / p.hkv, h = bh - b * p.hkv;
  const int g0 = blockIdx.y * GC, G = min(GC, p.group - g0), s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  __shared__ float m_g[GC], sn_g[GC], red[8 * GC];   // at most 8 warps
  const int cap = rows.capacity();
  const Split t = split_of<true>(p, cap, b, s);
  if (t.s_lo >= t.s_hi) return;
  const size_t qrow0 = (size_t)bh * p.group + g0;
  final_max_fused<false>(p, t, qrow0, bh, G, m_g, sn_g, nullptr);
  __syncthreads();
  const float* sc =
      p.scratch + ((size_t)bh * gridDim.y + blockIdx.y) * cap * GC;
  float pa[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) pa[g] = 0.f;
  for (int l = t.s_lo + tid; l < t.s_hi; l += blockDim.x) {
    const float vs = p.v_scale[rows(bh, h, l)];
#pragma unroll
    for (int g = 0; g < GC; ++g)
      if (g < G)
        pa[g] = fmaxf(pa[g], fabsf(exp2f(sc[(size_t)l * GC + g] - m_g[g]) *
                                   vs));
  }
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    pa[g] = warp_max(pa[g]);
    if (lane == 0) red[warp * GC + g] = pa[g];
  }
  __syncthreads();
  if (tid < G) {
    float a = 0.f;
    for (int w = 0; w < nw; ++w) a = fmaxf(a, red[w * GC + tid]);
    p.pa_part[(qrow0 + tid) * p.splits + s] = a;
  }
}

// Sets a kernel's shared memory and launches it on the caller's stream;
// `overlap`: as a programmatic dependent of the kernel before it (its
// CTAs may start before that kernel ends, and wait in griddep_wait).
template <class P, class Rows>
cudaError_t launch_one(void (*kernel)(P, Rows), dim3 grid, int threads,
                       size_t smem, cudaStream_t stream, bool overlap,
                       const P& p, const Rows& rows) {
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

// Shared memory a block may opt into on the H100 (227 KiB).
constexpr size_t kSmemOptin = 232448;

// The path of a launch, as the host names it (ops/params.py::
// DECODE_PATHS): the FMA pair in RowLayout's general rows or its exact
// layout, or the tensor-core pair at its copy granule (16, 8 or 4).
constexpr int kPathFma = 0, kPathFmaExact = 1;

// The passes of one call: decode_score, then (K2 over an int8 cache)
// decode_pmax, then decode_attend, each a programmatic dependent of the
// one before. The host chooses the pair from shapes and addresses alone
// and names it in `path`; a launch whose path is another, whose layout
// is past the H100's shared memory, or whose FMA pair would read a cache
// not 16-byte aligned, is refused (nothing is retried on another path).
template <int KVF, int GC, bool kFused, class Rows>
int launch_passes(const Par<kFused>& p, const Rows& rows, dim3 grid,
                  int threads, int path, cudaStream_t stream) {
  const int nw = threads / 32;
  const size_t table = sizeof(int) * rows.table_ints(p.split_rows);
  const RowLayout lay(p.D, KVF == 0 ? 2 : 1, threads);
  const bool two = lay.nc() == 2;
  void (*score)(Par<kFused>, Rows) =
      lay.exact ? decode_score_exact<KVF, GC, Rows, kFused>
      : two     ? decode_score<KVF, GC, 2, Rows, kFused>
                : decode_score<KVF, GC, 1, Rows, kFused>;
  void (*attend)(Par<kFused>, Rows) =
      lay.exact ? decode_attend_exact<KVF, GC, Rows, kFused>
      : two     ? decode_attend<KVF, GC, 2, Rows, kFused>
                : decode_attend<KVF, GC, 1, Rows, kFused>;
  size_t ring = fma_ring_bytes<KVF, GC>(
      lay, two ? kUnrollOf<2> : kUnrollOf<1>, threads, false);
  size_t attend_ring = attend_union_bytes<KVF, GC>(threads, p.D);
  int chosen = lay.exact ? kPathFmaExact : kPathFma;
  // bf16 q at 64 <= D <= 512 over any storage type whose rows and bases
  // share a granule of 4 bytes or more: the tensor-core pair (1-byte
  // storage widened to bf16 by each warp; K2 over int8 keeps its s8
  // requantization exact). D 64 and 128 at granule 16 keep their own
  // instances (GR 0); the rest up to D 128 run the 128-wide ones on rows
  // padded with zeros, copied a granule at a time (8 bytes at most over
  // 1-byte storage, whose chunks are 8 bytes), past D 128 the 256-wide
  // ones and past D 256 the 512-wide ones, which read the granule from
  // the bases (kGrAny).
  const int gr = mma_granule(p.k, p.v, p.D * (KVF == 0 ? 2 : 1));
  if (p.q_bf16 && p.D >= 64 && p.D <= 512 && gr >= 4) {
    constexpr int kG16 = KVF == 0 ? 16 : 8;
    const bool own = gr == 16 && (p.D == 64 || p.D == 128);
    const int dd = own ? p.D : p.D > 256 ? 512 : p.D > 128 ? 256 : 128;
    chosen = gr;
    // The host gives the 256- and 512-wide CTAs 128 threads; K2 over int8
    // takes no other count there (its row sum takes the FMA pair's row
    // groups, 2 nw of them, FMA running 256 threads).
    if (kFused && KVF == 1 && dd > 128 && threads != 128)
      return cudaErrorInvalidValue;
    if (own) {
      score = p.D == 64 ? decode_score_mma<KVF, GC, 64, 0, Rows, kFused>
                        : decode_score_mma<KVF, GC, 128, 0, Rows, kFused>;
      attend = p.D == 64 ? decode_attend_mma<KVF, GC, 64, 0, Rows, kFused>
                         : decode_attend_mma<KVF, GC, 128, 0, Rows, kFused>;
    } else if (dd == 512) {
      score = decode_score_mma<KVF, GC, 512, kGrAny, Rows, kFused>;
      attend = decode_attend_mma<KVF, GC, 512, kGrAny, Rows, kFused>;
    } else if (dd == 256) {
      score = decode_score_mma<KVF, GC, 256, kGrAny, Rows, kFused>;
      attend = decode_attend_mma<KVF, GC, 256, kGrAny, Rows, kFused>;
    } else {
      score = gr == 4   ? decode_score_mma<KVF, GC, 128, 4, Rows, kFused>
              : gr == 8 ? decode_score_mma<KVF, GC, 128, 8, Rows, kFused>
                        : decode_score_mma<KVF, GC, 128, kG16, Rows, kFused>;
      attend = gr == 4 ? decode_attend_mma<KVF, GC, 128, 4, Rows, kFused>
               : gr == 8
                   ? decode_attend_mma<KVF, GC, 128, 8, Rows, kFused>
                   : decode_attend_mma<KVF, GC, 128, kG16, Rows, kFused>;
    }
    const int slots = threads * mma_cpt(dd);
    ring = mma_ring_bytes<KVF, GC>(slots, slots / (dd / 8), false);
    attend_ring = mma_union_bytes<KVF, GC>(threads, dd, p.D);
  }
  if (chosen != path) return cudaErrorInvalidValue;
  if (chosen <= kPathFmaExact &&
      (reinterpret_cast<size_t>(p.k) | reinterpret_cast<size_t>(p.v)) % 16)
    return cudaErrorInvalidValue;
  const size_t score_smem = ring + sizeof(float) * nw * GC + table;
  const size_t attend_smem = attend_ring + sizeof(float) * (GC + nw * GC) +
                             sizeof(int) + table +
                             (kFused ? sizeof(float) * 2 * GC : 0);
  if (score_smem > kSmemOptin || attend_smem > kSmemOptin)
    return cudaErrorInvalidValue;
  cudaError_t err = launch_one(score, grid, threads, score_smem, stream,
                               false, p, rows);
  if (err != cudaSuccess) return err;
  if constexpr (kFused && KVF == 1) {
    err = launch_one(decode_pmax<GC>, grid, threads, 0, stream, true, p,
                     rows);
    if (err != cudaSuccess) return err;
  }
  return launch_one(attend, grid, threads, attend_smem, stream, true, p,
                    rows);
}

// Checks the launch shape, carves the workspace, picks the storage
// format's and query chunk's instances and launches the passes on the
// host's `path` (launch_passes).
template <bool kFused, class Rows>
int launch(Par<kFused> p, const Rows& rows, void* workspace, int n,
           int kv_format, int group_chunk, int threads, int path,
           void* stream) {
  const int cap = rows.capacity();
  if (p.group < 1 || p.hkv < 1 || n < 1 || n % p.hkv != 0 || p.D < 1 ||
      p.D > kMaxHeadDim || threads % 32 != 0 || threads < 32 ||
      threads > 256 || cap < 0 ||
      p.split_rows < 1 || (p.split_rows & (p.split_rows - 1)) != 0 ||
      (group_chunk != 4 && group_chunk != 8))
    return cudaErrorInvalidValue;
  p.splits = cap > 0 ? (cap + p.split_rows - 1) / p.split_rows : 1;
  const int chunks = (p.group + group_chunk - 1) / group_chunk;
  if (p.splits > 65535 || chunks > 65535) return cudaErrorInvalidValue;
  // Workspace (fp32): scratch, m_part, l_part, o_part, the counters, then
  // (K2) pa_part.
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
  if constexpr (kFused)
    p.pa_part = reinterpret_cast<float*>(p.arrived + n * chunks);

  const dim3 grid(n, chunks, p.splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = group_chunk == 8;
  auto run = [&](auto kvf) {
    constexpr int KVF = decltype(kvf)::value;
    return wide ? launch_passes<KVF, 8, kFused>(p, rows, grid, threads, path,
                                                st)
                : launch_passes<KVF, 4, kFused>(p, rows, grid, threads, path,
                                                st);
  };
  switch (kv_format) {
    case 0: return run(std::integral_constant<int, 0>{});
    case 1: return run(std::integral_constant<int, 1>{});
    case 2: return run(std::integral_constant<int, 2>{});
    case 3: return run(std::integral_constant<int, 3>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
