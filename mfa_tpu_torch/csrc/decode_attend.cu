// One-token GQA decode attention over a KV cache, read directly (K5) or
// through page tables (K6), for Hopper (sm_90a). This file holds K5's
// entry; K6's is csrc/paged_decode.cu (a translation unit of its own, so
// that the two build in parallel), the notes below cover both.
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
// Inside a CTA (decode_split.cuh::RowLayout): W adjacent lanes share a
// cache row (W = min(32, the next power of two >= ceil(D / 8))), each
// taking 8-value chunks cc and cc + W of it (16 bytes of bf16, 8 of int8
// and fp8; the last read as zeros past D); a tile is kUnroll rows a lane
// group (half past D = 256, where a lane takes two chunks). Any D up to
// 512 runs: a row of D 100 is 200 bytes (8-byte aligned) in bf16 and 100
// (4-byte) in int8 and fp8, D 250's 500 and 250. So each warp copies the
// run of consecutive rows its lane groups take as whole 16-byte granules
// (cp.async), aligned in the cache and in shared memory, the run placed
// at its cache offset mod 16 in its slot; the lanes read their chunks at
// the alignment every row shares. At D = 8 * 2^k <= 256 each thread
// copies and reads its own chunk instead (RowLayout::exact): no offset
// or mask to reckon a row. The cache keeps D values a row: no padding to
// 8 or 128. The tiles stream through a ring of kStages in
// shared memory, two in flight while a third is used; a lane group's
// first lane copies the row's scale and scores; a warp reads only rows it
// copied, after a warp barrier, so no CTA barrier sits in the loop. In K6
// a split reads the page ids its rows need into shared memory once, and
// a run is cut where a page ends (pages whose bytes are not a multiple of
// 16 bytes, which the paged cache's 128-token pages never are, go byte by
// byte).
//
// Two arithmetic paths, chosen by the launch from shapes and addresses
// (K5 and K6 alike; the wrapper names the path and the launch refuses
// another, decode_split.cuh::launch_passes):
//  - bf16 q at 64 <= D <= 512 over any storage type (bf16, int8,
//    fp8-e4m3, fp8-e5m2) whose rows and base share a copy granule of 4
//    bytes or more: tensor cores. A warp takes S^T = K q^T and O^T = V^T
//    P^T for its 16 or 32 rows with mma.sync m16n8k16 (K and V by
//    ldmatrix from the ring, its chunks swizzled so that ldmatrix reads
//    no bank twice; q^T and P^T in registers, the query rows padded to
//    8). An int8 or fp8 tile is widened to bf16 by the warp that reads it
//    (exact: every int8 and fp8 value is a bf16 value), S times the K
//    scale after the dot, P times the V scale before its rounding, as the
//    rule above. Products are exact and sums fp32, as in the FMA path; P
//    is rounded to bf16 against the final max. D 64 and 128 at 16-byte
//    granules run their own instances; every other D up to 128 (80, 96,
//    100, 112, ...) runs the 128-wide one, each row padded with zeros to
//    128 values in shared memory and copied at its granule (D 100: 8
//    bytes in bf16, 4 in int8 and fp8), so that only shared memory and
//    the tensor cores see the padding; past D 128 the 256-wide one and
//    past D 256 the 512-wide one, a thread copying two or four 8-value
//    chunks of its row, the granule read from the bases at run time. The
//    FMA path spent ~40 instructions a row per warp on dot products,
//    their 16-lane shuffle sums and one exp2 per lane: issue, not bytes,
//    bounded it (int8 and fp8 caches, half the bytes, took as long as
//    bf16, or longer).
//  - everything else (fp32 q, whose 2e-5 budget rules out rounding q to
//    bf16; odd D, granules under 4 bytes, D < 64): FMA, the row's 8-value
//    chunks summed over its lanes by shuffles, over 16-byte aligned cache
//    storage.
// Row groups and warps meet in a fixed order. TMA page gathers are later
// work. The kernels' body is csrc/decode_split.cuh, which K2 (the fused
// decode + append, csrc/decode.cu) shares.

#include "decode_split.cuh"

// K5. q, o: [bh, group, D] (q_bf16: bf16, else fp32); k, v: [bh, max_len,
// D] storage (kv_format: 0 bf16, 1 int8, 2 fp8-e4m3, 3 fp8-e5m2); scales
// [bh, max_len] fp32; lengths [bh / hkv] int32. workspace: fp32, bh *
// (chunks * max_len * group_chunk + group * (splits * (D + 2) + 1))
// values, chunks = ceil(group / group_chunk), splits = ceil(max_len /
// split_rows) (at least 1); 16-byte aligned. split_rows a power of two;
// group_chunk 4 or 8 query rows a CTA. 1 <= D <= 512. path: the code of
// the path the host chose (ops/params.py::DECODE_PATHS; the FMA paths
// need 16-byte aligned cache storage). Returns the first launch's error
// (another path than `path`, or a layout past the H100's shared memory:
// cudaErrorInvalidValue), else cudaGetLastError() after the last
// (decode_split.cuh::launch_one).
extern "C" int mfa_decode_attend(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, void* o, void* workspace,
    int bh, int hkv, int group, int max_len, int D, int window, int q_bf16,
    int kv_format, int split_rows, int group_chunk, int threads,
    int path, void* stream) {
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
  return launch<false>(p, ContiguousRows{max_len}, workspace, bh,
                       kv_format, group_chunk, threads, path, stream);
}
