// Fused decode attention + KV-cache append for Hopper (sm_90a): K2.
//
// Replaces the TPU kernel mfa_tpu/kernels/decode.py::_decode_fused_kernel
// (built by build_decode_fused_append). The G = Hq / Hkv query rows of a
// kv head attend their sequence's live cache rows [max(0, len + 1 - W),
// len) plus the new token, whose column comes from the unquantized k_new /
// v_new; the new row is then quantized into row len of the cache (nothing
// is written when len == max_len). The cache is bf16, int8, fp8-e4m3 or
// fp8-e5m2 with per-token scales that multiply S and P, as on the TPU;
// fp8 is widened by Hopper's native conversion (exact, where the TPU
// bit-twiddle mapped subnormals to ~2^-7). Over an int8 cache the TPU
// kernel's s8 requantization of q and P per query row is kept, with
// integer-valued products (exact in fp32).
//
// What bounds it on an H100: the bytes of the live K and V rows (bf16 at
// B = 4, Hkv = 8, 2048 rows, D = 128: ~20 MB for chip_smoke's lengths,
// ~6 us at 3.35 TB/s); its operations (4 G D flops a row) are ~100x below
// the ridge. So the whole card has to read, even for a few sequences.
//
// Design: K5's split-KV body (csrc/decode_split.cuh, instantiated with
// kFused = true). The grid is (sequence x kv head, query chunk of 4 or 8,
// split of R positions; R from ops/params.py::decode_split_rows, the
// shapes alone), and a call is two kernels, chained by programmatic
// dependent launch:
//  1. decode_score: S of the split's rows into an L2-resident scratch row
//     and the split's row max; the split that owns position len (query
//     chunk 0) appends the new row, bit-equal to kernels/quant.py. No
//     split reads row len, so the write cannot race a read.
//  2. decode_attend: the final max over the live splits and s_new = q .
//     k_new, then P against it, its sum and P V over the split's rows;
//     the last split to arrive (an integer counter that decode_score
//     zeroes) sums the partials in split order, adds p_new and p_new
//     v_new, and writes O. No atomics on values: O is deterministic.
// An int8 cache adds a pass between the two (decode_pmax), since P's s8
// scale is max |P vs| over every live row of the query row, across
// splits: each split's exact max against the final max, read from the
// scratch row. bf16 q at 64 <= D <= 512 runs both passes on mma.sync (as
// K5) over every storage type: each warp widens its rows of an int8 or
// fp8 stage to bf16 (exact), the scales multiply S and P where the plain
// version's do. Over int8 the s8 requantization stays exact on the pair:
// q_s8 and P_s8 are integers up to 127, exact as bf16 operands, their
// products with int8 K and V integers whose sums stay below 2^24 (512 *
// 127^2 a score; 1024 * 127^2 a split's P V, at DECODE_SPLIT_MAX_ROWS),
// exact in fp32 in any order, and the rest (q scale times ks, P's row
// sum) is computed in the FMA pair's order: the pair's output is the FMA
// pair's bit for bit. Past D 64 and 128 (OpenLLaMA-3B's D 100: 200-byte
// rows in bf16, 100 in int8 and fp8) the rows are padded with zeros to
// 128 values in shared memory (256 past D 128, 512 past D 256) and
// copied at the granule their rows and bases share (8 and 4 bytes at D
// 100). fp32 q, odd D, granules under 4 bytes and D < 64 run the FMA
// pair, in decode_split.cuh::RowLayout's rows (any D:
// 16-byte granules of the cache, a row's chunks read at its alignment).
// The append writes the new row value by value, so a row of any D takes
// it.

#include "decode_split.cuh"

// q_bf16: 1 if q, k_new, v_new and o are bf16, 0 if fp32. kv_format: 0
// bf16, 1 int8, 2 fp8-e4m3, 3 fp8-e5m2. q, o: [bh, group, D]; k, v:
// [bh, max_len, D] storage, updated in place; scales [bh, max_len] fp32,
// updated in place; k_new, v_new [bh, D]; lengths [bh / hkv] int32, the
// lengths before the append. workspace: fp32, K5's (csrc/decode_attend.cu)
// plus bh * group * splits values; 16-byte aligned. split_rows a power of
// two; group_chunk 4 or 8 query rows a CTA; 1 <= D <= 512; path as K5's
// (csrc/decode_attend.cu). Returns the first launch's error, else
// cudaGetLastError() after the last (decode_split.cuh::launch_one).
extern "C" int mfa_decode_fused_append(
    const void* q, void* k, void* v, void* k_scale, void* v_scale,
    const void* k_new, const void* v_new, const void* lengths, void* o,
    void* workspace, int bh, int hkv, int group, int max_len, int D,
    int window, int q_bf16, int kv_format, int split_rows, int group_chunk,
    int threads, int path,
    void* stream) {
  FusedParams p{};
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
  p.k_new = k_new;
  p.v_new = v_new;
  return launch<true>(p, FusedRows{{max_len}}, workspace, bh, kv_format,
                      group_chunk, threads, path, stream);
}
