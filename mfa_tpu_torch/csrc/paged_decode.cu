// Paged decode attention for Hopper (sm_90a): K6, `mfa_paged_decode`.
//
// Replaces mfa_tpu/kernels/paged_decode.py::_paged_decode_kernel (built by
// build_paged_decode): one-token GQA decode over a page pool [P, Hkv,
// page, D] whose pages each sequence names in its row of a page table.
// What bounds it on an H100 (the bytes of the live K and V rows) and its
// design (the split-KV body csrc/decode_split.cuh, each row read through
// PagedRows) are K5's: csrc/decode_attend.cu describes both. K6's entry
// lives here so that nvcc builds its instances beside K5's, in parallel;
// the launch returns cudaGetLastError() after its last kernel.

#include "decode_split.cuh"

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
    int path, void* stream) {
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
  return launch<false>(p, rows, workspace, n, kv_format, group_chunk,
                       threads, path, stream);
}
