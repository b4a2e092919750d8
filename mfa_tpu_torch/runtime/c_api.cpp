// The C interface of the host config core, loaded by
// mfa_tpu_torch/ops/native.py with ctypes.
#include <cstring>
#include <string>
#include <vector>

#include "host_config.hpp"

extern "C" {

struct MfaRow {
  int max_d;
  int block_q;
  int block_kv;
  int block_d;
  char kernel[16];
  char producer[8];
};

static mfa_host::ParameterRow from_c(const MfaRow& r) {
  mfa_host::ParameterRow row;
  row.max_d = r.max_d;
  row.block_q = r.block_q;
  row.block_kv = r.block_kv;
  row.block_d = r.block_d;
  row.kernel = r.kernel;
  row.producer = r.producer;
  return row;
}

// Parse a pipe-DSL table: the row count (rows past max_rows are counted,
// not written), or -1 with params.parse_table's message in err.
int mfa_parse_table(const char* text, MfaRow* rows, int max_rows, char* err,
                    int err_len) {
  std::vector<mfa_host::ParameterRow> parsed;
  std::string error;
  if (!mfa_host::parse_table(text ? text : "", &parsed, &error)) {
    if (err && err_len > 0) {
      std::strncpy(err, error.c_str(), err_len - 1);
      err[err_len - 1] = '\0';
    }
    return -1;
  }
  const int n = static_cast<int>(parsed.size());
  for (int i = 0; i < n && i < max_rows; ++i) {
    rows[i] = MfaRow{parsed[i].max_d, parsed[i].block_q, parsed[i].block_kv,
                     parsed[i].block_d, {0}, {0}};
    std::strncpy(rows[i].kernel, parsed[i].kernel.c_str(),
                 sizeof(rows[i].kernel) - 1);
  }
  return n;
}

int mfa_select_row(const MfaRow* rows, int n, int head_dim) {
  std::vector<mfa_host::ParameterRow> rs;
  for (int i = 0; i < n; ++i) rs.push_back(from_c(rows[i]));
  return mfa_host::select_row(rs, head_dim);
}

long long mfa_smem_bytes(const char* kernel, const MfaRow* row,
                         int in_bytes) {
  return mfa_host::smem_bytes(kernel ? kernel : "", from_c(*row), in_bytes);
}

// K7's tile and mma.sync tile (indices into params.GEMM_TILES' order, -1
// for none); 0, or 1 where a tile does not fit smem_per_block.
int mfa_gemm_tile(long long m, long long n, long long k, long long batch,
                  int a_precision, int b_precision, int transpose_a,
                  int transpose_b, int sm_count, long long smem_per_block,
                  int* tile, int* mma_tile) {
  mfa_host::GemmProblem p;
  p.m = m;
  p.n = n;
  p.k = k;
  p.batch = batch;
  p.a_precision = a_precision;
  p.b_precision = b_precision;
  p.transpose_a = transpose_a != 0;
  p.transpose_b = transpose_b != 0;
  return mfa_host::gemm_tile(p, {sm_count, smem_per_block}, tile, mma_tile)
             ? 0
             : 1;
}

unsigned long long mfa_hash_bytes(const void* data, long long len) {
  return mfa_host::hash_bytes(data, static_cast<size_t>(len));
}

void* mfa_cache_new() { return new mfa_host::TwoLevelCache(); }
void mfa_cache_free(void* c) {
  delete static_cast<mfa_host::TwoLevelCache*>(c);
}

unsigned long long mfa_cache_get_pipeline(void* c, unsigned long long key) {
  return static_cast<mfa_host::TwoLevelCache*>(c)->get_pipeline(key);
}
unsigned long long mfa_cache_get_library(void* c, unsigned long long key) {
  return static_cast<mfa_host::TwoLevelCache*>(c)->get_library(key);
}
unsigned long long mfa_cache_put_pipeline(void* c, unsigned long long key,
                                          unsigned long long payload) {
  return static_cast<mfa_host::TwoLevelCache*>(c)->put_pipeline(key,
                                                                payload);
}
unsigned long long mfa_cache_put_library(void* c, unsigned long long key,
                                         unsigned long long payload) {
  return static_cast<mfa_host::TwoLevelCache*>(c)->put_library(key, payload);
}
void mfa_cache_stats(void* c, unsigned long long* out4) {
  const auto s = static_cast<mfa_host::TwoLevelCache*>(c)->stats();
  out4[0] = s.library_hits;
  out4[1] = s.library_misses;
  out4[2] = s.pipeline_hits;
  out4[3] = s.pipeline_misses;
}
void mfa_cache_clear(void* c) {
  static_cast<mfa_host::TwoLevelCache*>(c)->clear();
}

}  // extern "C"
