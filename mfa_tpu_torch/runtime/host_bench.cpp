// Host-path benchmark of the config core: the twin of runtime/main.cpp for
// the Hopper rows. A dispatch derives a kernel descriptor on the host for
// every new problem; its budget is 1 microsecond (the reference's "Only 1
// microsecond of CPU time" for GEMMDescriptor), and row selection and cache
// probes take nanoseconds. This driver checks the core on K1's bf16 table
// (ops/params.py _FWD_BF16) and K7's heuristic, then times the derivations
// and prints "host-path budget OK" when both stay within 1 us.
//
//   build/mfa_tpu_torch/mfa_host_bench   (built by ops/native.py)
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "host_config.hpp"

using Clock = std::chrono::steady_clock;

namespace {

const char* kTable = R"(
# max_d | block_q | block_kv | block_d | kernel
   64   |  128    |   128    |   64    | wgmma
  128   |  128    |   128    |  128    | wgmma
  192   |  128    |    64    |  192    | wgmma_dblk
  256   |  128    |    64    |  256    | wgmma_dblk
  384   |  128    |    64    |  192    | wgmma_dblk
  512   |  128    |    64    |  256    | wgmma_dblk
  inf   |   64    |    32    |  256    | mma_dblk
)";

const mfa_host::HopperDevice kH100{132, 232448};
std::vector<mfa_host::ParameterRow> g_rows;
mfa_host::TwoLevelCache g_cache;
volatile int64_t g_sink;

void require(bool ok, const char* what) {
  if (!ok) {
    std::fprintf(stderr, "[mfa_tpu_torch] check failed: %s\n", what);
    std::exit(1);
  }
}

template <typename F>
double ns_per_call(int iters, F fn) {
  const auto t0 = Clock::now();
  for (int i = 0; i < iters; ++i) fn(i);
  const auto t1 = Clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / iters;
}

}  // namespace

int main() {
  std::string err;
  require(mfa_host::parse_table(kTable, &g_rows, &err), err.c_str());
  require(g_rows.size() == 7, "seven rows");
  require(mfa_host::select_row(g_rows, 64) == 0, "D 64 takes row 0");
  require(mfa_host::select_row(g_rows, 100) == 1, "D 100 takes row 1");
  require(mfa_host::select_row(g_rows, 1000) == 6, "D 1000 takes row 6");
  require(mfa_host::smem_bytes("flash_fwd", g_rows[1], 2) <=
              kH100.smem_per_block,
          "K1's D 128 row fits one SM");

  mfa_host::GemmProblem p;
  p.m = p.n = p.k = 4096;
  p.a_precision = p.b_precision = mfa_host::kBF16;
  int tile = -1, mma_tile = -1;
  require(mfa_host::gemm_tile(p, kH100, &tile, &mma_tile), "tiles fit");
  std::printf("[mfa_tpu_torch] gemm tile 4096^3 bf16 on 132 SMs: %s (mma.sync "
              "%s)\n", mfa_host::kGemmTiles[tile].name,
              mfa_host::kGemmTiles[mma_tile].name);
  require(tile == 0 && mma_tile == 2, "w256 with m128 at 4096^3");

  for (uint64_t i = 0; i < 1024; ++i) g_cache.put_pipeline(i, i + 1);

  // K7's descriptor: the tile heuristic on a new problem each call.
  const double gemm_ns = ns_per_call(200000, [](int i) {
    mfa_host::GemmProblem q;
    q.m = 17 + (i & 4095);
    q.n = 4096;
    q.k = 4096;
    q.a_precision = q.b_precision = mfa_host::kBF16;
    int t, m;
    mfa_host::gemm_tile(q, kH100, &t, &m);
    g_sink = t + m;
  });
  // K1's descriptor: the table row for a head dim and its shared memory.
  const double attn_ns = ns_per_call(200000, [](int i) {
    const int row = mfa_host::select_row(g_rows, 1 + (i & 511));
    g_sink = mfa_host::smem_bytes("flash_fwd", g_rows[row], 2);
  });
  const double select_ns = ns_per_call(2000000, [](int i) {
    g_sink = mfa_host::select_row(g_rows, 64 + (i & 255));
  });
  const double probe_ns = ns_per_call(2000000, [](int i) {
    g_sink = static_cast<int64_t>(
        g_cache.get_pipeline(static_cast<uint64_t>(i & 1023)));
  });
  const double hash_ns = ns_per_call(2000000, [](int i) {
    const int64_t key[4] = {i, 4096, 4096, 4096};
    g_sink = static_cast<int64_t>(mfa_host::hash_bytes(key, sizeof(key)));
  });
  std::printf("[mfa_tpu_torch] gemm descriptor (tile heuristic): "
              "%.1f ns/call\n", gemm_ns);
  std::printf("[mfa_tpu_torch] attention descriptor (row + smem): "
              "%.1f ns/call\n", attn_ns);
  std::printf("[mfa_tpu_torch] parameter-row select: %.1f ns/call\n",
              select_ns);
  std::printf("[mfa_tpu_torch] pipeline-cache probe: %.1f ns/call\n",
              probe_ns);
  std::printf("[mfa_tpu_torch] key hash (32 bytes): %.1f ns/call\n", hash_ns);
  require(gemm_ns < 1000.0, "the gemm descriptor exceeds its 1 us budget");
  require(attn_ns < 1000.0,
          "the attention descriptor exceeds its 1 us budget");
  std::printf("[mfa_tpu_torch] host-path budget OK\n");
  return 0;
}
