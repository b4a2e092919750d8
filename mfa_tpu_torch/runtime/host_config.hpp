// Host config core of the Hopper port: the C++ twin of the port's Python
// config layer (mfa_tpu_torch/ops/params.py, ops/descriptors.py,
// ops/cache.py), as runtime/ is of mfa_tpu's. Every function gives what its
// Python twin gives, bit for bit (tests/test_torch_native.py holds them
// together): the pipe-DSL table parser and first-row select, the shared
// memory of one CTA of the flash kernels at a parameter row (their ring
// reckonings), K7's tile heuristic, the key hash and the two-level cache.
// Nothing on the dispatch path calls it.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace mfa_host {

// ---------------------------------------------------------------------------
// Parameter rows (params.ParameterRow, parse_table, select_row)
// ---------------------------------------------------------------------------

struct ParameterRow {
  int max_d = 0;  // 0 = unbounded
  int block_q = 0;
  int block_kv = 0;
  int block_d = 0;
  std::string kernel;    // "" or one of params.ROW_KERNELS
  std::string producer;  // "" or "copy" (K1's launch row)
};

// Parses the pipe DSL (max_d | block_q | block_kv | block_d [| kernel]);
// false with params.parse_table's message on a malformed row, an empty
// table or a bounded last row.
bool parse_table(const std::string& text, std::vector<ParameterRow>* rows,
                 std::string* error);

// Index of the first row with head_dim <= max_d (or unbounded); -1 if none.
int select_row(const std::vector<ParameterRow>& rows, int head_dim);

// Shared memory of one CTA of `kernel` ("flash_fwd", "flash_bwd_q",
// "flash_bwd_kv") at `row` (params.smem_bytes); -1 for another kernel.
int64_t smem_bytes(const std::string& kernel, const ParameterRow& row,
                   int in_bytes);

// ---------------------------------------------------------------------------
// K7's tiles (params.GEMM_TILES) and heuristic
// (GEMMDescriptor.kernel_descriptor)
// ---------------------------------------------------------------------------

struct MatmulTile {
  const char* name;
  int block_m, block_n, block_k, warps_m, warps_n, stages;
  const char* path;
};

// params.GEMM_TILES in its order: w256, w128, m128, m64, m16, ffma.
extern const MatmulTile kGemmTiles[6];

// Operand precisions as the C API numbers them.
enum Precision { kFP32 = 0, kBF16 = 1, kFP16 = 2, kOther = 3 };

struct GemmProblem {
  int64_t m = 0, n = 0, k = 0, batch = 1;
  int a_precision = kFP32, b_precision = kFP32;
  bool transpose_a = false, transpose_b = false;
};

struct HopperDevice {
  int sm_count;
  int64_t smem_per_block;
};

int64_t gemm_smem_bytes(const MatmulTile& tile, bool transpose_a,
                        bool transpose_b);

// The indices (into kGemmTiles) of the tile and of the mma.sync tile (-1
// for none) that kernel_descriptor picks; false where a tile does not fit
// the device's shared memory (check_tile_fits).
bool gemm_tile(const GemmProblem& p, const HopperDevice& device, int* tile,
               int* mma_tile);

// ---------------------------------------------------------------------------
// Key hash: the mix of runtime/mfa_hash.hpp (splitmix64 finalizer, boost
// combine, 8-byte words then the tail tagged with its length)
// ---------------------------------------------------------------------------

inline uint64_t distribute(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

inline void combine_64(uint64_t& seed, uint64_t value) {
  seed ^= distribute(value) + 0x9e3779b97f4a7c15ull + (seed << 6) +
          (seed >> 2);
}

inline uint64_t hash_bytes(const void* data, size_t len, uint64_t seed = 0) {
  const auto* p = static_cast<const uint8_t*>(data);
  while (len >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    combine_64(seed, w);
    p += 8;
    len -= 8;
  }
  if (len > 0) {
    uint64_t w = 0;
    std::memcpy(&w, p, len);
    combine_64(seed, w | (static_cast<uint64_t>(len) << 56));
  }
  return seed;
}

// ---------------------------------------------------------------------------
// Two-level cache (ops/cache.py TwoLevelCache): payloads are the client's
// nonzero tokens; 0 is a miss.
// ---------------------------------------------------------------------------

struct CacheStats {
  uint64_t library_hits = 0;
  uint64_t library_misses = 0;
  uint64_t pipeline_hits = 0;
  uint64_t pipeline_misses = 0;
};

class TwoLevelCache {
 public:
  uint64_t get_pipeline(uint64_t problem_key) {
    std::lock_guard<std::mutex> lock(mu_);
    auto it = pipeline_.find(problem_key);
    if (it != pipeline_.end()) {
      ++stats_.pipeline_hits;
      return it->second;
    }
    ++stats_.pipeline_misses;
    return 0;
  }

  uint64_t get_library(uint64_t kernel_key) {
    std::lock_guard<std::mutex> lock(mu_);
    auto it = library_.find(kernel_key);
    if (it != library_.end()) {
      ++stats_.library_hits;
      return it->second;
    }
    ++stats_.library_misses;
    return 0;
  }

  // Insert if absent; the resident payload (the first insert wins, as in
  // the Python twin's setdefault).
  uint64_t put_library(uint64_t key, uint64_t payload) {
    return put(library_, key, payload);
  }
  uint64_t put_pipeline(uint64_t key, uint64_t payload) {
    return put(pipeline_, key, payload);
  }

  CacheStats stats() const {
    std::lock_guard<std::mutex> lock(mu_);
    return stats_;
  }

  void clear() {
    std::lock_guard<std::mutex> lock(mu_);
    library_.clear();
    pipeline_.clear();
    stats_ = CacheStats();
  }

 private:
  uint64_t put(std::unordered_map<uint64_t, uint64_t>& map, uint64_t key,
               uint64_t payload) {
    std::lock_guard<std::mutex> lock(mu_);
    return map.emplace(key, payload).first->second;
  }

  mutable std::mutex mu_;
  std::unordered_map<uint64_t, uint64_t> library_;
  std::unordered_map<uint64_t, uint64_t> pipeline_;
  CacheStats stats_;
};

}  // namespace mfa_host
