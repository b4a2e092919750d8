// The host config core (host_config.hpp): each function follows the Python
// function named beside it line by line, integer division floored as
// Python's // is.
#include "host_config.hpp"

#include <algorithm>
#include <cctype>
#include <sstream>

namespace mfa_host {

namespace {

// params.ROW_KERNELS
const char* const kRowKernels[] = {"mma", "wgmma", "mma_dblk", "fma_dblk",
                                   "wgmma_dblk"};

// params.H100.smem_per_block, _SMEM_ALIGN, FWD_RING_STAGES,
// FWD_COPY_RING_STAGES, BWD_Q_COPY_RING_STAGES, BWD_KV_COPY_RING_STAGES
constexpr int64_t kSmemOptin = 232448;
constexpr int64_t kSmemAlign = 1024;
constexpr int64_t kFwdRingStages = 3;
constexpr int64_t kFwdCopyRingStages = 2;
constexpr int64_t kBwdQCopyRingStages = 3;
constexpr int64_t kBwdKvCopyRingStages = 3;

int64_t floor_div(int64_t a, int64_t b) {
  int64_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

int64_t ceil_div(int64_t a, int64_t b) { return -floor_div(-a, b); }

std::string strip(const std::string& s) {
  const char* ws = " \t\r\n\f\v";
  auto b = s.find_first_not_of(ws);
  if (b == std::string::npos) return "";
  return s.substr(b, s.find_last_not_of(ws) - b + 1);
}

// Python's repr of a str without control characters.
std::string py_repr(const std::string& s) {
  const char q = (s.find('\'') != std::string::npos &&
                  s.find('"') == std::string::npos)
                     ? '"'
                     : '\'';
  std::string out(1, q);
  for (char c : s) {
    if (c == '\\' || c == q) out += '\\';
    out += c;
  }
  return out + q;
}

// int(s) for a stripped decimal literal; false with Python's message.
bool py_int(const std::string& s, int* out, std::string* error) {
  size_t i = (!s.empty() && (s[0] == '+' || s[0] == '-')) ? 1 : 0;
  bool ok = i < s.size();
  for (size_t j = i; j < s.size(); ++j)
    ok = ok && std::isdigit(static_cast<unsigned char>(s[j]));
  if (!ok) {
    if (error)
      *error = "invalid literal for int() with base 10: " + py_repr(s);
    return false;
  }
  *out = std::stoi(s);
  return true;
}

bool is_row_kernel(const std::string& k) {
  for (const char* name : kRowKernels)
    if (k == name) return true;
  return false;
}

// --- params.py's ring reckonings ---

int dblk_max_panels(int block_d) { return block_d == 128 ? 4 : 2; }

int64_t row_panels(const ParameterRow& r) {
  if (!r.max_d) return dblk_max_panels(r.block_d);
  return ceil_div(r.max_d, r.block_d);
}

int64_t exchange_bytes(const std::string& kernel, const ParameterRow& r) {
  if (r.kernel != "wgmma_dblk" || row_panels(r) == 1) return 0;
  if (kernel == "flash_fwd")
    return 2LL * (dblk_max_panels(r.block_d) - 1) * 64 * r.block_kv * 4;
  if (kernel == "flash_bwd_q") return 2LL * 2 * 64 * r.block_kv * 4;
  return 2LL * 64 * r.block_q * 4;
}

int64_t ring_stages(int64_t fixed, int64_t per_stage, int64_t most,
                    int64_t mult) {
  return std::min(floor_div(kSmemOptin - fixed, per_stage), most) / mult *
         mult;
}

int64_t bwd_q_stages(const ParameterRow& r) {
  const int64_t d = r.block_d, bq = r.block_q, bkv = r.block_kv;
  const int64_t most = r.producer.empty() ? 4 : kBwdQCopyRingStages;
  return ring_stages(2 * 2 * bq * d + 8 * bq + 8 + kSmemAlign,
                     2 * 2 * bkv * d + 16, most, 1);
}

void bwd_q_split_stages(const ParameterRow& r, int64_t* sk, int64_t* sv) {
  const int64_t d = r.block_d, bq = r.block_q, bkv = r.block_kv;
  const int64_t x = exchange_bytes("flash_bwd_q", r);
  const int64_t tiles =
      floor_div(kSmemOptin - 2 * 2 * bq * d - x - 8 * bq -
                    8 * (1 + (x ? 4 : 0)) - kSmemAlign,
                2 * bkv * d + 16);
  if (!r.producer.empty()) {
    *sk = *sv = std::min(floor_div(tiles, 2), kBwdQCopyRingStages);
    return;
  }
  *sv = std::min<int64_t>(std::max<int64_t>(tiles - 4, 1), 4);
  *sk = std::min<int64_t>(tiles - *sv, 4);
}

int64_t bwd_kv_stages(const ParameterRow& r) {
  const int64_t d = r.block_d, bq = r.block_q, bkv = r.block_kv;
  const int64_t most = r.producer.empty() ? 4 : kBwdKvCopyRingStages;
  if (r.kernel == "wgmma_dblk") {
    const int64_t x = exchange_bytes("flash_bwd_kv", r);
    return ring_stages(2 * 2 * bkv * d + 2 * bq * d + x + 2 * 64 * bq * 4 +
                           8 * (5 + (x ? 4 : 0)) + kSmemAlign,
                       2 * 2 * bq * d + 8 * bq + 16, most, 1);
  }
  return ring_stages(2 * 2 * bkv * d + 2 * 2 * bq * d + 8 + kSmemAlign,
                     2 * 2 * bq * d + 8 * bq + 16,
                     r.producer.empty() ? most : 2 * most, 2);
}

void fwd_rings(const ParameterRow& r, int64_t* k, int64_t* v) {
  const int64_t d = r.block_d, bq = r.block_q, bkv = r.block_kv;
  const int64_t x = exchange_bytes("flash_fwd", r);
  const int64_t tiles = floor_div(
      kSmemOptin - 2 * bq * d - x - 8 * (1 + (x ? 4 : 0)) - kSmemAlign,
      2 * bkv * d + 16);
  const int64_t most = r.producer.empty() ? kFwdRingStages
                                          : kFwdCopyRingStages;
  *v = std::min(ceil_div(tiles, 2), most);
  *k = std::min(tiles - *v, most);
}

int64_t flash_fwd_smem(const ParameterRow& r, int in_bytes) {
  const int64_t d = r.block_d, bq = r.block_q, bkv = r.block_kv;
  if (r.kernel == "wgmma" || r.kernel == "wgmma_dblk") {
    int64_t k, v;
    fwd_rings(r, &k, &v);
    const int64_t tiles = k + v;
    const int64_t x = exchange_bytes("flash_fwd", r);
    return 2 * bq * d + x + tiles * 2 * bkv * d +
           8 * (1 + 2 * tiles + (x ? 4 : 0)) + kSmemAlign;
  }
  if (in_bytes == 2)
    return in_bytes * (bq * (d + 8) + bkv * (d + 8) + d * (bkv + 8));
  return 4 * (bq * d + 2 * bkv * (d + 1));
}

int64_t flash_bwd_q_smem(const ParameterRow& r, int in_bytes) {
  const int64_t d = r.block_d, bq = r.block_q, bkv = r.block_kv;
  if (r.kernel == "wgmma") {
    const int64_t stages = bwd_q_stages(r);
    return 2 * 2 * bq * d + stages * 2 * 2 * bkv * d + 4 * 2 * bq +
           8 * (1 + 2 * stages) + kSmemAlign;
  }
  if (r.kernel == "wgmma_dblk") {
    int64_t sk, sv;
    bwd_q_split_stages(r, &sk, &sv);
    const int64_t tiles = sk + sv;
    const int64_t x = exchange_bytes("flash_bwd_q", r);
    return 2 * 2 * bq * d + x + tiles * 2 * bkv * d + 4 * 2 * bq +
           8 * (1 + 2 * tiles + (x ? 4 : 0)) + kSmemAlign;
  }
  if (in_bytes == 2)
    return 2 * (2 * bq * (d + 8) + 2 * bkv * (d + 8) + d * (bkv + 8)) +
           4 * 2 * bq;
  const int64_t k_tiles = r.kernel == "fma_dblk" ? 3 : 2;
  return 4 * (2 * bq * d + k_tiles * bkv * (d + 1) + 2 * bq);
}

int64_t flash_bwd_kv_smem(const ParameterRow& r, int in_bytes) {
  const int64_t d = r.block_d, bq = r.block_q, bkv = r.block_kv;
  if (r.kernel == "wgmma" || r.kernel == "wgmma_dblk") {
    const int64_t stages = bwd_kv_stages(r);
    if (r.kernel == "wgmma_dblk") {
      const int64_t x = exchange_bytes("flash_bwd_kv", r);
      return 2 * 2 * bkv * d + 2 * bq * d + x + 2 * 64 * bq * 4 +
             stages * 2 * 2 * bq * d + stages * 4 * 2 * bq +
             8 * (1 + 2 * stages + 4 + (x ? 4 : 0)) + kSmemAlign;
    }
    return 2 * 2 * bkv * d + (2 * stages + 2) * 2 * bq * d +
           stages * 4 * 2 * bq + 8 * (1 + 2 * stages) + kSmemAlign;
  }
  if (in_bytes == 2)
    return 2 * (2 * bkv * (d + 8) + 2 * bq * (d + 8) + 2 * d * (bq + 8)) +
           4 * 2 * bq;
  const int64_t q_tiles = r.kernel == "fma_dblk" ? 4 : 2;
  return 4 * (2 * bkv * d + q_tiles * bq * (d + 1) + 2 * bq);
}

}  // namespace

bool parse_table(const std::string& text, std::vector<ParameterRow>* rows,
                 std::string* error) {
  rows->clear();
  std::istringstream in(strip(text));
  std::string line;
  while (std::getline(in, line)) {
    line = strip(line);
    if (line.empty() || line[0] == '#') continue;
    std::vector<std::string> parts;
    size_t at = 0;
    for (;;) {
      const size_t bar = line.find('|', at);
      parts.push_back(strip(line.substr(at, bar - at)));
      if (bar == std::string::npos) break;
      at = bar + 1;
    }
    if ((parts.size() != 4 && parts.size() != 5) ||
        (parts.size() == 5 && !is_row_kernel(parts[4]))) {
      if (error) *error = "malformed parameter row: " + py_repr(line);
      return false;
    }
    ParameterRow row;
    if (parts[0] != "inf" && parts[0] != "-" &&
        !py_int(parts[0], &row.max_d, error))
      return false;
    if (!py_int(parts[1], &row.block_q, error) ||
        !py_int(parts[2], &row.block_kv, error) ||
        !py_int(parts[3], &row.block_d, error))
      return false;
    if (parts.size() == 5) row.kernel = parts[4];
    rows->push_back(row);
  }
  if (rows->empty()) {
    if (error) *error = "empty parameter table";
    return false;
  }
  if (rows->back().max_d != 0) {
    if (error)
      *error = "last row of a parameter table must be unbounded (max_d=inf)";
    return false;
  }
  return true;
}

int select_row(const std::vector<ParameterRow>& rows, int head_dim) {
  for (size_t i = 0; i < rows.size(); ++i)
    if (rows[i].max_d == 0 || head_dim <= rows[i].max_d)
      return static_cast<int>(i);
  return -1;
}

int64_t smem_bytes(const std::string& kernel, const ParameterRow& row,
                   int in_bytes) {
  if (kernel == "flash_fwd") return flash_fwd_smem(row, in_bytes);
  if (kernel == "flash_bwd_q") return flash_bwd_q_smem(row, in_bytes);
  if (kernel == "flash_bwd_kv") return flash_bwd_kv_smem(row, in_bytes);
  return -1;
}

const MatmulTile kGemmTiles[6] = {
    {"w256", 128, 256, 64, 2, 1, 4, "wgmma"},
    {"w128", 128, 128, 64, 2, 1, 6, "wgmma"},
    {"m128", 128, 128, 32, 2, 4, 3, "mma"},
    {"m64", 64, 64, 32, 2, 2, 3, "mma"},
    {"m16", 16, 64, 64, 1, 4, 3, "mma"},
    {"ffma", 64, 64, 16, 4, 2, 1, "ffma"},
};

int64_t gemm_smem_bytes(const MatmulTile& t, bool ta, bool tb) {
  const int64_t bm = t.block_m, bn = t.block_n, bk = t.block_k;
  if (std::strcmp(t.path, "ffma") == 0) return 4 * bk * (bm + 4 + bn);
  if (std::strcmp(t.path, "wgmma") == 0)
    return t.stages * ((bm + bn) * bk * 2 + 16) + kSmemAlign;
  const int64_t a = ta ? bk * (bm + 8) : bm * (bk + 8);
  const int64_t b = tb ? bn * (bk + 8) : bk * (bn + 8);
  return 2 * t.stages * (a + b);
}

namespace {

int64_t rounds(const GemmProblem& p, const MatmulTile& t,
               const HopperDevice& dev) {
  const int64_t tiles =
      ceil_div(p.m, t.block_m) * ceil_div(p.n, t.block_n) * p.batch;
  return ceil_div(tiles, dev.sm_count) * t.block_m * t.block_n;
}

}  // namespace

bool gemm_tile(const GemmProblem& p, const HopperDevice& dev, int* tile,
               int* mma_tile) {
  enum { kW256, kW128, kM128, kM64, kM16, kFfma };
  const bool mma = (p.a_precision == kBF16 || p.a_precision == kFP16) &&
                   p.a_precision == p.b_precision;
  int name = kFfma, mma_name = -1;
  if (!mma) {
    name = kFfma;
  } else if (p.m <= 16) {
    name = kM16;
  } else {
    const int64_t tiles = ceil_div(p.m, 128) * ceil_div(p.n, 128) * p.batch;
    name = tiles >= dev.sm_count ? kM128 : kM64;
    if (p.a_precision == kBF16) {
      mma_name = name;
      name = rounds(p, kGemmTiles[kW128], dev) <
                     rounds(p, kGemmTiles[kW256], dev)
                 ? kW128
                 : kW256;
    }
  }
  *tile = name;
  *mma_tile = mma_name;
  for (int t : {name, mma_name})
    if (t >= 0 && gemm_smem_bytes(kGemmTiles[t], p.transpose_a,
                                  p.transpose_b) > dev.smem_per_block)
      return false;
  return true;
}

}  // namespace mfa_host
