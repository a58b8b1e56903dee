// cylon_host: native host runtime of cylon_tpu_torch, the PyTorch/CUDA
// port (a copy of cylon_tpu/native/cylon_host.cpp: the same C ABI, byte
// for byte; only comments differ).
//
// Parity targets in the reference (all C++ there, so C++ here):
//   - memory pool:      cpp/src/cylon/ctx/memory_pool.hpp +
//                       ctx/arrow_memory_pool_utils.cpp (pluggable
//                       allocator with stats, bridged to Arrow)
//   - murmur3:          cpp/src/cylon/util/murmur3.{hpp,cpp}
//                       (MurmurHash3_x86_32, the row-hash primitive of
//                       arrow_partition_kernels.cpp:140)
//   - data loader:      cpp/src/cylon/io/ + the per-file reader threads
//                       of table.cpp:788-795 — here a chunk-parallel
//                       CSV parser producing columnar host buffers that
//                       the port copies onto the card as torch tensors
//   - thread pool:      the execution loop of ops/execution/execution.hpp
//                       reimagined as a work-stealing-free fixed pool
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in the image).

#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fstream>
#include <unordered_map>
#include <unordered_set>
#include <functional>
#include <algorithm>
#include <limits>
#include <map>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ------------------------------------------------------------------
// Memory pool: aligned allocations with stats + size-bucketed free lists.
// Parity: cylon::MemoryPool interface {Allocate, Reallocate, Free,
// bytes_allocated, max_memory} (ctx/memory_pool.hpp:24-60).
// ------------------------------------------------------------------

struct CylonPool {
  std::mutex mu;
  std::map<size_t, std::vector<void*>> free_lists;  // size -> buffers
  std::atomic<int64_t> bytes_allocated{0};
  std::atomic<int64_t> max_memory{0};
  std::atomic<int64_t> num_allocations{0};
  std::atomic<int64_t> pooled_bytes{0};
  int64_t pool_limit;  // max bytes kept in free lists
};

static const size_t kAlign = 64;  // cache line

void* cylon_pool_create(int64_t pool_limit_bytes) {
  auto* p = new CylonPool();
  p->pool_limit = pool_limit_bytes > 0 ? pool_limit_bytes : (256ll << 20);
  return p;
}

void cylon_pool_destroy(void* pool) {
  auto* p = static_cast<CylonPool*>(pool);
  for (auto& kv : p->free_lists)
    for (void* buf : kv.second) std::free(buf);
  delete p;
}

void* cylon_pool_alloc(void* pool, int64_t size) {
  auto* p = static_cast<CylonPool*>(pool);
  size_t sz = ((static_cast<size_t>(size) + kAlign - 1) / kAlign) * kAlign;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    auto it = p->free_lists.find(sz);
    if (it != p->free_lists.end() && !it->second.empty()) {
      void* buf = it->second.back();
      it->second.pop_back();
      p->pooled_bytes -= static_cast<int64_t>(sz);
      p->bytes_allocated += static_cast<int64_t>(sz);
      p->num_allocations++;
      if (p->bytes_allocated > p->max_memory)
        p->max_memory.store(p->bytes_allocated.load());
      return buf;
    }
  }
  void* buf = nullptr;
  if (posix_memalign(&buf, kAlign, sz) != 0) return nullptr;
  p->bytes_allocated += static_cast<int64_t>(sz);
  p->num_allocations++;
  if (p->bytes_allocated > p->max_memory)
    p->max_memory.store(p->bytes_allocated.load());
  return buf;
}

void cylon_pool_free(void* pool, void* buf, int64_t size) {
  if (buf == nullptr) return;
  auto* p = static_cast<CylonPool*>(pool);
  size_t sz = ((static_cast<size_t>(size) + kAlign - 1) / kAlign) * kAlign;
  p->bytes_allocated -= static_cast<int64_t>(sz);
  std::lock_guard<std::mutex> lk(p->mu);
  if (p->pooled_bytes + static_cast<int64_t>(sz) <= p->pool_limit) {
    p->free_lists[sz].push_back(buf);
    p->pooled_bytes += static_cast<int64_t>(sz);
  } else {
    std::free(buf);
  }
}

void cylon_pool_stats(void* pool, int64_t* bytes_allocated,
                      int64_t* max_memory, int64_t* num_allocations,
                      int64_t* pooled_bytes) {
  auto* p = static_cast<CylonPool*>(pool);
  *bytes_allocated = p->bytes_allocated.load();
  *max_memory = p->max_memory.load();
  *num_allocations = p->num_allocations.load();
  *pooled_bytes = p->pooled_bytes.load();
}

// ------------------------------------------------------------------
// MurmurHash3_x86_32 (parity: util/murmur3.cpp MurmurHash3_x86_32).
// ------------------------------------------------------------------

static inline uint32_t rotl32(uint32_t x, int8_t r) {
  return (x << r) | (x >> (32 - r));
}

static inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6b;
  h ^= h >> 13;
  h *= 0xc2b2ae35;
  h ^= h >> 16;
  return h;
}

uint32_t cylon_murmur3_x86_32(const void* key, int len, uint32_t seed) {
  const uint8_t* data = static_cast<const uint8_t*>(key);
  const int nblocks = len / 4;
  uint32_t h1 = seed;
  const uint32_t c1 = 0xcc9e2d51;
  const uint32_t c2 = 0x1b873593;

  for (int i = 0; i < nblocks; i++) {
    uint32_t k1;
    std::memcpy(&k1, data + i * 4, 4);
    k1 *= c1;
    k1 = rotl32(k1, 15);
    k1 *= c2;
    h1 ^= k1;
    h1 = rotl32(h1, 13);
    h1 = h1 * 5 + 0xe6546b64;
  }

  const uint8_t* tail = data + nblocks * 4;
  uint32_t k1 = 0;
  switch (len & 3) {
    case 3: k1 ^= tail[2] << 16; [[fallthrough]];
    case 2: k1 ^= tail[1] << 8; [[fallthrough]];
    case 1:
      k1 ^= tail[0];
      k1 *= c1;
      k1 = rotl32(k1, 15);
      k1 *= c2;
      h1 ^= k1;
  }

  h1 ^= static_cast<uint32_t>(len);
  return fmix32(h1);
}

// Bulk row hashing: int64 keys -> uint32 hashes (the hot loop of
// MapToHashPartitions, partition/partition.cpp:93, done natively for
// host-resident data).
void cylon_murmur3_int64_array(const int64_t* keys, int64_t n, uint32_t seed,
                               uint32_t* out) {
  for (int64_t i = 0; i < n; i++)
    out[i] = cylon_murmur3_x86_32(&keys[i], 8, seed);
}

// ------------------------------------------------------------------
// Thread pool (fixed workers, FIFO queue).
// ------------------------------------------------------------------

struct CylonThreadPool {
  std::vector<std::thread> workers;
  std::queue<std::function<void()>> tasks;
  std::mutex mu;
  std::condition_variable cv;
  std::condition_variable done_cv;
  std::atomic<int64_t> pending{0};
  bool stop = false;

  explicit CylonThreadPool(int n) {
    for (int i = 0; i < n; i++) {
      workers.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lk(mu);
            cv.wait(lk, [this] { return stop || !tasks.empty(); });
            if (stop && tasks.empty()) return;
            task = std::move(tasks.front());
            tasks.pop();
          }
          task();
          if (--pending == 0) {
            std::lock_guard<std::mutex> lk(mu);
            done_cv.notify_all();
          }
        }
      });
    }
  }

  void submit(std::function<void()> f) {
    pending++;
    {
      std::lock_guard<std::mutex> lk(mu);
      tasks.push(std::move(f));
    }
    cv.notify_one();
  }

  void wait_all() {
    std::unique_lock<std::mutex> lk(mu);
    done_cv.wait(lk, [this] { return pending.load() == 0; });
  }

  ~CylonThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& w : workers) w.join();
  }
};

void* cylon_threadpool_create(int n_threads) {
  return new CylonThreadPool(n_threads > 0 ? n_threads
                                           : (int)std::thread::hardware_concurrency());
}

void cylon_threadpool_destroy(void* tp) {
  delete static_cast<CylonThreadPool*>(tp);
}

typedef void (*cylon_task_fn)(void* arg);

void cylon_threadpool_submit(void* tp, cylon_task_fn fn, void* arg) {
  static_cast<CylonThreadPool*>(tp)->submit([fn, arg] { fn(arg); });
}

void cylon_threadpool_wait(void* tp) {
  static_cast<CylonThreadPool*>(tp)->wait_all();
}

// ------------------------------------------------------------------
// CSV loader: chunk-parallel parse into columnar buffers.
//
// Model (parity): arrow::csv's parallel block parser as configured by
// io/csv_read_config.hpp, plus the per-file reader threads of
// table.cpp:788. The file is split at newline boundaries into one byte
// range per worker; each worker parses its rows into per-chunk column
// vectors which are stitched in order.
//
// Column types: inferred from the first data row — INT64 (all digits),
// FLOAT64, else STRING. Strings are dictionary-encoded host-side
// (sorted dictionary; codes int32), matching the device table format.
// ------------------------------------------------------------------

enum ColType : int32_t { COL_INT64 = 0, COL_FLOAT64 = 1, COL_STRING = 2 };

struct CsvResult {
  int64_t n_rows = 0;
  int32_t n_cols = 0;
  std::vector<std::string> names;
  std::vector<int32_t> types;
  // per column: fixed buffers
  std::vector<std::vector<int64_t>> i64;
  std::vector<std::vector<double>> f64;
  std::vector<std::vector<int32_t>> codes;     // string columns
  std::vector<std::vector<uint8_t>> validity;  // 1 = non-null
  std::vector<std::vector<std::string>> dict;  // sorted unique values
  std::string error;
};

struct ChunkOut {
  std::vector<std::vector<int64_t>> i64;
  std::vector<std::vector<double>> f64;
  std::vector<std::vector<std::string>> str;
  std::vector<std::vector<uint8_t>> valid;
  int64_t rows = 0;
};

static void split_fields(const char* line, size_t len, char delim,
                         std::vector<std::pair<const char*, size_t>>* out) {
  out->clear();
  size_t start = 0;
  for (size_t i = 0; i <= len; i++) {
    if (i == len || line[i] == delim) {
      size_t flen = i - start;
      // trim \r
      while (flen > 0 && (line[start + flen - 1] == '\r')) flen--;
      out->push_back({line + start, flen});
      start = i + 1;
    }
  }
}

// Quote-aware variant (parity: csv_read_config UseQuoting/WithQuoteChar/
// DoubleQuote): a field starting with `quote` runs to the closing quote,
// may contain the delimiter, and encodes a literal quote as a doubled
// one. Unescaped bytes are materialised into `arena` (cleared per line
// by the caller); embedded newlines are NOT supported on this path —
// the chunker splits at raw newlines (callers with
// has_newlines_in_values use the arrow engine).
static void split_fields_q(const char* line, size_t len, char delim,
                           char quote, std::deque<std::string>* arena,
                           std::vector<std::pair<const char*, size_t>>* out,
                           std::vector<uint8_t>* quoted,
                           bool* unterminated) {
  out->clear();
  if (quoted) quoted->clear();
  size_t i = 0;
  while (i <= len) {
    if (i < len && line[i] == quote) {
      // quoted field, arrow-exact: doubled quotes inside are literals;
      // the FIRST lone closing quote ends quoted mode for good, and
      // everything after it up to the delimiter — including further
      // quote chars — is literal ('"x"yz' -> xyz, '"x"y"z"' -> xy"z").
      std::string buf;
      size_t j = i + 1;
      bool in_q = true;
      size_t close_pos = 0;  // buf length at the closing quote
      while (j < len) {
        char ch = line[j];
        if (in_q) {
          if (ch == quote) {
            if (j + 1 < len && line[j + 1] == quote) {
              buf.push_back(quote);
              j += 2;
              continue;
            }
            in_q = false;
            close_pos = buf.size();
            j++;
            continue;
          }
          buf.push_back(ch);
          j++;
        } else {
          if (ch == delim) break;
          buf.push_back(ch);
          j++;
        }
      }
      // a quoted field running past end-of-line means the value
      // contains a raw newline — the chunker split inside it; callers
      // must fail (arrow with has_newlines_in_values handles those)
      if (in_q) {
        if (unterminated) *unterminated = true;
        close_pos = buf.size();
      }
      // line-ending \r trim: only bytes appended OUTSIDE the quotes
      // (a \r inside the quotes is data)
      while (buf.size() > close_pos && buf.back() == '\r') buf.pop_back();
      arena->push_back(std::move(buf));
      out->push_back({arena->back().data(), arena->back().size()});
      if (quoted) quoted->push_back(1);
      if (j >= len) return;
      i = j + 1;
    } else {
      size_t j = i;
      while (j < len && line[j] != delim) j++;
      size_t flen = j - i;
      while (flen > 0 && line[i + flen - 1] == '\r') flen--;
      out->push_back({line + i, flen});
      if (quoted) quoted->push_back(0);
      if (j >= len) return;
      i = j + 1;
    }
  }
}

struct CsvOpts {
  char quote = 0;  // 0 = quoting off
  bool strings_null = false;  // NullValues apply to string columns too
  std::vector<std::string> na;  // tiny: linear memcmp beats hashing
  std::unordered_map<std::string, int32_t> type_overrides;  // name -> ColType
};

static void csv_split(const char* line, size_t len, char delim,
                      const CsvOpts& o, std::deque<std::string>* arena,
                      std::vector<std::pair<const char*, size_t>>* out,
                      std::vector<uint8_t>* quoted = nullptr,
                      bool* unterminated = nullptr) {
  if (o.quote) {
    arena->clear();
    split_fields_q(line, len, delim, o.quote, arena, out, quoted,
                   unterminated);
  } else {
    split_fields(line, len, delim, out);
    if (quoted) quoted->assign(out->size(), 0);
  }
}

static bool is_na(const CsvOpts& o, const char* s, size_t len) {
  // hot per-cell path: no allocations (the na list is a handful of
  // short spellings)
  for (const auto& v : o.na)
    if (v.size() == len && std::memcmp(v.data(), s, len) == 0) return true;
  return false;
}

static bool parse_i64(const char* s, size_t len, int64_t* out) {
  if (len == 0) return false;
  char buf[32];
  if (len >= sizeof(buf)) return false;
  std::memcpy(buf, s, len);
  buf[len] = 0;
  char* end = nullptr;
  errno = 0;
  long long v = strtoll(buf, &end, 10);
  if (errno != 0 || end != buf + len) return false;
  *out = v;
  return true;
}

static bool parse_f64(const char* s, size_t len, double* out) {
  if (len == 0) return false;
  char buf[64];
  if (len >= sizeof(buf)) return false;
  std::memcpy(buf, s, len);
  buf[len] = 0;
  char* end = nullptr;
  errno = 0;
  double v = strtod(buf, &end);
  if (end != buf + len) return false;
  *out = v;
  return true;
}

static void* csv_read_impl(const char* path, char delim, int has_header,
                           int n_threads, const CsvOpts& opt) {
  auto* res = new CsvResult();
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) {
    res->error = std::string("cannot open ") + path;
    return res;
  }
  std::streamsize size = f.tellg();
  f.seekg(0);
  std::string content(static_cast<size_t>(size), 0);
  if (!f.read(&content[0], size)) {
    res->error = "read failed";
    return res;
  }

  // header
  size_t pos = 0;
  std::vector<std::pair<const char*, size_t>> fields;
  std::deque<std::string> arena;
  size_t first_nl = content.find('\n');
  if (first_nl == std::string::npos) first_nl = content.size();
  csv_split(content.data(), first_nl, delim, opt, &arena, &fields);
  res->n_cols = static_cast<int32_t>(fields.size());
  if (has_header) {
    for (auto& fd : fields) res->names.emplace_back(fd.first, fd.second);
    pos = first_nl + 1;
  } else {
    for (size_t i = 0; i < fields.size(); i++)
      res->names.push_back("f" + std::to_string(i));
  }

  // type inference: the first non-NA value per column decides (a
  // single-row probe would stringify numeric columns whose first
  // values are null spellings). The scan stops as soon as every
  // column is resolved — row 1 for typical files; an all-null column
  // costs one extra pass, the price of agreeing with arrow.
  res->types.assign(res->n_cols, -1);
  {
    size_t p = pos;
    int32_t resolved = 0;
    // explicit overrides resolve up front (parity: WithColumnTypes,
    // csv_read_config.hpp:113) — they must not force the scan on
    for (size_t i = 0; i < res->names.size(); i++) {
      auto it = opt.type_overrides.find(res->names[i]);
      if (it != opt.type_overrides.end()) {
        res->types[i] = it->second;
        resolved++;
      }
    }
    while (p < content.size() && resolved < res->n_cols) {
      size_t nl = content.find('\n', p);
      if (nl == std::string::npos) nl = content.size();
      csv_split(content.data() + p, nl - p, delim, opt, &arena, &fields);
      for (size_t i = 0; i < static_cast<size_t>(res->n_cols); i++) {
        if (res->types[i] != -1 || i >= fields.size()) continue;
        const char* s = fields[i].first;
        size_t sl = fields[i].second;
        if (sl == 0 || is_na(opt, s, sl)) continue;  // undecided
        int64_t iv;
        double dv;
        if (parse_i64(s, sl, &iv)) res->types[i] = COL_INT64;
        else if (parse_f64(s, sl, &dv)) res->types[i] = COL_FLOAT64;
        else res->types[i] = COL_STRING;
        resolved++;
      }
      p = nl + 1;
    }
    for (auto& t : res->types)
      if (t == -1) t = COL_STRING;  // all-null/empty columns
  }

  // chunk boundaries at newlines
  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  size_t body = content.size() - pos;
  size_t chunk = body / static_cast<size_t>(nt) + 1;
  std::vector<std::pair<size_t, size_t>> ranges;
  size_t start = pos;
  while (start < content.size()) {
    size_t end = start + chunk;
    if (end >= content.size()) {
      end = content.size();
    } else {
      size_t nl = content.find('\n', end);
      end = (nl == std::string::npos) ? content.size() : nl + 1;
    }
    ranges.push_back({start, end});
    start = end;
  }

  std::vector<ChunkOut> outs(ranges.size());
  std::atomic<bool> failed{false};
  {
    CylonThreadPool tp(nt);
    for (size_t c = 0; c < ranges.size(); c++) {
      tp.submit([&, c] {
        auto& out = outs[c];
        int ncols = res->n_cols;
        out.i64.resize(ncols);
        out.f64.resize(ncols);
        out.str.resize(ncols);
        out.valid.resize(ncols);
        std::vector<std::pair<const char*, size_t>> fds;
        std::vector<uint8_t> fquoted;
        std::deque<std::string> chunk_arena;
        size_t p = ranges[c].first;
        const size_t end = ranges[c].second;
        while (p < end) {
          size_t nl = content.find('\n', p);
          if (nl == std::string::npos || nl > end) nl = end;
          size_t linelen = nl - p;
          if (linelen > 0 || (p < end && content[p] != '\n')) {
            // skip fully empty lines
            bool empty = true;
            for (size_t i = p; i < p + linelen; i++)
              if (!std::isspace(static_cast<unsigned char>(content[i]))) {
                empty = false;
                break;
              }
            if (!empty) {
              bool unterm = false;
              csv_split(content.data() + p, linelen, delim, opt,
                        &chunk_arena, &fds, &fquoted, &unterm);
              if (unterm) {
                failed.store(true);
                break;
              }
              out.rows++;
              for (int col = 0; col < ncols; col++) {
                const char* s = col < (int)fds.size() ? fds[col].first : "";
                size_t sl = col < (int)fds.size() ? fds[col].second : 0;
                bool was_q = col < (int)fquoted.size() && fquoted[col];
                uint8_t ok = is_na(opt, s, sl) ? 0 : 1;
                switch (res->types[col]) {
                  case COL_INT64: {
                    int64_t v = 0;
                    if (!ok || !parse_i64(s, sl, &v)) ok = 0, v = 0;
                    out.i64[col].push_back(v);
                    break;
                  }
                  case COL_FLOAT64: {
                    double v = 0;
                    if (!ok || !parse_f64(s, sl, &v)) ok = 0, v = 0;
                    out.f64[col].push_back(v);
                    break;
                  }
                  default: {
                    // arrow semantics: NullValues hit string columns
                    // only under StringsCanBeNull, and an explicitly
                    // QUOTED empty field is the empty string, not null
                    if (!ok && !opt.strings_null) ok = 1;
                    if (sl == 0 && !was_q) ok = 0;
                    out.str[col].emplace_back(ok ? s : "", ok ? sl : 0);
                    break;
                  }
                }
                out.valid[col].push_back(ok);
              }
            }
          }
          p = nl + 1;
        }
      });
    }
    tp.wait_all();
  }
  if (failed.load()) {
    res->error = "quoted field contains a raw newline; read with "
                 "has_newlines_in_values (arrow engine)";
    return res;
  }

  // stitch chunks in order
  int ncols = res->n_cols;
  res->i64.resize(ncols);
  res->f64.resize(ncols);
  res->codes.resize(ncols);
  res->validity.resize(ncols);
  res->dict.resize(ncols);
  for (auto& out : outs) res->n_rows += out.rows;
  for (int col = 0; col < ncols; col++) {
    res->validity[col].reserve(res->n_rows);
    if (res->types[col] == COL_INT64) {
      res->i64[col].reserve(res->n_rows);
      for (auto& out : outs) {
        res->i64[col].insert(res->i64[col].end(), out.i64[col].begin(),
                             out.i64[col].end());
        res->validity[col].insert(res->validity[col].end(),
                                  out.valid[col].begin(),
                                  out.valid[col].end());
      }
    } else if (res->types[col] == COL_FLOAT64) {
      res->f64[col].reserve(res->n_rows);
      for (auto& out : outs) {
        res->f64[col].insert(res->f64[col].end(), out.f64[col].begin(),
                             out.f64[col].end());
        res->validity[col].insert(res->validity[col].end(),
                                  out.valid[col].begin(),
                                  out.valid[col].end());
      }
    } else {
      // dictionary-encode: sorted unique values -> int32 codes
      std::map<std::string, int32_t> lut;
      for (auto& out : outs)
        for (auto& s : out.str[col]) lut.emplace(s, 0);
      int32_t code = 0;
      for (auto& kv : lut) kv.second = code++;
      res->dict[col].reserve(lut.size());
      for (auto& kv : lut) res->dict[col].push_back(kv.first);
      res->codes[col].reserve(res->n_rows);
      for (auto& out : outs) {
        for (auto& s : out.str[col])
          res->codes[col].push_back(lut[s]);
        res->validity[col].insert(res->validity[col].end(),
                                  out.valid[col].begin(),
                                  out.valid[col].end());
      }
    }
  }
  return res;
}

void* cylon_csv_read(const char* path, char delim, int has_header,
                     int n_threads) {
  return csv_read_impl(path, delim, has_header, n_threads, CsvOpts());
}

// Extended reader (parity: csv_read_config.hpp UseQuoting/WithQuoteChar/
// NullValues/WithColumnTypes).
//   quote_char:  0 disables quoting.
//   na_values:   '\x1f'-joined null spellings, or NULL.
//   col_types:   "name\x1ftype;..." with type = ColType int, or NULL.
void* cylon_csv_read_opts(const char* path, char delim, int has_header,
                          int n_threads, char quote_char,
                          const char* na_values, const char* col_types,
                          int strings_can_be_null) {
  CsvOpts opt;
  opt.quote = quote_char;
  opt.strings_null = strings_can_be_null != 0;
  if (na_values && *na_values) {
    const char* s = na_values;
    while (true) {
      const char* sep = strchr(s, '\x1f');
      if (!sep) {
        opt.na.emplace_back(s);
        break;
      }
      opt.na.emplace_back(s, sep - s);
      s = sep + 1;
    }
  }
  if (col_types && *col_types) {
    const char* s = col_types;
    while (*s) {
      const char* sep = strchr(s, '\x1f');
      if (!sep) break;  // malformed: ignore rest
      const char* end = strchr(sep + 1, ';');
      std::string name(s, sep - s);
      int32_t t = static_cast<int32_t>(
          strtol(sep + 1, nullptr, 10));
      if (t >= COL_INT64 && t <= COL_STRING) opt.type_overrides[name] = t;
      if (!end) break;
      s = end + 1;
    }
  }
  return csv_read_impl(path, delim, has_header, n_threads, opt);
}

const char* cylon_csv_error(void* r) {
  auto* res = static_cast<CsvResult*>(r);
  return res->error.empty() ? nullptr : res->error.c_str();
}

int64_t cylon_csv_num_rows(void* r) {
  return static_cast<CsvResult*>(r)->n_rows;
}

int32_t cylon_csv_num_cols(void* r) {
  return static_cast<CsvResult*>(r)->n_cols;
}

const char* cylon_csv_col_name(void* r, int32_t col) {
  return static_cast<CsvResult*>(r)->names[col].c_str();
}

int32_t cylon_csv_col_type(void* r, int32_t col) {
  return static_cast<CsvResult*>(r)->types[col];
}

// Copy column data into caller-provided buffers (numpy-owned).
void cylon_csv_col_i64(void* r, int32_t col, int64_t* out) {
  auto* res = static_cast<CsvResult*>(r);
  std::memcpy(out, res->i64[col].data(), res->n_rows * sizeof(int64_t));
}

void cylon_csv_col_f64(void* r, int32_t col, double* out) {
  auto* res = static_cast<CsvResult*>(r);
  std::memcpy(out, res->f64[col].data(), res->n_rows * sizeof(double));
}

void cylon_csv_col_codes(void* r, int32_t col, int32_t* out) {
  auto* res = static_cast<CsvResult*>(r);
  std::memcpy(out, res->codes[col].data(), res->n_rows * sizeof(int32_t));
}

void cylon_csv_col_validity(void* r, int32_t col, uint8_t* out) {
  auto* res = static_cast<CsvResult*>(r);
  std::memcpy(out, res->validity[col].data(), res->n_rows);
}

int32_t cylon_csv_dict_size(void* r, int32_t col) {
  return static_cast<int32_t>(static_cast<CsvResult*>(r)->dict[col].size());
}

const char* cylon_csv_dict_value(void* r, int32_t col, int32_t code) {
  return static_cast<CsvResult*>(r)->dict[col][code].c_str();
}

void cylon_csv_free(void* r) { delete static_cast<CsvResult*>(r); }

// ------------------------------------------------------------------
// Catalog: string-id keyed columnar table registry, C ABI.
//
// Parity: table_api.{hpp,cpp} PutTable/GetTable/RemoveTable (:38-90) —
// the exact surface the reference's Java binding drives over JNI
// (Table.java:289-307 -> java/src/main/native/src/Table.cpp). Any FFI
// runtime (JNI, ctypes, cffi, .NET) binds these symbols; the Python
// bridge in native/__init__.py is one such client and round-trips full
// cylon_tpu_torch Tables (dictionary columns ride as a codes column plus two
// companion blob/offset columns, documented there).
//
// Columns are opaque byte buffers tagged with a caller-defined dtype
// code; the catalog copies in on put and out on read, so callers never
// share ownership across the ABI. All entry points are mutex-guarded
// (the JNI bridge in the reference serialises through the same kind of
// global registry).
// ------------------------------------------------------------------

namespace {

struct CatColumn {
  std::string name;
  int32_t dtype = 0;
  std::vector<uint8_t> data;
  std::vector<uint8_t> validity;  // empty = no nulls
};

struct CatTable {
  int64_t n_rows = 0;
  std::vector<CatColumn> cols;
};

std::mutex g_catalog_mu;
std::unordered_map<std::string, CatTable>& catalog() {
  static std::unordered_map<std::string, CatTable> c;
  return c;
}

}  // namespace

int32_t cylon_catalog_put(const char* id, int32_t ncols,
                          const char** names, const int32_t* dtypes,
                          int64_t n_rows, const void** data_bufs,
                          const int64_t* data_lens,
                          const uint8_t** validity_bufs) {
  if (!id || ncols < 0 || n_rows < 0) return -1;
  CatTable t;
  t.n_rows = n_rows;
  t.cols.reserve(ncols);
  for (int32_t i = 0; i < ncols; ++i) {
    CatColumn col;
    col.name = names[i];
    col.dtype = dtypes[i];
    const auto* p = static_cast<const uint8_t*>(data_bufs[i]);
    col.data.assign(p, p + data_lens[i]);
    if (validity_bufs && validity_bufs[i]) {
      col.validity.assign(validity_bufs[i], validity_bufs[i] + n_rows);
    }
    t.cols.push_back(std::move(col));
  }
  std::lock_guard<std::mutex> lk(g_catalog_mu);
  catalog()[id] = std::move(t);  // overwrite, like PutTable
  return 0;
}

int64_t cylon_catalog_rows(const char* id) {
  std::lock_guard<std::mutex> lk(g_catalog_mu);
  auto it = catalog().find(id);
  return it == catalog().end() ? -1 : it->second.n_rows;
}

int32_t cylon_catalog_ncols(const char* id) {
  std::lock_guard<std::mutex> lk(g_catalog_mu);
  auto it = catalog().find(id);
  return it == catalog().end() ? -1
                               : static_cast<int32_t>(it->second.cols.size());
}

// returns the column name's byte length on success (callers retry with
// a bigger buffer when it is >= name_cap — snprintf truncated), or a
// negative error code.
int32_t cylon_catalog_col_info(const char* id, int32_t i, char* name_out,
                               int32_t name_cap, int32_t* dtype_out,
                               int64_t* nbytes_out, int32_t* has_validity) {
  std::lock_guard<std::mutex> lk(g_catalog_mu);
  auto it = catalog().find(id);
  if (it == catalog().end()) return -1;
  if (i < 0 || i >= static_cast<int32_t>(it->second.cols.size())) return -2;
  const CatColumn& c = it->second.cols[i];
  std::snprintf(name_out, name_cap, "%s", c.name.c_str());
  *dtype_out = c.dtype;
  *nbytes_out = static_cast<int64_t>(c.data.size());
  *has_validity = c.validity.empty() ? 0 : 1;
  return static_cast<int32_t>(c.name.size());
}

// data_cap bounds the write into data_out (-3 if too small).
int32_t cylon_catalog_col_read(const char* id, int32_t i, void* data_out,
                               int64_t data_cap, uint8_t* validity_out) {
  std::lock_guard<std::mutex> lk(g_catalog_mu);
  auto it = catalog().find(id);
  if (it == catalog().end()) return -1;
  if (i < 0 || i >= static_cast<int32_t>(it->second.cols.size())) return -2;
  const CatColumn& c = it->second.cols[i];
  if (data_cap < static_cast<int64_t>(c.data.size())) return -3;
  std::memcpy(data_out, c.data.data(), c.data.size());
  if (validity_out && !c.validity.empty()) {
    std::memcpy(validity_out, c.validity.data(), c.validity.size());
  }
  return 0;
}

int32_t cylon_catalog_remove(const char* id) {
  std::lock_guard<std::mutex> lk(g_catalog_mu);
  return catalog().erase(id) ? 0 : -1;
}

int32_t cylon_catalog_size() {
  std::lock_guard<std::mutex> lk(g_catalog_mu);
  return static_cast<int32_t>(catalog().size());
}

// newline-joined ids; returns bytes written (excluding NUL), or the
// required size if cap is too small (call twice).
int64_t cylon_catalog_ids(char* buf, int64_t cap) {
  std::lock_guard<std::mutex> lk(g_catalog_mu);
  std::string all;
  for (const auto& kv : catalog()) {
    if (!all.empty()) all += '\n';
    all += kv.first;
  }
  int64_t need = static_cast<int64_t>(all.size());
  if (buf && cap > need) {
    std::memcpy(buf, all.data(), all.size());
    buf[all.size()] = '\0';
    return need;
  }
  return need + 1;
}

void cylon_catalog_clear() {
  std::lock_guard<std::mutex> lk(g_catalog_mu);
  catalog().clear();
}

}  // extern "C"

// ------------------------------------------------------------------
// Native host join over catalog tables.
//
// Parity: the reference's string-id join surface used by the Java
// binding — `table_api` JoinTables (`table_api.hpp:38-90`) behind
// `Table.java:289-307` nativeJoin. This is the HOST runtime's join
// (hash build + probe, like `join/hash_join.cpp:22-31`): a foreign
// runtime (C/JNI/Go) can put tables, join, and read results with no
// Python in the process. The device path (`cylon_tpu_torch.ops.join`)
// remains the compute engine for device-resident tables; this covers the
// catalog/FFI surface with the same null==null, pandas-suffix
// semantics so results agree with the device join.
// ------------------------------------------------------------------

namespace {

// canonical 64-bit cell image: int64/f64 as 8 bytes (f64 canonicalises
// -0.0 and NaN so bit-equality == value-equality, matching
// kernels.order_key), int32 codes sign-extended.
inline int64_t cell_bits(const CatColumn& c, int64_t i) {
  if (c.dtype == 2) {
    int32_t v;
    std::memcpy(&v, c.data.data() + i * 4, 4);
    return v;
  }
  if (c.dtype == 1) {
    double d;
    std::memcpy(&d, c.data.data() + i * 8, 8);
    if (d == 0.0) d = 0.0;                      // -0.0 -> +0.0
    if (d != d) d = std::numeric_limits<double>::quiet_NaN();
    int64_t v;
    std::memcpy(&v, &d, 8);
    return v;
  }
  int64_t v;
  std::memcpy(&v, c.data.data() + i * 8, 8);
  return v;
}

inline bool cell_valid(const CatColumn& c, int64_t i) {
  return c.validity.empty() || c.validity[i] != 0;
}

inline int64_t cell_width(const CatColumn& c) {
  return c.dtype == 2 ? 4 : 8;
}

// ---- dictionary sidecars (the Python binding's wire convention,
// native/__init__.py: "<col>\x01blob" utf8 bytes + "<col>\x01offs"
// int64 offsets carry a string column's dictionary through the
// catalog; the device program only ever sees the int32 codes) ----

constexpr char kSidecarSep = '\x01';

inline bool is_sidecar(const std::string& n) {
  return n.find(kSidecarSep) != std::string::npos;
}

inline int find_col(const CatTable& t, const std::string& name) {
  for (size_t i = 0; i < t.cols.size(); ++i)
    if (t.cols[i].name == name) return (int)i;
  return -1;
}

bool extract_dict(const CatTable& t, const std::string& base,
                  std::vector<std::string>* out) {
  int bi = find_col(t, base + kSidecarSep + std::string("blob"));
  int oi = find_col(t, base + kSidecarSep + std::string("offs"));
  if (bi < 0 || oi < 0) return false;
  const auto& blob = t.cols[bi].data;
  const auto& offs = t.cols[oi].data;
  if (offs.size() < 8 || offs.size() % 8) return false;
  size_t n = offs.size() / 8 - 1;
  out->clear();
  for (size_t i = 0; i < n; ++i) {
    int64_t a, b;
    std::memcpy(&a, offs.data() + i * 8, 8);
    std::memcpy(&b, offs.data() + (i + 1) * 8, 8);
    if (a < 0 || b < a || (size_t)b > blob.size()) return false;
    out->emplace_back(blob.begin() + a, blob.begin() + b);
  }
  return true;
}

void append_dict_sidecars(CatTable* out, const std::string& base,
                          const std::vector<std::string>& values) {
  CatColumn blob, offs;
  blob.name = base + kSidecarSep + std::string("blob");
  blob.dtype = 1;  // Kind.UINT8 tag, matching the Python binding
  offs.name = base + kSidecarSep + std::string("offs");
  offs.dtype = 8;  // Kind.INT64 tag
  offs.data.resize((values.size() + 1) * 8, 0);
  int64_t pos = 0;
  for (size_t i = 0; i < values.size(); ++i) {
    blob.data.insert(blob.data.end(), values[i].begin(), values[i].end());
    pos += (int64_t)values[i].size();
    std::memcpy(offs.data.data() + (i + 1) * 8, &pos, 8);
  }
  out->cols.push_back(std::move(blob));
  out->cols.push_back(std::move(offs));
}

// ---- join key views: the physical interpretation of a key column.
// Accepts both the raw C-client tags (0 int64 / 1 f64 / 2 codes,
// cylon_host.h) and the Python binding's Kind tags (8=INT64,
// 11=DOUBLE, 12/13=STRING/BINARY codes). ----

struct KeyCol {
  const CatColumn* col;
  int cls;    // 0 = int image, 1 = f64, 2 = int32 codes, 3 = f32
  int width;  // bytes per element (class 0; others fixed 4/8)
};

// Resolve a key column's physical interpretation from its tag AND its
// measured element width. The raw C-client tags (0 int64 / 1 f64 /
// 2 codes) collide with Kind values (BOOL=0 / UINT8=1 / INT8=2); the
// width disambiguates: a Kind-tagged narrow column is 1 byte/row, the
// C-client meanings are 8/8/4. Every class validates the buffer size
// against n_rows so an under-sized or mis-tagged buffer is rejected
// (-1 -> join status -4) instead of read out of bounds.
struct KeyClass {
  int cls;    // -1 = unsupported/mis-sized
  int width;
};

inline KeyClass key_class(const CatColumn& c, int64_t n_rows) {
  int tag = c.dtype & 0xFF;
  if (n_rows <= 0) return {0, 0};  // no reads ever issued
  if ((int64_t)c.data.size() % n_rows != 0) return {-1, 0};
  int64_t w = (int64_t)c.data.size() / n_rows;
  if (tag == 12 || tag == 13) return w == 4 ? KeyClass{2, 4} : KeyClass{-1, 0};
  if (tag == 11) return w == 8 ? KeyClass{1, 8} : KeyClass{-1, 0};
  if (tag == 10) return w == 4 ? KeyClass{3, 4} : KeyClass{-1, 0};
  if (tag == 9) return {-1, 0};  // f16 keys: raw-bit compare would get
                                 // -0.0/NaN wrong; unsupported (as before)
  if (tag == 2) {   // C-client codes (4) vs Kind.INT8 (1)
    if (w == 4) return {2, 4};
    if (w == 1) return {0, 1};
    return {-1, 0};
  }
  if (tag == 1) {   // C-client f64 (8) vs Kind.UINT8 (1)
    if (w == 8) return {1, 8};
    if (w == 1) return {0, 1};
    return {-1, 0};
  }
  if (tag == 0) {   // C-client int64 (8) vs Kind.BOOL (1)
    if (w == 8) return {0, 8};
    if (w == 1) return {0, 1};
    return {-1, 0};
  }
  // remaining int/temporal kinds: raw little-endian image of their width
  if (w == 1 || w == 2 || w == 4 || w == 8) return {0, (int)w};
  return {-1, 0};
}

inline int64_t key_bits(const KeyCol& k, int64_t i) {
  const CatColumn& c = *k.col;
  if (k.cls == 2) {
    int32_t v;
    std::memcpy(&v, c.data.data() + i * 4, 4);
    return v;
  }
  if (k.cls == 1) {
    double d;
    std::memcpy(&d, c.data.data() + i * 8, 8);
    if (d == 0.0) d = 0.0;                      // -0.0 -> +0.0
    if (d != d) d = std::numeric_limits<double>::quiet_NaN();
    int64_t v;
    std::memcpy(&v, &d, 8);
    return v;
  }
  if (k.cls == 3) {
    float f;
    std::memcpy(&f, c.data.data() + i * 4, 4);
    if (f == 0.0f) f = 0.0f;                    // -0.0 -> +0.0
    if (f != f) f = std::numeric_limits<float>::quiet_NaN();
    int32_t v;
    std::memcpy(&v, &f, 4);
    return v;
  }
  // int image, zero-extended: both sides share the exact dtype tag
  // (enforced before key setup), so equal bits <=> equal values
  uint64_t v = 0;
  std::memcpy(&v, c.data.data() + i * k.width, (size_t)k.width);
  return (int64_t)v;
}

// composite row-key hash over the key views (null == null: validity
// folds in as its own word, like ops/hash._row_words)
inline uint64_t row_key_hash(const std::vector<KeyCol>& keys, int64_t i) {
  uint64_t h = 0x9E3779B97F4A7C15ull;
  for (const KeyCol& k : keys) {
    bool valid = cell_valid(*k.col, i);
    uint64_t w = valid ? static_cast<uint64_t>(key_bits(k, i)) : 0ull;
    h ^= w + 0x9E3779B97F4A7C15ull + (h << 6) + (h >> 2);
    h ^= (valid ? 0x517CC1B727220A95ull : 0x2545F4914F6CDD1Dull)
         + (h << 6) + (h >> 2);
  }
  return h;
}

inline bool rows_key_equal(const std::vector<KeyCol>& ka, int64_t i,
                           const std::vector<KeyCol>& kb, int64_t j) {
  for (size_t f = 0; f < ka.size(); ++f) {
    bool va = cell_valid(*ka[f].col, i), vb = cell_valid(*kb[f].col, j);
    if (va != vb) return false;
    if (va && key_bits(ka[f], i) != key_bits(kb[f], j)) return false;
  }
  return true;
}

// gather `rows` (with -1 = null slot) from `src` into a fresh column;
// `w` is the per-row byte width (from data length / n_rows — dtype
// tags alone are ambiguous across the two tag conventions)
CatColumn gather_col_w(const CatColumn& src, int64_t w,
                       const std::vector<int64_t>& rows) {
  CatColumn out;
  out.name = src.name;
  out.dtype = src.dtype;
  out.data.assign(rows.size() * w, 0);
  bool any_null = false;
  out.validity.assign(rows.size(), 1);
  for (size_t r = 0; r < rows.size(); ++r) {
    int64_t i = rows[r];
    if (i < 0 || !cell_valid(src, i)) {
      out.validity[r] = 0;
      any_null = true;
      continue;
    }
    std::memcpy(out.data.data() + r * w, src.data.data() + i * w, w);
  }
  if (!any_null) out.validity.clear();
  return out;
}

CatColumn gather_col(const CatColumn& src, const std::vector<int64_t>& rows) {
  return gather_col_w(src, cell_width(src), rows);
}

}  // namespace

extern "C" {

int32_t cylon_catalog_join(const char* left_id, const char* right_id,
                           const char* out_id, int32_t n_keys,
                           const int32_t* left_keys,
                           const int32_t* right_keys,
                           int32_t join_type) {
  if (!left_id || !right_id || !out_id || n_keys <= 0 || !left_keys ||
      !right_keys || join_type < 0 || join_type > 3)
    return -1;
  std::lock_guard<std::mutex> lk(g_catalog_mu);
  auto lit = catalog().find(left_id);
  auto rit = catalog().find(right_id);
  if (lit == catalog().end() || rit == catalog().end()) return -2;
  const CatTable& L = lit->second;
  const CatTable& R = rit->second;
  std::vector<int32_t> lk_(left_keys, left_keys + n_keys);
  std::vector<int32_t> rk_(right_keys, right_keys + n_keys);
  for (int32_t i = 0; i < n_keys; ++i) {
    if (lk_[i] < 0 || lk_[i] >= (int32_t)L.cols.size() || rk_[i] < 0 ||
        rk_[i] >= (int32_t)R.cols.size())
      return -3;
    // exact tag equality (incl. temporal-unit bits): equal raw images
    // of DIFFERENT logical types (timestamp[s] vs [ms]) must not join
    // on bit coincidence. The stringish tags {2 raw codes, 12 STRING,
    // 13 LARGE_STRING} are one logical class across the two tag
    // conventions (the JNI writes 2, the Python binding 12): they
    // compare by resolved KeyClass below, and sidecar dictionaries
    // make the codes comparable by VALUE — so a Java-vs-Python
    // string-key join is legal, not a -4.
    auto stringish = [](int32_t d) {
      int t = d & 0xFF;
      return t == 2 || t == 12 || t == 13;
    };
    if (L.cols[lk_[i]].dtype != R.cols[rk_[i]].dtype) {
      if (!(stringish(L.cols[lk_[i]].dtype) &&
            stringish(R.cols[rk_[i]].dtype)))
        return -4;
      // cross-convention string keys are only meaningful when BOTH
      // sides carry sidecar dictionaries (the unification below then
      // compares by VALUE); a sidecar-less raw-code side would fall
      // through to the legacy bit compare of TABLE-LOCAL codes —
      // exactly the bit-coincidence join the strict gate existed to
      // reject. Presence check only (cheap); a present-but-malformed
      // sidecar is re-rejected when the unification loop extracts it.
      auto has_sidecars = [](const CatTable& t, const std::string& base) {
        return find_col(t, base + kSidecarSep + std::string("blob")) >= 0 &&
               find_col(t, base + kSidecarSep + std::string("offs")) >= 0;
      };
      if (!has_sidecars(L, L.cols[lk_[i]].name) ||
          !has_sidecars(R, R.cols[rk_[i]].name))
        return -4;
    }
    KeyClass lkc = key_class(L.cols[lk_[i]], L.n_rows);
    KeyClass rkc = key_class(R.cols[rk_[i]], R.n_rows);
    if (lkc.cls < 0 || rkc.cls < 0) return -4;
    // equal AMBIGUOUS tags can still resolve to different physical
    // interpretations (raw C-client codes vs Kind.INT8, f64 vs uint8):
    // matching on bit coincidence across classes/widths is meaningless.
    // Empty sides (n_rows == 0, width 0) match anything: no reads occur
    // and the join degenerates per join type.
    if (L.n_rows > 0 && R.n_rows > 0 &&
        (lkc.cls != rkc.cls || lkc.width != rkc.width))
      return -4;
  }

  // dictionary-aware keys: codes are TABLE-LOCAL (each ingest assigns
  // its own), so when both sides carry their dictionaries (sidecar
  // columns) the codes are remapped onto one merged sorted dictionary
  // before hashing — otherwise equal strings with different codes
  // would not join (and different strings with equal codes would).
  // Raw-code tables without sidecars keep the legacy bit compare.
  std::deque<CatColumn> shadows;
  std::vector<KeyCol> lkv, rkv;
  std::vector<int8_t> unified(n_keys, 0);
  std::vector<std::vector<std::string>> merged_vals(n_keys);
  for (int32_t f = 0; f < n_keys; ++f) {
    const CatColumn& lc = L.cols[lk_[f]];
    const CatColumn& rc = R.cols[rk_[f]];
    KeyClass lkc = key_class(lc, L.n_rows);
    KeyClass rkc = key_class(rc, R.n_rows);
    int cls = lkc.cls;
    if (cls == 2 && rkc.cls == 2) {
      bool mixed_tags = lc.dtype != rc.dtype;
      std::vector<std::string> lv, rv;
      bool unified_ok =
          extract_dict(L, lc.name, &lv) && extract_dict(R, rc.name, &rv);
      // mixed-tag keys passed the gate on sidecar PRESENCE; if the
      // sidecars turn out malformed the bit-compare fallback would be
      // meaningless across conventions — reject instead
      if (mixed_tags && !unified_ok) return -4;
      if (unified_ok) {
        std::vector<std::string> merged = lv;
        merged.insert(merged.end(), rv.begin(), rv.end());
        std::sort(merged.begin(), merged.end());
        merged.erase(std::unique(merged.begin(), merged.end()),
                     merged.end());
        auto remap = [&merged](const std::vector<std::string>& vals) {
          std::vector<int32_t> m(vals.size());
          for (size_t c = 0; c < vals.size(); ++c)
            m[c] = (int32_t)(std::lower_bound(merged.begin(), merged.end(),
                                              vals[c]) - merged.begin());
          return m;
        };
        std::vector<int32_t> lm = remap(lv), rm = remap(rv);
        auto shadow = [&shadows](const CatColumn& src, int64_t n,
                                 const std::vector<int32_t>& m) {
          CatColumn s;
          s.dtype = 2;
          s.validity = src.validity;
          s.data.assign((size_t)n * 4, 0);
          for (int64_t i = 0; i < n; ++i) {
            int32_t code;
            std::memcpy(&code, src.data.data() + i * 4, 4);
            int32_t u = (code >= 0 && (size_t)code < m.size())
                            ? m[code] : -1;
            std::memcpy(s.data.data() + i * 4, &u, 4);
          }
          shadows.push_back(std::move(s));
          return &shadows.back();
        };
        lkv.push_back({shadow(lc, L.n_rows, lm), 2, 4});
        rkv.push_back({shadow(rc, R.n_rows, rm), 2, 4});
        unified[f] = 1;
        merged_vals[f] = std::move(merged);
        continue;
      }
    }
    lkv.push_back({&lc, cls, lkc.width});
    rkv.push_back({&rc, rkc.cls, rkc.width});
  }

  // build on the right, probe from the left (hash_join.cpp builds on
  // the smaller side; catalog joins are host-sized, simplicity wins)
  std::unordered_map<uint64_t, std::vector<int64_t>> buckets;
  buckets.reserve(R.n_rows * 2);
  for (int64_t j = 0; j < R.n_rows; ++j)
    buckets[row_key_hash(rkv, j)].push_back(j);

  std::vector<int64_t> li_out, ri_out;
  std::vector<uint8_t> r_matched(R.n_rows, 0);
  const bool emit_left = join_type == 1 || join_type == 3;   // left/full
  const bool emit_right = join_type == 2 || join_type == 3;  // right/full
  for (int64_t i = 0; i < L.n_rows; ++i) {
    auto it = buckets.find(row_key_hash(lkv, i));
    bool any = false;
    if (it != buckets.end()) {
      for (int64_t j : it->second) {
        if (rows_key_equal(lkv, i, rkv, j)) {
          li_out.push_back(i);
          ri_out.push_back(j);
          r_matched[j] = 1;
          any = true;
        }
      }
    }
    if (!any && emit_left) {
      li_out.push_back(i);
      ri_out.push_back(-1);
    }
  }
  if (emit_right) {
    for (int64_t j = 0; j < R.n_rows; ++j) {
      if (!r_matched[j]) {
        li_out.push_back(-1);
        ri_out.push_back(j);
      }
    }
  }

  // assemble, matching the device join's naming (_assemble in
  // ops/join.py, itself pandas-merge semantics): a key pair is SHARED
  // only when the two columns have the same name — shared keys emit one
  // coalesced column and the right copy is dropped; differently-named
  // keys stay separate columns (left side null for right-only rows).
  // Remaining name collisions get the pandas _x/_y suffixes.
  CatTable out;
  out.n_rows = static_cast<int64_t>(li_out.size());
  std::unordered_map<std::string, int> name_count;
  std::vector<uint8_t> drop_r(R.cols.size(), 0);   // shared (same-name) keys
  std::vector<int32_t> coalesce_r(L.cols.size(), -1);
  std::vector<int32_t> key_of_l(L.cols.size(), -1);
  for (int32_t f = 0; f < n_keys; ++f) {
    key_of_l[lk_[f]] = f;
    if (L.cols[lk_[f]].name == R.cols[rk_[f]].name) {
      drop_r[rk_[f]] = 1;
      coalesce_r[lk_[f]] = rk_[f];
    }
  }
  // dictionary sidecars never enter the row loops: they are carried
  // table-level metadata (dict length != row count), re-emitted under
  // each surviving dict column's FINAL name at the end
  for (const auto& c : L.cols)
    if (!is_sidecar(c.name)) name_count[c.name]++;
  for (size_t j = 0; j < R.cols.size(); ++j)
    if (!drop_r[j] && !is_sidecar(R.cols[j].name))
      name_count[R.cols[j].name]++;

  auto width_of = [](const CatTable& t, const CatColumn& c) {
    if (t.n_rows > 0) return (int64_t)c.data.size() / t.n_rows;
    int tag = c.dtype & 0xFF;
    return (int64_t)((tag == 2 || tag == 12 || tag == 13) ? 4 : 8);
  };

  // final name -> dictionary values to re-emit
  std::vector<std::pair<std::string, std::vector<std::string>>> out_dicts;

  for (size_t ci = 0; ci < L.cols.size(); ++ci) {
    if (is_sidecar(L.cols[ci].name)) continue;
    int32_t f = key_of_l[ci];
    bool uni = f >= 0 && unified[f];
    // unified dict keys join (and emit) in merged-code space: the
    // shadow columns already hold merged ids for both sides
    const CatColumn& lsrc = uni ? *lkv[f].col : L.cols[ci];
    const int64_t w = uni ? 4 : width_of(L, L.cols[ci]);
    CatColumn col = gather_col_w(lsrc, w, li_out);
    col.name = L.cols[ci].name;
    col.dtype = L.cols[ci].dtype;
    if (coalesce_r[ci] >= 0 && !col.validity.empty()) {
      // shared key: fill right-only rows from the right key column
      const CatColumn& rc = uni ? *rkv[f].col : R.cols[coalesce_r[ci]];
      for (size_t r = 0; r < li_out.size(); ++r) {
        if (li_out[r] >= 0 || ri_out[r] < 0) continue;
        if (!cell_valid(rc, ri_out[r])) continue;
        std::memcpy(col.data.data() + r * w,
                    rc.data.data() + ri_out[r] * w, w);
        col.validity[r] = 1;
      }
      if (std::find(col.validity.begin(), col.validity.end(), 0) ==
          col.validity.end())
        col.validity.clear();
    }
    bool shared_key = coalesce_r[ci] >= 0;
    if (!shared_key && name_count[col.name] > 1) col.name += "_x";
    if (uni) {
      out_dicts.emplace_back(col.name, merged_vals[f]);
    } else {
      std::vector<std::string> dv;
      if (key_class(L.cols[ci], L.n_rows).cls == 2
          && extract_dict(L, L.cols[ci].name, &dv))
        out_dicts.emplace_back(col.name, std::move(dv));
    }
    out.cols.push_back(std::move(col));
  }
  for (size_t cj = 0; cj < R.cols.size(); ++cj) {
    if (drop_r[cj] || is_sidecar(R.cols[cj].name)) continue;
    CatColumn col = gather_col_w(R.cols[cj], width_of(R, R.cols[cj]),
                                 ri_out);
    if (name_count[col.name] > 1) col.name += "_y";
    std::vector<std::string> dv;
    if (key_class(R.cols[cj], R.n_rows).cls == 2
        && extract_dict(R, R.cols[cj].name, &dv))
      out_dicts.emplace_back(col.name, std::move(dv));
    out.cols.push_back(std::move(col));
  }
  for (auto& kv : out_dicts)
    append_dict_sidecars(&out, kv.first, kv.second);
  catalog()[out_id] = std::move(out);
  return 0;
}

}  // extern "C"
