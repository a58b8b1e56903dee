// The bucketed hash join's two kernels: bucket_build and bucket_probe.
//
// Replace the Pallas kernels of cylon_tpu/ops/pallas_kernels.py:
//   bucket_build: _bucket_build_kernel / _bucket_build_impl
//   bucket_probe: _bucket_probe_kernel / _bucket_probe_impl
// The table is entry-major [width, nb] int32, as in the JAX package: entry e
// of bucket b (table[e * nb + b]) holds the (e+1)-th smallest row id whose
// bucket id is b, or -1. Bit-identical to the plain versions in
// cylon_tpu_torch/kernels/bucket.py (ports of hash_join._build_jnp and
// _probe_jnp).
//
// The Pallas bodies run one sequential loop per tile, because Mosaic cannot
// vectorise data-dependent row work. Here one thread takes one row.
//
// bucket_build. Bound on an H100: the table fill (4 * width * nb bytes)
// plus 4 * cap bytes of ids, at 3.35 TB/s. Each row is one to a few random
// 4-byte atomics into a table far larger than L2, so every atomic costs a
// 32-byte sector round trip and the kernel runs well above the byte bound.
// Design: a first-free-slot insert with atomicCAS would place rows in
// arrival order, which is not deterministic. Instead each slot is unsigned
// and starts at 0xFFFFFFFF (-1 as int32, and the unsigned maximum); a row
// carries its id v and walks e = 0..width-1 doing
//   old = atomicMin(&table[e][b], v); v = max(old, v)
// until it carries 0xFFFFFFFF. Slot 0 ends as the smallest id of the bucket
// and passes every other id on, exactly once, so slot e ends as the (e+1)-th
// smallest, whatever the order the atomics land in. An id still carried
// past the last entry counts one overflow, so the count is
// sum over buckets of max(count - width, 0), again in any order.
//
// bucket_probe. Bound: 4 * pcap bytes of bucket ids, 4 * nwords * pcap of
// probe words and 4 * pcap of mask, plus the occupied table entries and
// the build words once. Each probe row reads its chain's entries up to the
// first -1 and one build key per entry, at random addresses: at n = nb
// with unique build keys that is about 3 random reads a row. On an H100 a
// random read of 32 bytes takes as long as one of 64 (the memory fetches
// at least 64 bytes for it), so the kernel is bound by the rate of random
// reads, well above the byte bound, and more reads in flight (several rows
// a thread) do not make it faster.
// Design: one thread a probe row; what it can do is issue fewer and
// earlier requests:
//   - the address of the row's next candidate entry depends on its bucket
//     id alone, so its load goes out beside the build key of the current
//     entry: one round trip an entry, not two, and no sector is read that
//     a walk to the first -1 does not read;
//   - where the key is one int64 column on both sides (its (lo, hi) words
//     4 bytes apart, stride 2, 8-byte aligned; the wrapper decides from the
//     pointers and strides and passes a flag, checked here), the key is one
//     8-byte load a side. Any other layout (a validity word, several
//     columns) compares word by word, stopping at the first that differs.
//     Either way the probe row's first word (or key) is loaded once.
// Bit e of a row's mask is set when every key word of build row
// table[e][b] equals the probe row's; a row >= bcap is skipped. The word
// streams come as pointers and element strides, as in row_hash, so an
// int64 key's words are read in place. Any number of words: a key of more
// than kChunk words runs over chunks of kChunk word pairs, one launch
// each; a later chunk walks only the bits the earlier ones left set (read
// back from the mask), so the result is the AND over all words.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;

struct WordPairs {
  const uint32_t* probe[kChunk];
  const uint32_t* build[kChunk];
  long long probe_stride[kChunk];
  long long build_stride[kChunk];
  int count;
};

long long grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

// The key of bucket_probe, by word layout: `probe` / `build` load word 0
// (the whole key for Int64Key) of a probe row / a build row, and
// `words(w)` counts the words.
struct Int64Key {
  using K = unsigned long long;
  __device__ static K probe(const WordPairs& w, long long i) {
    return __ldg(reinterpret_cast<const K*>(w.probe[0]) + i);
  }
  __device__ static K build(const WordPairs& w, long long r) {
    return __ldg(reinterpret_cast<const K*>(w.build[0]) + r);
  }
  __device__ static int words(const WordPairs&) { return 1; }
};

struct AnyWords {
  using K = uint32_t;
  __device__ static K probe(const WordPairs& w, long long i) {
    return __ldg(w.probe[0] + i * w.probe_stride[0]);
  }
  __device__ static K build(const WordPairs& w, long long r) {
    return __ldg(w.build[0] + r * w.build_stride[0]);
  }
  __device__ static int words(const WordPairs& w) { return w.count; }
};

// Is (lo, hi) one int64 column read in place: hi 4 bytes after lo, both of
// stride 2, lo 8-byte aligned?
bool int64_halves(const void* lo, const void* hi, long long lo_stride,
                  long long hi_stride) {
  const auto a = reinterpret_cast<uintptr_t>(lo);
  return lo_stride == 2 && hi_stride == 2 && a % 8 == 0 &&
         reinterpret_cast<uintptr_t>(hi) == a + 4;
}

__global__ void __launch_bounds__(kThreads)
bucket_build_kernel(const int32_t* __restrict__ bids, long long cap,
                    long long nb, int width, uint32_t* table,
                    int32_t* overflow) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cap; i += step) {
    const int32_t b = bids[i];
    if (b < 0) continue;
    if (b >= nb) {  // no bucket to place it in: it stays unplaced
      atomicAdd(overflow, 1);
      continue;
    }
    uint32_t v = static_cast<uint32_t>(i);
    uint32_t* slot = table + b;
    for (int e = 0; e < width; ++e, slot += nb) {
      const uint32_t old = atomicMin(slot, v);
      v = old > v ? old : v;
      if (v == kEmpty) break;
    }
    if (v != kEmpty) atomicAdd(overflow, 1);
  }
}

// first: every entry is a candidate; later chunks walk only the bits the
// earlier chunks left set in mask.
template <class Key>
__global__ void __launch_bounds__(kThreads)
bucket_probe_kernel(const int32_t* __restrict__ pbids, long long pcap,
                    const int32_t* __restrict__ table, long long nb,
                    int width, long long bcap,
                    const __grid_constant__ WordPairs words, int first,
                    int32_t* mask) {
  using K = typename Key::K;
  const uint32_t all = (1u << width) - 1u;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < pcap; i += step) {
    const int32_t b = pbids[i];
    const uint32_t cand = b < 0 || b >= nb ? 0u
                          : first          ? all
                                           : static_cast<uint32_t>(mask[i]);
    const K key = cand ? Key::probe(words, i) : K(0);
    int e = cand ? __ffs(cand) - 1 : -1;  // the entry under test
    int32_t cur = e >= 0 ? __ldg(table + e * nb + b) : -1;  // its build row
    uint32_t m = 0;
    while (e >= 0 && cur >= 0) {
      // the next candidate entry's load goes out beside this entry's key
      const uint32_t rest = cand & ~((2u << e) - 1u);
      const int next = rest ? __ffs(rest) - 1 : -1;
      const int32_t ahead = next >= 0 ? __ldg(table + next * nb + b) : -1;
      if (cur < bcap) {
        bool eq = Key::build(words, cur) == key;
        for (int j = 1; j < Key::words(words) && eq; ++j) {
          eq = __ldg(words.probe[j] + i * words.probe_stride[j]) ==
               __ldg(words.build[j] + cur * words.build_stride[j]);
        }
        if (eq) m |= 1u << e;
      }
      e = next;
      cur = ahead;
    }
    mask[i] = static_cast<int32_t>(m);
  }
}

}  // namespace

// bids: cap int32 bucket ids (-1 = skip). table: width * nb int32, filled
// here. overflow: one int32, set here.
extern "C" int cylon_bucket_build(const void* bids, long long cap,
                                  long long nb, int width, void* table,
                                  void* overflow, void* stream) {
  if (cap < 0 || nb < 1 || width < 1 || width > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(table, 0xFF, 4ull * width * nb, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(overflow, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cap == 0) return 0;
  bucket_build_kernel<<<static_cast<unsigned>(grid_for(cap)),
                        kThreads, 0,
                        s>>>(static_cast<const int32_t*>(bids), cap, nb,
                             width, static_cast<uint32_t*>(table),
                             static_cast<int32_t*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

// pbids: pcap int32 bucket ids (-1 = no match). probe/build word streams:
// host arrays of nwords device pointers and element strides. table: the
// [width, nb] build table over bcap build rows. mask: pcap int32, set here.
// one_int64: the two words on each side are one int64 column's (lo, hi)
// halves (checked here), compared as one 8-byte key.
extern "C" int cylon_bucket_probe(const void* pbids, long long pcap,
                                  const void* const* pwords,
                                  const long long* pstrides,
                                  const void* const* bwords,
                                  const long long* bstrides, int nwords,
                                  int one_int64, const void* table,
                                  long long nb, int width, long long bcap,
                                  void* mask, void* stream) {
  if (pcap < 0 || nwords < 1 || nb < 1 || width < 1 || width > 30 ||
      bcap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (one_int64 &&
      (nwords != 2 ||
       !int64_halves(pwords[0], pwords[1], pstrides[0], pstrides[1]) ||
       !int64_halves(bwords[0], bwords[1], bstrides[0], bstrides[1]))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pcap == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(grid_for(pcap));
  for (int c = 0; c < nwords; c += kChunk) {
    WordPairs words;
    words.count = nwords - c < kChunk ? nwords - c : kChunk;
    for (int j = 0; j < kChunk; ++j) {
      const bool used = j < words.count;
      words.probe[j] = used ? static_cast<const uint32_t*>(pwords[c + j])
                            : nullptr;
      words.build[j] = used ? static_cast<const uint32_t*>(bwords[c + j])
                            : nullptr;
      words.probe_stride[j] = used ? pstrides[c + j] : 0;
      words.build_stride[j] = used ? bstrides[c + j] : 0;
    }
    const auto* ids = static_cast<const int32_t*>(pbids);
    const auto* tab = static_cast<const int32_t*>(table);
    auto* out = static_cast<int32_t*>(mask);
    if (one_int64) {
      bucket_probe_kernel<Int64Key><<<grid, kThreads, 0, s>>>(
          ids, pcap, tab, nb, width, bcap, words, 1, out);
    } else {
      bucket_probe_kernel<AnyWords><<<grid, kThreads, 0, s>>>(
          ids, pcap, tab, nb, width, bcap, words, c == 0, out);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
