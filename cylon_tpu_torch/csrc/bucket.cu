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
// vectorise data-dependent row work. Here bucket_probe takes one row a
// thread, and bucket_build partitions the rows first.
//
// bucket_build. Bound on an H100: 4 * cap bytes of ids read and the
// 4 * width * nb byte table written, at 3.35 TB/s. A scatter into the
// final layout cannot come near it: entries of one bucket lie 4 * nb
// bytes apart, the table is many times the 50 MB L2, and a random access
// moves at least 64 bytes. So rows reach the table through a radix
// partition, and every table byte is written once, from shared memory,
// in runs of 4 * T bytes. The partition costs 640 MB of traffic at 16M
// rows beside the table's 1 GiB; what limits it is L2 transactions, not
// bytes: one scatter into all nt tiles at once (per-row atomics, or
// per-block cursors whose 4M open runs overflow L2) writes 8 bytes a
// transaction. So the partition has two levels of at most kBins digits,
// and each block sorts a batch by digit in shared memory before it
// writes, so that a warp writes a run of neighbouring slots.
// Design: a tile is T consecutive buckets (T a power of two, T <= nb,
// T * width * 4 bytes within kTileBytes); nt = ceil(nb / T) tiles. A tile
// id's top bits are its coarse digit d, its low fine_shift bits its fine
// digit. The plan (T, the chunk of rows a count block takes, the chunk
// groups, which path runs) is kernels/bucket.py:build_plan; the launcher
// computes it again and refuses any other.
//   1. count: block j counts chunk j's rows a tile in shared memory, adds
//      them into a [group, tile] matrix (one atomic a tile, neighbouring
//      threads on neighbouring words) and writes its column of a
//      [d, chunk] matrix; ids >= nb count as overflow. A small kernel
//      transposes the first matrix to [tile, group].
//   2. offsets: scan.cu's three-pass inclusive add scan of both matrices,
//      in place (launched from here: not a scan32 launch of the wrapper).
//   3. coarse scatter: block j moves chunk j's rows as (row id, bucket id)
//      into staging a, each (d, j) run where the scan puts it.
//   4. fine scatter: block (d, g) moves digit d's rows of chunk group g
//      from staging a into staging b as (row id, b mod T), each (tile, g)
//      run where the scan puts it: tile t's segment of b is contiguous.
//      Staging a may lie in the table's own memory: the table is written
//      only after the last read of a.
//   5. tile build: one block a tile fills a [width, T] table in shared
//      memory with 0xFFFFFFFF, reads its segment with 16-byte loads and
//      carries each row into it (below), then writes it out as width
//      runs of T * 4 bytes with 16-byte stores.
// Passes 3 and 4 load their next batch while they write the current one.
// Where nt is too large for a shared histogram (nt > kHistTiles, as at
// nb >> cap), one pass counts into [nt] global counters with
// warp-aggregated atomics, the scan runs over those, and one scatter takes
// each row straight to staging b, one atomic a warp and tile.
// The carry: a first-free-slot insert would place rows in arrival order,
// which is not deterministic. Instead each slot is unsigned and starts at
// 0xFFFFFFFF (-1 as int32, and the unsigned maximum); a row carries its
// id v and walks e = 0..width-1 doing
//   old = atomicMin(&tile[e][b], v); v = max(old, v)
// until it carries 0xFFFFFFFF. Slot 0 ends as the smallest id of the
// bucket and passes every other id on, exactly once, so slot e ends as
// the (e+1)-th smallest, whatever the order rows arrive in (the scatters'
// order is not fixed). An id still carried past the last entry counts
// one overflow, so the count is sum over buckets of max(count - width, 0),
// again in any order. Slots only decrease, so a carried id larger than
// the bucket's last slot (once that slot is filled) can never be placed:
// it stops there and counts its overflow at once, which keeps a hot
// bucket from serialising width shared atomics a row.
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
constexpr unsigned kFull = 0xffffffffu;

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

// ------------------------------------------------------------ build

constexpr int kPartThreads = 1024;       // count blocks (and global path)
constexpr int kCoarseThreads = 1024;     // coarse scatter blocks
constexpr int kCoarseItems = 8;          // entries a thread a batch
constexpr int kFineThreads = 512;        // fine scatter blocks
constexpr int kFineItems = 8;
constexpr int kBins = 128;               // digits of one partition level
constexpr int kTileThreads = 256;        // tile build blocks
constexpr int kLoads = 4;                // rows a thread loads at once
constexpr int kTileBytes = 64 * 1024;    // shared table of one tile
constexpr int kHistTiles = 16 * 1024;    // shared counters of a chunk
constexpr long long kTargetChunks = 264; // two count blocks an SM
constexpr long long kMinChunk = 4096;
constexpr long long kChunkAlign = 1024;
constexpr long long kGroups = 16;        // chunk groups of the fine pass

// The build plan, as kernels/bucket.py:build_plan computes it.
struct BuildPlan {
  int shift;            // T = 1 << shift buckets a tile
  long long tiles;      // nt
  long long chunk;      // rows a count / coarse scatter block takes
  long long chunks;
  bool shared_hist;     // the two-level partition (else global counters)
  int fine_shift;       // F = 1 << fine_shift tiles a coarse digit
  long long coarse;     // P = ceil(nt / F) coarse digits
  long long group_chunks;
  long long groups;
  long long scan_len;   // the longest scan
  long long count_words;
  long long staging;    // (row, bucket) entries a staging buffer, even
};

BuildPlan plan_of(long long cap, long long nb, int width) {
  BuildPlan p;
  p.shift = 0;
  while ((2ll << p.shift) <= nb &&
         (2ll << p.shift) * width * 4 <= kTileBytes) {
    ++p.shift;
  }
  p.tiles = (nb + (1ll << p.shift) - 1) >> p.shift;
  long long chunk = (cap + kTargetChunks - 1) / kTargetChunks;
  chunk = chunk > kMinChunk ? chunk : kMinChunk;
  p.chunk = (chunk + kChunkAlign - 1) / kChunkAlign * kChunkAlign;
  p.chunks = cap > 0 ? (cap + p.chunk - 1) / p.chunk : 1;
  p.shared_hist = p.tiles <= kHistTiles;
  int tbits = 0;
  while ((1ll << tbits) < p.tiles) ++tbits;
  p.fine_shift = (tbits + 1) / 2;
  p.coarse = (p.tiles + (1ll << p.fine_shift) - 1) >> p.fine_shift;
  p.group_chunks = (p.chunks + kGroups - 1) / kGroups;
  p.groups = (p.chunks + p.group_chunks - 1) / p.group_chunks;
  const long long cmat = p.coarse * p.chunks;
  const long long fmat = p.tiles * p.groups;
  p.scan_len = p.shared_hist ? (cmat > fmat ? cmat : fmat) : p.tiles;
  p.count_words = p.shared_hist ? cmat + 2 * fmat : 2 * p.tiles;
  p.staging = cap + (cap & 1) > 2 ? cap + (cap & 1) : 2;
  return p;
}

// Adds each warp's count to a block total in shared memory; thread 0
// adds the total to *overflow after a later __syncthreads.
__device__ __forceinline__ void warp_overflow(int over, int* block_total) {
  over = __reduce_add_sync(kFull, over);
  if ((threadIdx.x & 31) == 0 && over) atomicAdd(block_total, over);
}

// Loads rows [lo, hi) kLoads at a time a thread, striped over the block
// (all lanes of a warp run the same iterations), and calls
// f(row, bucket id) for each, bucket id -1 past hi.
template <class F>
__device__ __forceinline__ void for_rows(const int32_t* __restrict__ bids,
                                         long long lo, long long hi, F f) {
  const long long step = static_cast<long long>(kLoads) * blockDim.x;
  for (long long base = lo; base < hi; base += step) {
    int32_t b[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const long long i = base + k * blockDim.x + threadIdx.x;
      b[k] = i < hi ? __ldg(bids + i) : -1;
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      f(base + k * blockDim.x + threadIdx.x, b[k]);
    }
  }
}

// Pass 1, two-level path: block j counts chunk j's rows a tile in shared
// memory, then adds its counts into by_group[g * tiles + t] (g = j's chunk
// group; neighbouring threads add to neighbouring words) and writes
// coarse[d * chunks + j], the rows of coarse digit d (tiles d * F ..
// d * F + F - 1).
__global__ void __launch_bounds__(kPartThreads)
count_tiles(const int32_t* __restrict__ bids, long long cap, long long nb,
            int shift, int tiles, int fine_shift, long long chunk,
            int group_chunks, uint32_t* coarse, uint32_t* by_group,
            int32_t* overflow) {
  extern __shared__ uint32_t hist[];
  __shared__ int over_total;
  if (threadIdx.x == 0) over_total = 0;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) hist[t] = 0;
  __syncthreads();
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < cap ? lo + chunk : cap;
  int over = 0;
  for_rows(bids, lo, hi, [&](long long, int32_t b) {
    if (b < 0) return;
    if (b >= nb) {
      ++over;
      return;
    }
    atomicAdd(hist + (b >> shift), 1u);
  });
  warp_overflow(over, &over_total);
  __syncthreads();
  uint32_t* row = by_group + blockIdx.x / group_chunks * tiles;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    if (hist[t]) atomicAdd(row + t, hist[t]);
  }
  const int lane = threadIdx.x & 31;
  const int fan = 1 << fine_shift;
  const int ncoarse = (tiles + fan - 1) >> fine_shift;
  for (int d = threadIdx.x >> 5; d < ncoarse; d += blockDim.x >> 5) {
    uint32_t sum = 0;
    for (int f = lane; f < fan; f += 32) {
      const int t = (d << fine_shift) + f;
      sum += t < tiles ? hist[t] : 0u;
    }
    sum = __reduce_add_sync(kFull, sum);
    if (lane == 0) coarse[static_cast<long long>(d) * gridDim.x + blockIdx.x] = sum;
  }
  if (threadIdx.x == 0 && over_total) atomicAdd(overflow, over_total);
}

// The start of run i of an inclusive scan: 0 for the first.
__device__ __forceinline__ uint32_t run_start(const uint32_t* incl,
                                              long long i) {
  return i == 0 ? 0u : incl[i - 1];
}

// fine[t * groups + g] = by_group[g * tiles + t]: the scan runs in
// (tile, group) order.
__global__ void transpose_counts(const uint32_t* __restrict__ by_group,
                                 int tiles, int groups,
                                 uint32_t* __restrict__ fine) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(tiles) * groups) return;
  const long long t = i / groups;
  fine[i] = by_group[(i - t * groups) * tiles + t];
}

template <int kBatch>
struct SortSmem {
  uint2 buf[kBatch];
  uint32_t count[kBins];
  uint32_t offset[kBins];   // exclusive, within the batch
  uint32_t cursor[kBins];   // where the block writes a digit's next entry
};

// Moves entries [lo, hi) of a source to out, each at the cursor of its
// digit, batch by batch: a batch is sorted by digit in shared memory
// (counting sort; the order inside a digit is free), then written in
// order, so neighbouring threads write neighbouring slots of a digit's
// run. The next batch's loads go out once this batch sits in shared
// memory, and fly while it is written. load(i) gives entry i, digit(e)
// its digit (< kBins, or -1 to drop it), emit(e) what is written.
// sm.cursor is set by the caller.
template <int kSortThreads, int kSortItems, class Load, class Digit,
          class Emit>
__device__ void sort_batches(SortSmem<kSortThreads * kSortItems>& sm,
                             long long lo, long long hi, Load load,
                             Digit digit, Emit emit, uint2* __restrict__ out) {
  constexpr int kBatch = kSortThreads * kSortItems;
  uint2 e[kSortItems];
  const auto fetch = [&](long long base) {
#pragma unroll
    for (int k = 0; k < kSortItems; ++k) {
      const long long i = base + k * kSortThreads + threadIdx.x;
      if (i < hi) e[k] = load(i);
    }
  };
  fetch(lo);
  for (long long base = lo; base < hi; base += kBatch) {
    int dr[kSortItems];  // digit << 16 | rank inside the digit; -1: none
#pragma unroll
    for (int k = 0; k < kSortItems; ++k) {
      const long long i = base + k * kSortThreads + threadIdx.x;
      dr[k] = i < hi ? digit(e[k]) : -1;
    }
    for (int b = threadIdx.x; b < kBins; b += kSortThreads) sm.count[b] = 0;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSortItems; ++k) {
      if (dr[k] >= 0) {
        dr[k] = dr[k] << 16 | static_cast<int>(atomicAdd(sm.count + dr[k], 1u));
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // exclusive scan of the kBins counts
      const int lane = threadIdx.x;
      uint32_t c[kBins / 32];
      uint32_t sum = 0;
#pragma unroll
      for (int k = 0; k < kBins / 32; ++k) {
        c[k] = sm.count[lane * (kBins / 32) + k];
        sum += c[k];
      }
      uint32_t inc = sum;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const uint32_t up = __shfl_up_sync(kFull, inc, s);
        if (lane >= s) inc += up;
      }
      uint32_t run = inc - sum;
#pragma unroll
      for (int k = 0; k < kBins / 32; ++k) {
        sm.offset[lane * (kBins / 32) + k] = run;
        run += c[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSortItems; ++k) {
      if (dr[k] >= 0) sm.buf[sm.offset[dr[k] >> 16] + (dr[k] & 0xffff)] = e[k];
    }
    const uint32_t n = sm.offset[kBins - 1] + sm.count[kBins - 1];
    fetch(base + kBatch);
    __syncthreads();
    for (uint32_t k = threadIdx.x; k < n; k += kSortThreads) {
      const uint2 v = sm.buf[k];
      const int b = digit(v);
      out[sm.cursor[b] + (k - sm.offset[b])] = emit(v);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < kBins; b += kSortThreads) {
      sm.cursor[b] += sm.count[b];
    }
  }
}

// Pass 3: block j moves chunk j's rows as (row id, bucket id) into
// staging a, by coarse digit b >> (shift + fine_shift); coarse holds the
// scanned [coarse digit, chunk] counts, so digit d of chunk j starts at
// run_start(coarse, d * chunks + j).
__global__ void __launch_bounds__(kCoarseThreads)
coarse_scatter(const int32_t* __restrict__ bids, long long cap, long long nb,
               int coarse_shift, int ncoarse, long long chunk,
               const uint32_t* __restrict__ coarse, uint2* __restrict__ a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sm = *reinterpret_cast<SortSmem<kCoarseThreads * kCoarseItems>*>(smem);
  for (int d = threadIdx.x; d < ncoarse; d += kCoarseThreads) {
    sm.cursor[d] = run_start(coarse, d * static_cast<long long>(gridDim.x) +
                                         blockIdx.x);
  }
  __syncthreads();
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < cap ? lo + chunk : cap;
  sort_batches<kCoarseThreads, kCoarseItems>(
      sm, lo, hi,
      [&](long long i) {
        return make_uint2(static_cast<uint32_t>(i),
                          static_cast<uint32_t>(__ldg(bids + i)));
      },
      [&](uint2 v) {
        const int32_t b = static_cast<int32_t>(v.y);
        return b < 0 || b >= nb ? -1 : b >> coarse_shift;
      },
      [](uint2 v) { return v; }, a);
}

// Pass 4: block (d, g) moves coarse digit d's rows of chunk group g from
// staging a into staging b as (row id, b mod T), by fine digit (the tile
// within d); fine holds the scanned [tile, group] counts, so tile t's run
// of group g starts at run_start(fine, t * groups + g).
__global__ void __launch_bounds__(kFineThreads)
fine_scatter(const uint2* __restrict__ a, const uint32_t* __restrict__ coarse,
             long long chunks, int group_chunks,
             const uint32_t* __restrict__ fine, int groups, int tiles,
             int shift, int fine_shift, uint2* __restrict__ b) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sm = *reinterpret_cast<SortSmem<kFineThreads * kFineItems>*>(smem);
  const int d = blockIdx.x / groups;
  const int g = blockIdx.x - d * groups;
  const int fan = 1 << fine_shift;
  for (int f = threadIdx.x; f < fan; f += kFineThreads) {
    const long long t = (static_cast<long long>(d) << fine_shift) + f;
    if (t < tiles) sm.cursor[f] = run_start(fine, t * groups + g);
  }
  __syncthreads();
  const long long j0 = static_cast<long long>(g) * group_chunks;
  const long long j1 = j0 + group_chunks < chunks ? j0 + group_chunks
                                                  : chunks;
  const long long lo = run_start(coarse, d * chunks + j0);
  const long long hi = coarse[d * chunks + j1 - 1];
  const uint32_t mask = (1u << shift) - 1u;
  sort_batches<kFineThreads, kFineItems>(
      sm, lo, hi, [&](long long i) { return a[i]; },
      [&](uint2 v) { return static_cast<int>(v.y >> shift) & (fan - 1); },
      [&](uint2 v) { return make_uint2(v.x, v.y & mask); }, b);
}

// Pass 1, global path: counts[t] += rows of tile t, one atomic for the
// lanes of a warp that share a tile.
__global__ void __launch_bounds__(kPartThreads)
count_tiles_global(const int32_t* __restrict__ bids, long long cap,
                   long long nb, int shift, long long chunk,
                   uint32_t* counts, int32_t* overflow) {
  __shared__ int over_total;
  if (threadIdx.x == 0) over_total = 0;
  __syncthreads();
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < cap ? lo + chunk : cap;
  const int lane = threadIdx.x & 31;
  int over = 0;
  for_rows(bids, lo, hi, [&](long long, int32_t b) {
    over += b >= nb;
    const long long t = b >= 0 && b < nb ? b >> shift : -1;
    const unsigned peers = __match_any_sync(kFull, t);
    if (t >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(counts + t, static_cast<uint32_t>(__popc(peers)));
    }
  });
  warp_overflow(over, &over_total);
  __syncthreads();
  if (threadIdx.x == 0 && over_total) atomicAdd(overflow, over_total);
}

// Pass 3, global path: ends = the inclusive scan of the counts; a group
// of lanes takes its slots below ends[t] with one atomicSub on counts[t].
__global__ void __launch_bounds__(kPartThreads)
scatter_rows_global(const int32_t* __restrict__ bids, long long cap,
                    long long nb, int shift, long long chunk,
                    uint32_t* counts, const uint32_t* __restrict__ ends,
                    uint2* __restrict__ staging) {
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < cap ? lo + chunk : cap;
  const int lane = threadIdx.x & 31;
  const uint32_t mask = (1u << shift) - 1u;
  for_rows(bids, lo, hi, [&](long long i, int32_t b) {
    const long long t = b >= 0 && b < nb ? b >> shift : -1;
    const unsigned peers = __match_any_sync(kFull, t);
    const int leader = __ffs(peers) - 1;
    uint32_t left = 0;
    if (t >= 0 && lane == leader) {
      left = atomicSub(counts + t, static_cast<uint32_t>(__popc(peers)));
    }
    left = __shfl_sync(kFull, left, leader);
    if (t < 0) return;
    const uint32_t rank = __popc(peers & ((1u << lane) - 1u));
    staging[ends[t] - left + rank] = make_uint2(
        static_cast<uint32_t>(i), static_cast<uint32_t>(b) & mask);
  });
}

// Carries row id v into local bucket lb of a [width, T] shared tile;
// returns 1 if it (or an id it displaced) is left unplaced.
__device__ __forceinline__ int carry(uint32_t* tile, int shift, int width,
                                     uint32_t v, uint32_t lb) {
  const volatile uint32_t* last = tile + ((width - 1) << shift) + lb;
  uint32_t* slot = tile + lb;
  for (int e = 0; e < width; ++e, slot += 1 << shift) {
    if (v > *last) return 1;  // the bucket is full of smaller ids
    const uint32_t old = atomicMin(slot, v);
    v = old > v ? old : v;
    if (v == kEmpty) return 0;
  }
  return 1;
}

// Pass 4: block t builds buckets [t * T, t * T + T) from its staging
// segment [ends[t * stride - 1], ends[t * stride + stride - 1]) (0 for the
// first start) and writes them out whole.
__global__ void __launch_bounds__(kTileThreads)
build_tiles(const uint2* __restrict__ staging,
            const uint32_t* __restrict__ ends, long long stride,
            long long nb, int shift, int width, uint32_t* __restrict__ table,
            int32_t* overflow) {
  extern __shared__ __align__(16) uint32_t tile[];
  __shared__ int over_total;
  const int T = 1 << shift;
  const long long t = blockIdx.x;
  const long long b0 = t << shift;
  const int len = nb - b0 < T ? static_cast<int>(nb - b0) : T;
  const int words = width << shift;
  if (threadIdx.x == 0) over_total = 0;
  if (words % 4 == 0) {
    const uint4 empty = make_uint4(kEmpty, kEmpty, kEmpty, kEmpty);
    for (int i = threadIdx.x; i < words / 4; i += blockDim.x) {
      reinterpret_cast<uint4*>(tile)[i] = empty;
    }
  } else {
    for (int i = threadIdx.x; i < words; i += blockDim.x) tile[i] = kEmpty;
  }
  const long long lo = t == 0 ? 0 : ends[t * stride - 1];
  const long long hi = ends[t * stride + stride - 1];
  __syncthreads();
  // pairs of entries from an even index: 16-byte aligned loads (staging
  // holds an even count, so the pair past an odd end stays inside it)
  int over = 0;
  constexpr int kPairs = 2;
  const long long step = 2ll * kPairs * kTileThreads;
  for (long long base = (lo & ~1ll) + 2 * threadIdx.x; base < hi;
       base += step) {
    uint4 two[kPairs];
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const long long i = base + 2ll * k * kTileThreads;
      if (i < hi) {
        two[k] = __ldg(reinterpret_cast<const uint4*>(staging + i));
      }
    }
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const long long i = base + 2ll * k * kTileThreads;
      if (i >= hi) break;
      if (i >= lo) over += carry(tile, shift, width, two[k].x, two[k].y);
      if (i + 1 < hi) over += carry(tile, shift, width, two[k].z, two[k].w);
    }
  }
  warp_overflow(over, &over_total);
  __syncthreads();
  uint32_t* out = table + b0;
  if (len == T && T % 4 == 0 && nb % 4 == 0 &&
      reinterpret_cast<uintptr_t>(table) % 16 == 0) {
    for (int i = threadIdx.x; i < words / 4; i += blockDim.x) {
      const int e = (4 * i) >> shift;
      const int c = (4 * i) & (T - 1);
      *reinterpret_cast<uint4*>(out + e * nb + c) =
          reinterpret_cast<const uint4*>(tile)[i];
    }
  } else {
    for (int i = threadIdx.x; i < width * len; i += blockDim.x) {
      const int e = i / len;
      const int c = i - e * len;
      out[e * nb + c] = tile[(e << shift) + c];
    }
  }
  if (threadIdx.x == 0 && over_total) atomicAdd(overflow, over_total);
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

// The scan of pass 2: scan.cu's inclusive add scan, launched on the same
// stream (it does not count as a scan32 launch of the wrapper).
extern "C" int cylon_scan_tile();
extern "C" int cylon_scan32(const void* x, void* y, long long n, int kind,
                            int dtype, void* scratch, void* stream);

// bids: cap int32 bucket ids (-1 = skip). tile, chunk, shared_hist: the
// plan of kernels/bucket.py:build_plan, checked against plan_of. counts:
// count_words uint32 of scratch; scan_scratch: scan_words int32 for the
// scans (8 bytes a scan tile); staging_a / staging_b: a_entries /
// b_entries (row, bucket) pairs, 16-byte aligned (a is used by the
// two-level path only, and may be the table's own memory: the table is
// written after the last read of a). table: width * nb int32, written
// here whole. overflow: one int32, set here.
extern "C" int cylon_bucket_build(const void* bids, long long cap,
                                  long long nb, int width, long long tile,
                                  long long chunk, int shared_hist,
                                  void* counts, long long count_words,
                                  void* scan_scratch, long long scan_words,
                                  void* staging_a, long long a_entries,
                                  void* staging_b, long long b_entries,
                                  void* table, void* overflow, void* stream) {
  if (cap < 0 || cap > 0x7fffffffll || nb < 1 || width < 1 || width > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BuildPlan p = plan_of(cap, nb, width);
  const long long scan_tiles =
      (p.scan_len + cylon_scan_tile() - 1) / cylon_scan_tile();
  const auto aligned = [](const void* x) {
    return reinterpret_cast<uintptr_t>(x) % 16 == 0;
  };
  if (tile != (1ll << p.shift) || chunk != p.chunk ||
      (shared_hist != 0) != p.shared_hist || count_words < p.count_words ||
      scan_words < 2 * scan_tiles || b_entries < p.staging ||
      !aligned(staging_b) ||
      (p.shared_hist &&
       (a_entries < p.staging || !aligned(staging_a) || p.coarse > kBins ||
        (1ll << p.fine_shift) > kBins)) ||
      p.tiles * p.groups > 0x7fffffffll || p.chunks > 0x7fffffffll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ids = static_cast<const int32_t*>(bids);
  auto* cnt = static_cast<uint32_t*>(counts);
  auto* stage = static_cast<uint2*>(staging_b);
  auto* ovf = static_cast<int32_t*>(overflow);
  const auto chunks = static_cast<unsigned>(p.chunks);
  const int tiles = static_cast<int>(p.tiles);
  cudaError_t err = cudaMemsetAsync(overflow, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint32_t* ends;
  long long stride;
  if (p.shared_hist) {
    // counts[0, P * chunks): coarse; then [tiles * groups) fine; then
    // the same counts group-major
    uint32_t* coarse = cnt;
    uint32_t* fine = cnt + p.coarse * p.chunks;
    const long long nfine = p.tiles * p.groups;
    uint32_t* by_group = fine + nfine;
    const size_t hist = 4 * static_cast<size_t>(tiles);
    err = cudaMemsetAsync(by_group, 0, 4 * static_cast<size_t>(nfine), s);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(count_tiles,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(hist));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    count_tiles<<<chunks, kPartThreads, hist, s>>>(
        ids, cap, nb, p.shift, tiles, p.fine_shift, p.chunk,
        static_cast<int>(p.group_chunks), coarse, by_group, ovf);
    transpose_counts<<<static_cast<unsigned>((nfine + 255) / 256), 256, 0,
                       s>>>(by_group, tiles, static_cast<int>(p.groups),
                            fine);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    int e = cylon_scan32(coarse, coarse, p.coarse * p.chunks, 0, 1,
                         scan_scratch, stream);
    if (e) return e;
    e = cylon_scan32(fine, fine, nfine, 0, 1, scan_scratch, stream);
    if (e) return e;
    auto* a = static_cast<uint2*>(staging_a);
    constexpr int kCoarseBytes =
        sizeof(SortSmem<kCoarseThreads * kCoarseItems>);
    constexpr int kFineBytes = sizeof(SortSmem<kFineThreads * kFineItems>);
    err = cudaFuncSetAttribute(coarse_scatter,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kCoarseBytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(fine_scatter,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kFineBytes);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    coarse_scatter<<<chunks, kCoarseThreads, kCoarseBytes, s>>>(
        ids, cap, nb, p.shift + p.fine_shift, static_cast<int>(p.coarse),
        p.chunk, coarse, a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    fine_scatter<<<static_cast<unsigned>(p.coarse * p.groups), kFineThreads,
                   kFineBytes, s>>>(a, coarse, p.chunks,
                           static_cast<int>(p.group_chunks), fine,
                           static_cast<int>(p.groups), tiles, p.shift,
                           p.fine_shift, stage);
    ends = fine;
    stride = p.groups;
  } else {
    // counts[0, nt): the counters; counts[nt, 2 nt): their inclusive scan
    uint32_t* inc = cnt + p.tiles;
    err = cudaMemsetAsync(cnt, 0, 4 * static_cast<size_t>(p.tiles), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    count_tiles_global<<<chunks, kPartThreads, 0, s>>>(ids, cap, nb, p.shift,
                                                       p.chunk, cnt, ovf);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    int e = cylon_scan32(cnt, inc, p.tiles, 0, 1, scan_scratch, stream);
    if (e) return e;
    scatter_rows_global<<<chunks, kPartThreads, 0, s>>>(
        ids, cap, nb, p.shift, p.chunk, cnt, inc, stage);
    ends = inc;
    stride = 1;
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const size_t tile_bytes = 4 * static_cast<size_t>(width) << p.shift;
  err = cudaFuncSetAttribute(build_tiles,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(tile_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  build_tiles<<<static_cast<unsigned>(p.tiles), kTileThreads, tile_bytes,
                s>>>(stage, ends, stride, nb, p.shift, width,
                     static_cast<uint32_t*>(table), ovf);
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
