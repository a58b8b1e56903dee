// Inclusive 1-D scans: scan32 (add or max over int32, uint32, float32) and
// pair_max_scan (running lexicographic max over (hi, lo) u32 pairs).
//
// Replaces two Pallas kernels in cylon_tpu/ops/pallas_kernels.py:
//   scan32         -- _scan_kernel and _scan32_impl
//   pair_max_scan  -- _pair_max_kernel and _pair_max_impl
//
// Bound on an H100 (3.35 TB/s): bytes moved. A scan must read its input
// once and write its output once: 8 bytes per element for scan32, 16 for a
// pair. It does one operation per element, nothing next to the memory.
//
// scan32: simple and right, three passes over tiles of 256 threads x 8
// elements (2048 per tile):
//   1. tile_reduce: each block reduces its tile to one total;
//   2. carry_scan: one block scans the tile totals, in place, into
//      exclusive carries;
//   3. tile_scan: each block scans its tile -- a sequential scan of each
//      thread's 8 contiguous elements, __shfl_up_sync warp scans of the
//      thread totals, a shared-memory pass over the warp totals -- and
//      puts its carry in front.
// Traffic is 2 reads and 1 write of the input size, against the bound's
// 1 and 1. A single-pass decoupled look-back scan moves 1 and 1, but on an
// H100 it lost to this design at 4M and 2M elements: the input of such a
// scan sits in L2, so the second read is cheap, while a tile's wait for
// its predecessors' prefixes cost more (PERF.md).
// Tiles go through shared memory so that global loads and stores stay
// coalesced while each thread owns 8 CONTIGUOUS elements. Every combine
// keeps operand order (earlier elements on the left), so the float max,
// which is not commutative in the sign of zero or the payload of NaN,
// gives exactly the sequential result.
//
// int32 add wraps modulo 2^32 (it is done in uint32_t: signed overflow is
// undefined in C++). float32 max propagates NaN, as jnp.maximum does;
// fmaxf would drop it.
//
// A pair is packed into one unsigned 64-bit value, hi in the top half, so
// the unsigned max is the lexicographic max; the identity is 0, so
// positions before any nonzero pair read (0, 0). pair_max_scan takes these
// three passes up to kPairSplit pairs and a kernel of its own above
// (below, where its design is set out).

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kSmem = kTile + kTile / 32;  // one pad slot per 32: no bank conflicts
constexpr int kCarryThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct AddU32 {
  using T = uint32_t;
  __device__ static T id() { return 0u; }
  __device__ static T op(T a, T b) { return a + b; }
};

struct AddF32 {
  using T = float;
  __device__ static T id() { return 0.0f; }
  __device__ static T op(T a, T b) { return a + b; }
};

struct MaxI32 {
  using T = int32_t;
  __device__ static T id() { return INT_MIN; }
  __device__ static T op(T a, T b) { return b >= a ? b : a; }
};

struct MaxU32 {
  using T = uint32_t;
  __device__ static T id() { return 0u; }
  __device__ static T op(T a, T b) { return b >= a ? b : a; }
};

// a is the earlier operand: the first NaN wins, and of equal values the
// later one (torch.cummax's rule, which decides the sign of a zero).
struct MaxF32 {
  using T = float;
  __device__ static T id() { return -INFINITY; }
  __device__ static T op(T a, T b) {
    if (a != a) return a;
    if (b != b) return b;
    return b >= a ? b : a;
  }
};

struct MaxU64 {
  using T = unsigned long long;
  __device__ static T id() { return 0ull; }
  __device__ static T op(T a, T b) { return b >= a ? b : a; }
};

template <class Op>
struct FlatIO {
  using T = typename Op::T;
  const T* in;
  T* out;
  __device__ T load(long long i) const { return in[i]; }
  __device__ void store(long long i, T v) const { out[i] = v; }
};

struct PairIO {
  using T = unsigned long long;
  const uint32_t* hi;
  const uint32_t* lo;
  uint32_t* out_hi;
  uint32_t* out_lo;
  __device__ T load(long long i) const {
    return (static_cast<T>(hi[i]) << 32) | lo[i];
  }
  __device__ void store(long long i, T v) const {
    out_hi[i] = static_cast<uint32_t>(v >> 32);
    out_lo[i] = static_cast<uint32_t>(v);
  }
};

__device__ __forceinline__ int pad(int j) { return j + (j >> 5); }

// Striped coalesced loads into shared memory, then each thread takes its
// kItems contiguous elements. Past n the identity fills in.
template <class Op, class IO>
__device__ void load_tile(const IO& io, long long base, long long n,
                          typename Op::T* smem,
                          typename Op::T (&v)[kItems]) {
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + threadIdx.x;
    const long long i = base + j;
    smem[pad(j)] = i < n ? io.load(i) : Op::id();
  }
  __syncthreads();
  for (int k = 0; k < kItems; ++k) v[k] = smem[pad(threadIdx.x * kItems + k)];
  __syncthreads();
}

template <class Op, class IO>
__device__ void store_tile(const IO& io, long long base, long long n,
                           typename Op::T* smem,
                           const typename Op::T (&v)[kItems]) {
  for (int k = 0; k < kItems; ++k) smem[pad(threadIdx.x * kItems + k)] = v[k];
  __syncthreads();
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + threadIdx.x;
    const long long i = base + j;
    if (i < n) io.store(i, smem[pad(j)]);
  }
}

template <class Op>
__device__ __forceinline__ typename Op::T warp_inclusive(typename Op::T v,
                                                         int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const typename Op::T up = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = Op::op(up, v);
  }
  return v;
}

// Exclusive scan of one value per thread across the block, in thread
// order; `total` receives the block's combined value. wbuf holds 33 slots.
template <class Op>
__device__ typename Op::T block_exclusive(typename Op::T v,
                                          typename Op::T* wbuf,
                                          typename Op::T& total) {
  using T = typename Op::T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const T inc = warp_inclusive<Op>(v, lane);
  T ex = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) ex = Op::id();
  if (lane == 31) wbuf[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const T w = lane < nwarps ? wbuf[lane] : Op::id();
    const T winc = warp_inclusive<Op>(w, lane);
    T wex = __shfl_up_sync(kFull, winc, 1);
    if (lane == 0) wex = Op::id();
    __syncwarp();
    if (lane < nwarps) wbuf[lane] = wex;
    if (lane == 31) wbuf[32] = winc;
  }
  __syncthreads();
  const T out = warp == 0 ? ex : Op::op(wbuf[warp], ex);
  total = wbuf[32];
  __syncthreads();
  return out;
}

template <class Op, class IO>
__global__ void __launch_bounds__(kThreads)
tile_reduce(IO io, long long n, typename Op::T* totals) {
  using T = typename Op::T;
  __shared__ T smem[kSmem];
  __shared__ T wbuf[33];
  T v[kItems];
  load_tile<Op>(io, static_cast<long long>(blockIdx.x) * kTile, n, smem, v);
  T acc = v[0];
  for (int k = 1; k < kItems; ++k) acc = Op::op(acc, v[k]);
  T total;
  block_exclusive<Op>(acc, wbuf, total);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// One block: tile totals -> exclusive carries, in place.
template <class Op>
__global__ void __launch_bounds__(kCarryThreads)
carry_scan(typename Op::T* totals, long long ntiles) {
  using T = typename Op::T;
  __shared__ T wbuf[33];
  T running = Op::id();
  for (long long start = 0; start < ntiles; start += kCarryThreads) {
    const long long i = start + threadIdx.x;
    const T v = i < ntiles ? totals[i] : Op::id();
    T chunk;
    const T ex = block_exclusive<Op>(v, wbuf, chunk);
    if (i < ntiles) totals[i] = start == 0 ? ex : Op::op(running, ex);
    running = start == 0 ? chunk : Op::op(running, chunk);
  }
}

template <class Op, class IO>
__global__ void __launch_bounds__(kThreads)
tile_scan(IO io, long long n, const typename Op::T* carries) {
  using T = typename Op::T;
  __shared__ T smem[kSmem];
  __shared__ T wbuf[33];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  T v[kItems];
  load_tile<Op>(io, base, n, smem, v);
  for (int k = 1; k < kItems; ++k) v[k] = Op::op(v[k - 1], v[k]);
  T total;
  const T ex = block_exclusive<Op>(v[kItems - 1], wbuf, total);
  const bool first_thread = threadIdx.x == 0;
  const bool has_carry = carries != nullptr && blockIdx.x > 0;
  if (has_carry || !first_thread) {
    T prefix = ex;
    if (has_carry) {
      prefix = first_thread ? carries[blockIdx.x]
                            : Op::op(carries[blockIdx.x], ex);
    }
    for (int k = 0; k < kItems; ++k) v[k] = Op::op(prefix, v[k]);
  }
  store_tile<Op>(io, base, n, smem, v);
}

template <class Op, class IO>
int run_scan(const IO& io, long long n, void* scratch, void* stream) {
  using T = typename Op::T;
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ntiles = (n + kTile - 1) / kTile;
  T* carries = nullptr;
  if (ntiles > 1) {
    carries = static_cast<T*>(scratch);
    tile_reduce<Op, IO><<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
        io, n, carries);
    carry_scan<Op><<<1, kCarryThreads, 0, s>>>(carries, ntiles);
  }
  tile_scan<Op, IO><<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
      io, n, carries);
  return static_cast<int>(cudaGetLastError());
}

template <class Op>
int run_flat(const void* x, void* y, long long n, void* scratch,
             void* stream) {
  FlatIO<Op> io{static_cast<const typename Op::T*>(x),
                static_cast<typename Op::T*>(y)};
  return run_scan<Op>(io, n, scratch, stream);
}

// ------------------------------------------------------- pair_max_scan
// The scan of (hi, lo) u32 pairs, the u64 cummax of (hi << 32) | lo with
// identity 0. It moves 16 bytes a pair at the bound. Up to kPairSplit
// pairs (3M: the input and output, 48 MB, fit in the 50 MB L2) it takes
// the three passes above, whose second read then hits L2. Above, where
// that read comes from HBM, it takes one pass with a decoupled look-back
// (Merrill and Garland, 2016), one launch, no carry kernel. Raced on
// H100s (PERF.md), the look-back beat the three passes at 4M and 32M
// pairs on every machine, but at 1M and 3M only on some: its waits
// between SMs cost more on some machines than on others, and the three
// passes' time did not move.
//
// A block takes its tile from an atomic counter, so every lower tile
// belongs to a block that is already running; it publishes its tile's
// max, and warp 0 looks back over 32 predecessors at a time, folding
// their values down to the nearest inclusive prefix, then publishes its
// own. A tile's state is a u64 value and a u32 flag: the value is stored
// first, then the flag with release semantics, and a reader loads the
// flag with acquire semantics before the value, so no status is ever
// seen without its value. One value slot serves both the tile's max and
// its inclusive prefix: a reader that finds either folds in a max over
// tiles before its own, which for an idempotent max is the same. The
// flag carries the call's epoch (flag = epoch << 2 | status), so the
// state needs no memset: the wrapper keeps it zeroed once, and a flag of
// an earlier call reads as not yet published. The block that draws the
// last tile resets the counter. A CUDA graph replays the epoch it was
// captured with, so a call captured into one takes a scratch of its own
// with epoch 1, zeroed by a fill captured before it (kernels/scan.py).
//
// Tiles are large (16384 pairs, one 1024-thread block an SM), which
// keeps the chains of look-backs short.
//
// A block holds its tile in registers, 16 pairs a thread: warp w scans
// the contiguous span base + w * kPairWarpSpan in chunks of 128 pairs,
// lane l holding pairs 4l .. 4l + 3 of each chunk, loaded with one
// 16-byte load of hi and one of lo (4-byte loads where a pointer is not
// 16-byte aligned). A chunk scans in each lane, then across the warp by
// __shfl_up_sync, carrying the chunk's max to the next; the warps' maxima
// meet in shared memory, and the tile's prefix goes in front as it is
// stored. No shared-memory transpose. Loads and stores carry no cache
// hint: marked evict-first, the scan's own lines were the first to leave
// an L2 that also held other data, and an input and output that fit in L2
// then came from HBM on the next call (PERF.md).
constexpr int kPairChunks = 4;
constexpr int kPairItems = 4 * kPairChunks;       // pairs a thread
constexpr int kPairWarpSpan = 128 * kPairChunks;  // pairs a warp
constexpr int kLookBackWarps = 32;
constexpr int kLookBackThreads = 32 * kLookBackWarps;
constexpr int kLookBackTile = kLookBackWarps * kPairWarpSpan;  // 16384
// The largest n that takes the three passes.
constexpr long long kPairSplit = 3LL << 20;
constexpr unsigned kPairAggregate = 1u;
constexpr unsigned kPairPrefix = 2u;
constexpr unsigned kPairEpochs = 1u << 30;

using u64 = unsigned long long;

__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }

__device__ __forceinline__ u64 warp_max(u64 v) {
  for (int d = 16; d > 0; d >>= 1) v = umax(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// The first pair of this thread's 4 in chunk c of the tile at `base`.
__device__ __forceinline__ long long pair_index(long long base, int c) {
  return base + (threadIdx.x >> 5) * kPairWarpSpan + c * 128 +
         4 * (threadIdx.x & 31);
}

// Past n the identity 0 fills in.
template <bool kVec>
__device__ __forceinline__ void pair_load(const uint32_t* __restrict__ hi,
                                          const uint32_t* __restrict__ lo,
                                          long long base, long long n,
                                          u64 (&v)[kPairItems]) {
#pragma unroll
  for (int c = 0; c < kPairChunks; ++c) {
    const long long i = pair_index(base, c);
    uint32_t h[4], l[4];
    if (kVec && i + 3 < n) {
      const uint4 qh = *reinterpret_cast<const uint4*>(hi + i);
      const uint4 ql = *reinterpret_cast<const uint4*>(lo + i);
      h[0] = qh.x; h[1] = qh.y; h[2] = qh.z; h[3] = qh.w;
      l[0] = ql.x; l[1] = ql.y; l[2] = ql.z; l[3] = ql.w;
    } else {
      for (int k = 0; k < 4; ++k) {
        h[k] = i + k < n ? hi[i + k] : 0u;
        l[k] = i + k < n ? lo[i + k] : 0u;
      }
    }
    for (int k = 0; k < 4; ++k) {
      v[4 * c + k] = (static_cast<u64>(h[k]) << 32) | l[k];
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void pair_store(uint32_t* __restrict__ out_hi,
                                           uint32_t* __restrict__ out_lo,
                                           long long base, long long n,
                                           const u64 (&v)[kPairItems]) {
#pragma unroll
  for (int c = 0; c < kPairChunks; ++c) {
    const long long i = pair_index(base, c);
    const u64* x = v + 4 * c;
    if (kVec && i + 3 < n) {
      *reinterpret_cast<uint4*>(out_hi + i) =
          make_uint4(static_cast<uint32_t>(x[0] >> 32),
                     static_cast<uint32_t>(x[1] >> 32),
                     static_cast<uint32_t>(x[2] >> 32),
                     static_cast<uint32_t>(x[3] >> 32));
      *reinterpret_cast<uint4*>(out_lo + i) =
          make_uint4(static_cast<uint32_t>(x[0]), static_cast<uint32_t>(x[1]),
                     static_cast<uint32_t>(x[2]), static_cast<uint32_t>(x[3]));
    } else {
      for (int k = 0; k < 4; ++k) {
        if (i + k < n) {
          out_hi[i + k] = static_cast<uint32_t>(x[k] >> 32);
          out_lo[i + k] = static_cast<uint32_t>(x[k]);
        }
      }
    }
  }
}

__device__ __forceinline__ u64 thread_max(const u64 (&v)[kPairItems]) {
  u64 m = v[0];
  for (int k = 1; k < kPairItems; ++k) m = umax(m, v[k]);
  return m;
}

// The running max over this warp's span, in place, chunk by chunk; the
// tile's earlier warps and tiles are not in it yet.
__device__ __forceinline__ void pair_warp_scan(u64 (&v)[kPairItems]) {
  const int lane = threadIdx.x & 31;
  u64 run = 0;
#pragma unroll
  for (int c = 0; c < kPairChunks; ++c) {
    u64* x = v + 4 * c;
    x[1] = umax(x[0], x[1]);
    x[2] = umax(x[1], x[2]);
    x[3] = umax(x[2], x[3]);
    u64 inc = x[3];
    for (int d = 1; d < 32; d <<= 1) {
      const u64 up = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc = umax(up, inc);
    }
    u64 ex = __shfl_up_sync(kFull, inc, 1);
    if (lane == 0) ex = 0;
    const u64 pre = umax(run, ex);
    for (int k = 0; k < 4; ++k) x[k] = umax(pre, x[k]);
    run = umax(run, __shfl_sync(kFull, inc, 31));
  }
}

// The max of the warps before this one, from the warps' maxima.
__device__ __forceinline__ u64 earlier_warps(const u64* wmax) {
  u64 m = 0;
  for (int w = 0; w < (static_cast<int>(threadIdx.x) >> 5); ++w) {
    m = umax(m, wmax[w]);
  }
  return m;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 load_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void publish(u64* values, unsigned* flags,
                                        unsigned tile, u64 v, unsigned epoch,
                                        unsigned status) {
  store_relaxed(values + tile, v);
  store_release(flags + tile, (epoch << 2) | status);
}

// Warp 0: the max of the tiles before `tile` (> 0). Waits until each of
// the 32 predecessors in the window has published in this call, folds the
// values down to the nearest inclusive prefix, and steps 32 tiles back
// while there is none. Tile 0 always publishes a prefix.
__device__ u64 pair_look_back(const u64* values, const unsigned* flags,
                              unsigned tile, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  u64 acc = 0;
  for (long long end = static_cast<long long>(tile) - 1;; end -= 32) {
    const long long idx = end - lane;
    unsigned status;
    do {
      status = kPairPrefix;
      if (idx >= 0) {
        const unsigned f = load_acquire(flags + idx);
        status = (f >> 2) == epoch ? (f & 3u) : 0u;
      }
    } while (!__all_sync(kFull, status != 0));
    const u64 val = idx >= 0 ? load_relaxed(values + idx) : 0;
    const unsigned prefixes = __ballot_sync(kFull, status == kPairPrefix);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    acc = umax(acc, warp_max(lane <= stop ? val : 0));
    if (prefixes) return acc;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kLookBackThreads)
pair_lookback_scan(const uint32_t* __restrict__ hi,
                   const uint32_t* __restrict__ lo,
                   uint32_t* __restrict__ out_hi,
                   uint32_t* __restrict__ out_lo, long long n,
                   unsigned* counter, unsigned* flags, u64* values,
                   unsigned epoch) {
  __shared__ unsigned tile_s;
  __shared__ u64 wmax[kLookBackWarps];
  __shared__ u64 prefix_s;
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(counter, 1u);
    if (t == gridDim.x - 1) *counter = 0u;  // every block has drawn
    tile_s = t;
  }
  __syncthreads();
  const unsigned tile = tile_s;
  const long long base = static_cast<long long>(tile) * kLookBackTile;
  u64 v[kPairItems];
  pair_load<kVec>(hi, lo, base, n, v);
  const u64 m = warp_max(thread_max(v));
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    u64 total = 0;
    for (int w = 0; w < kLookBackWarps; ++w) total = umax(total, wmax[w]);
    if (tile == 0) {
      if (threadIdx.x == 0) {
        publish(values, flags, tile, total, epoch, kPairPrefix);
        prefix_s = 0;
      }
    } else {
      if (threadIdx.x == 0) {
        publish(values, flags, tile, total, epoch, kPairAggregate);
      }
      const u64 p = pair_look_back(values, flags, tile, epoch);
      if (threadIdx.x == 0) {
        publish(values, flags, tile, umax(p, total), epoch, kPairPrefix);
        prefix_s = p;
      }
    }
  }
  pair_warp_scan(v);
  const u64 wpre = earlier_warps(wmax);
  __syncthreads();
  const u64 pre = umax(prefix_s, wpre);
  for (int k = 0; k < kPairItems; ++k) v[k] = umax(pre, v[k]);
  pair_store<kVec>(out_hi, out_lo, base, n, v);
}

long long pair_tile(long long n) {
  return n <= kPairSplit ? kTile : kLookBackTile;
}

long long pair_tiles(long long n) {
  return (n + pair_tile(n) - 1) / pair_tile(n);
}

// Scratch: the tile counter (8 bytes), then a u32 flag a tile, then a
// u64 value a tile, both regions sized from the scratch's own capacity
// (an even number of tiles), never from n. A flag slot is therefore only
// ever written with flags, by any call on that scratch, so a stale word
// is a flag of an earlier epoch and never a value. The three passes keep
// their carries in the values.
long long pair_scratch(long long n) {
  const long long t = pair_tiles(n);
  return 8 + 12 * (t + (t & 1));
}

long long pair_capacity(long long scratch_bytes) {
  return scratch_bytes < 8 ? 0 : ((scratch_bytes - 8) / 12) & ~1LL;
}

template <bool kVec>
int run_look_back(const uint32_t* hi, const uint32_t* lo, uint32_t* out_hi,
                  uint32_t* out_lo, long long n, unsigned* counter,
                  unsigned* flags, u64* values, unsigned epoch,
                  cudaStream_t s) {
  pair_lookback_scan<kVec><<<static_cast<unsigned>(pair_tiles(n)),
                             kLookBackThreads, 0, s>>>(
      hi, lo, out_hi, out_lo, n, counter, flags, values, epoch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Elements per tile: the wrapper sizes the scratch as 8 bytes per tile.
extern "C" int cylon_scan_tile() { return kTile; }

// kind: 0 add, 1 max. dtype: 0 int32, 1 uint32, 2 float32.
extern "C" int cylon_scan32(const void* x, void* y, long long n, int kind,
                            int dtype, void* scratch, void* stream) {
  if (kind == 0 && (dtype == 0 || dtype == 1)) {
    return run_flat<AddU32>(x, y, n, scratch, stream);
  }
  if (kind == 0 && dtype == 2) return run_flat<AddF32>(x, y, n, scratch, stream);
  if (kind == 1 && dtype == 0) return run_flat<MaxI32>(x, y, n, scratch, stream);
  if (kind == 1 && dtype == 1) return run_flat<MaxU32>(x, y, n, scratch, stream);
  if (kind == 1 && dtype == 2) return run_flat<MaxF32>(x, y, n, scratch, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The pairs a tile holds at n, the largest n that takes the three passes,
// and the scratch bytes for n pairs.
extern "C" long long cylon_pair_scan_tile(long long n) { return pair_tile(n); }
extern "C" long long cylon_pair_scan_split() { return kPairSplit; }
extern "C" long long cylon_pair_scan_scratch(long long n) {
  return pair_scratch(n);
}

// scratch: cylon_pair_scan_scratch(n) bytes, 8-byte aligned, zeroed once
// and kept for the calls that follow on one stream; epoch: 1 .. 2^30 - 1,
// a new one each call on that scratch.
extern "C" int cylon_pair_max_scan(const void* hi, const void* lo,
                                   void* out_hi, void* out_lo, long long n,
                                   void* scratch, long long scratch_bytes,
                                   unsigned epoch, void* stream) {
  if (n < 0 || scratch_bytes < pair_scratch(n) || epoch == 0 ||
      epoch >= kPairEpochs || pair_tiles(n) > INT_MAX ||
      reinterpret_cast<uintptr_t>(scratch) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const auto* h = static_cast<const uint32_t*>(hi);
  const auto* l = static_cast<const uint32_t*>(lo);
  auto* oh = static_cast<uint32_t*>(out_hi);
  auto* ol = static_cast<uint32_t*>(out_lo);
  auto* sc = static_cast<char*>(scratch);
  auto* values = reinterpret_cast<u64*>(
      sc + 8 + 4 * pair_capacity(scratch_bytes));
  if (n <= kPairSplit) return run_scan<MaxU64>(PairIO{h, l, oh, ol}, n,
                                               values, stream);
  auto* counter = reinterpret_cast<unsigned*>(sc);
  auto* flags = reinterpret_cast<unsigned*>(sc + 8);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = ((reinterpret_cast<uintptr_t>(hi) |
                     reinterpret_cast<uintptr_t>(lo) |
                     reinterpret_cast<uintptr_t>(out_hi) |
                     reinterpret_cast<uintptr_t>(out_lo)) % 16) == 0;
  return vec ? run_look_back<true>(h, l, oh, ol, n, counter, flags, values,
                                   epoch, s)
             : run_look_back<false>(h, l, oh, ol, n, counter, flags, values,
                                    epoch, s);
}
