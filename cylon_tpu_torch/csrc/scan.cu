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
// Design: simple and right, three passes over tiles of 256 threads x 8
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
// fmaxf would drop it. A pair is packed into one unsigned 64-bit value, hi
// in the top half, so the unsigned max is the lexicographic max; the
// identity is 0, so positions before any nonzero pair read (0, 0).

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

extern "C" int cylon_pair_max_scan(const void* hi, const void* lo,
                                   void* out_hi, void* out_lo, long long n,
                                   void* scratch, void* stream) {
  PairIO io{static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
            static_cast<uint32_t*>(out_hi), static_cast<uint32_t*>(out_lo)};
  return run_scan<MaxU64>(io, n, scratch, stream);
}
