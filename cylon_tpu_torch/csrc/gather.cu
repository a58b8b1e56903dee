// gather_rows: the packed row gather. For a contiguous [cap, w] matrix of
// 4-byte words and an index of n int32 or int64 entries, out row i is
// words[clamp(idx[i], 0, cap - 1)]. Bit-identical to gather_rows_plain in
// cylon_tpu_torch/kernels/gather.py (index_select of the clamped index).
//
// Replaces no Pallas kernel: the JAX package leaves its row gathers to XLA
// (jnp.take). It takes the place of PyTorch's index_select on the packed
// matrices of take_columns, the join's plan gather and the exchange's send
// buffer. For rows of 16 bytes (and any multiple of 16) that library call
// runs ATen's vectorized_gather_kernel, which launches one block for each
// index and keeps one thread of it busy: at 2^25 indices block scheduling,
// not memory, sets its pace (about 20 ms a gather on an H100).
//
// Bound on an H100 (3.35 TB/s): the index read once (4 or 8 bytes a row),
// the n output rows written once (4w bytes each) and each source row that
// the index names read once. A random row read moves at least one 32-byte
// sector, so a gather of 16-byte rows at random moves up to
// n * (index + 16 + 32) bytes.
//
// Design: a row is cut into k pieces of V words, V in {4, 2, 1} the widest
// vector that divides w and that both matrices' alignment allows: a
// 16-byte row is one 16-byte piece, an 8-byte row one 8-byte piece; 8
// words are two 16-byte pieces, 5 words five words. The output is one flat
// run of n * k pieces, and the grid walks it with a grid stride: element e
// is piece e % k of row e / k. So neighbouring lanes write neighbouring
// pieces, read neighbouring pieces of one source row, and no lane idles
// whatever k is. A lane divides once, at its first element; it then steps
// its row and piece by the stride's quotient and remainder. Each lane
// takes kUnroll elements a step, their index loads first, then their row
// loads, then the stores, so that several random reads are in flight a
// lane (2 measured best or near it at every width from 1 to 64 words:
// more raise the registers and cut the lanes in flight on wide rows). The
// row loads bypass L1 (no source row is read twice by one SM to any
// purpose) and the stores stream (evict first), which leaves L2 to the
// source rows. The grid is what the card holds at once (occupancy times
// SMs, at most enough blocks for the elements). The clamp is folded into
// the index load. Launched on the caller's stream; it never synchronises
// and allocates nothing, so it is safe under graph capture.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;

template <typename Vec, typename Index>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Vec* __restrict__ words, long long cap,
                   const Index* __restrict__ idx, long long total, int k,
                   Vec* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const long long step_rows = step / k;
  const int step_pieces = static_cast<int>(step % k);
  long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long row = e / k;
  int piece = static_cast<int>(e % k);
  for (; e < total; e += step * kUnroll) {
    long long at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      at[u] = 0;
      if (e + u * step < total) {
        long long s = static_cast<long long>(__ldg(idx + row));
        s = s < 0 ? 0 : (s >= cap ? cap - 1 : s);
        at[u] = s * k + piece;
      }
      row += step_rows;
      piece += step_pieces;
      if (piece >= k) {
        piece -= k;
        ++row;
      }
    }
    Vec v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (e + u * step < total) v[u] = __ldcg(words + at[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (e + u * step < total) __stcs(out + e + u * step, v[u]);
    }
  }
}

template <typename Vec, typename Index>
int launch(const void* words, long long cap, const void* idx, long long n,
           int k, void* out, cudaStream_t stream) {
  static int resident = 0;   // blocks the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_rows_kernel<Vec, Index>, kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long total = n * k;
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  long long blocks = (total + per_block - 1) / per_block;
  if (blocks > resident) blocks = resident;
  gather_rows_kernel<Vec, Index>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const Vec*>(words), cap,
          static_cast<const Index*>(idx), total, k, static_cast<Vec*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename Index>
int launch_width(const void* words, long long cap, int w, const void* idx,
                 long long n, void* out, cudaStream_t stream) {
  const auto aligned = [&](uintptr_t bytes) {
    return reinterpret_cast<uintptr_t>(words) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(out) % bytes == 0;
  };
  if (w % 4 == 0 && aligned(16)) {
    return launch<int4, Index>(words, cap, idx, n, w / 4, out, stream);
  }
  if (w % 2 == 0 && aligned(8)) {
    return launch<int2, Index>(words, cap, idx, n, w / 2, out, stream);
  }
  return launch<int, Index>(words, cap, idx, n, w, out, stream);
}

}  // namespace

// words: cap * w int32, row-major, 4-byte aligned. idx: n entries of
// index_bytes (4: int32, 8: int64). out: n * w int32, written here.
extern "C" int cylon_gather_rows(const void* words, long long cap, int w,
                                 const void* idx, int index_bytes,
                                 long long n, void* out, void* stream) {
  if (n < 0 || w < 1 || (n > 0 && cap < 1) ||
      (index_bytes != 4 && index_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return index_bytes == 4
             ? launch_width<int32_t>(words, cap, w, idx, n, out, s)
             : launch_width<long long>(words, cap, w, idx, n, out, s);
}
