// Row hash for hash partitioning: murmur3 block mix of W u32 word streams.
//
// Replaces the Pallas kernel row_hash in cylon_tpu/ops/pallas_kernels.py
// (_hash_kernel and _row_hash_impl): per row, h = seed; h = mix(h, word_j)
// for every word stream j; h = fmix32(h ^ 4*W); with nparts > 0 the output
// is h % nparts as int32 partition ids, otherwise the u32 hash itself.
// Bit-identical to cylon_tpu_torch.ops.hash.hash_columns' plain chain.
//
// Bound on an H100 (3.35 TB/s): bytes moved, (4W + 4) per row -- each word
// read once, one u32 written. The mix is ~10 integer operations per word,
// far below the card's integer rate, so memory decides.
//
// Design: one thread per row in a grid-stride loop; the chain runs in
// uint32_t registers. The word streams come in as a struct of pointers and
// element strides passed by value, so an int64 key column is read in place
// as its (lo, hi) words (stride 2) and no [W, cap] stack is ever built:
// each input byte is read once, the output written once.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWords = 16;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

struct WordStreams {
  const uint32_t* ptr[kMaxWords];
  long long stride[kMaxWords];
  int count;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_word(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__global__ void __launch_bounds__(kThreads)
row_hash_kernel(WordStreams words, long long n, uint32_t seed,
                uint32_t nparts, uint32_t* out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    uint32_t h = seed;
    for (int j = 0; j < words.count; ++j) {
      h = mix_word(h, __ldg(words.ptr[j] + i * words.stride[j]));
    }
    h = fmix32(h ^ static_cast<uint32_t>(4 * words.count));
    out[i] = nparts ? h % nparts : h;
  }
}

}  // namespace

// ptrs/strides: host arrays of nwords device pointers and element strides.
// out: n u32 values (the hash) or int32 ids (nparts > 0).
extern "C" int cylon_row_hash(const void* const* ptrs,
                              const long long* strides, int nwords,
                              long long n, unsigned int seed,
                              unsigned int nparts, void* out,
                              void* stream) {
  if (nwords < 1 || nwords > kMaxWords || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  WordStreams words;
  words.count = nwords;
  for (int j = 0; j < kMaxWords; ++j) {
    words.ptr[j] = j < nwords ? static_cast<const uint32_t*>(ptrs[j])
                              : nullptr;
    words.stride[j] = j < nwords ? strides[j] : 0;
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  row_hash_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      words, n, seed, nparts, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
