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
//
// Any number of words: the struct holds kChunk streams, and a key of more
// words runs the chain over chunks of kChunk words, one launch per chunk on
// the same stream. The running hash is carried between launches in the
// output buffer (each thread reads back what it wrote for its own rows);
// only the last launch applies fmix32 and the modulo. A key of up to
// kChunk words -- every int64 key of up to 8 columns -- is one launch and
// pays nothing for it; a wider key pays 8 bytes a row per extra chunk.
// (The other design, a descriptor array in device memory, would add a
// host-to-device copy to every call.)

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

struct WordStreams {
  const uint32_t* ptr[kChunk];
  long long stride[kChunk];
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

// first: start from seed (else from out[i], the previous chunk's hash).
// total_words > 0 marks the last chunk: finalise with the key's word count.
__global__ void __launch_bounds__(kThreads)
row_hash_kernel(WordStreams words, long long n, uint32_t seed, int first,
                int total_words, uint32_t nparts, uint32_t* out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    uint32_t h = first ? seed : out[i];
    for (int j = 0; j < words.count; ++j) {
      h = mix_word(h, __ldg(words.ptr[j] + i * words.stride[j]));
    }
    if (total_words > 0) {
      h = fmix32(h ^ static_cast<uint32_t>(4 * total_words));
      if (nparts) h %= nparts;
    }
    out[i] = h;
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
  if (nwords < 1 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  for (int c = 0; c < nwords; c += kChunk) {
    WordStreams words;
    words.count = nwords - c < kChunk ? nwords - c : kChunk;
    for (int j = 0; j < kChunk; ++j) {
      const bool used = j < words.count;
      words.ptr[j] = used ? static_cast<const uint32_t*>(ptrs[c + j])
                          : nullptr;
      words.stride[j] = used ? strides[c + j] : 0;
    }
    const bool last = c + kChunk >= nwords;
    row_hash_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        words, n, seed, c == 0, last ? nwords : 0, nparts,
        static_cast<uint32_t*>(out));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
