// K6 bsi_sum: per shard, the popcount of every bit plane under the
// exists row (and a filter row), and the count of the columns summed.
//
// Replaces pilosa_tpu/executor/expr.py's 'bsisum' node (:96-104) as
// batch.py vmaps it per shard (:610-615): plane_counts[s, i] =
// popcount(planes[s, 2 + i] & exists[s] & filter[s]) for i < depth and
// n[s] = popcount(exists[s] & filter[s]), where exists is row 0 of the
// planes. The output is int32[S, depth + 1] (counts ++ n); the wrapper's
// caller split-sums it over shards on the device into the reference's
// packed [2, depth + 1], and the host computes sum(counts[i] << i).
//
// Bound on an H100: memory. Each plane, the exists row and the filter
// row are read once: (depth + 1 [+ 1]) x S x W x 4 bytes / 3.35 TB/s,
// 0.84 ms unfiltered and 0.88 ms filtered at depth 20 over 1024 shards.
// An AND and a popcount per word and plane are far below the integer
// rate.
//
// Design: blockIdx.y is the shard and blockIdx.x a tile of TILE_WORDS
// words in it. A thread reads the exists and filter words of its 16-byte
// groups once and ANDs every plane's words against them, keeping one
// counter per plane in registers (the plane loop is unrolled to
// MAX_DEPTH under a guard, so the counters are never indexed at run
// time). At the end each warp reduces every counter with shuffles and
// lane 0 adds it into the shard's output: integer atomics, exact in any
// order.
#include <climits>

#include "words.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long TILE_WORDS = 8192;
constexpr int MAX_DEPTH = 63;

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bsi_sum_kernel(const uint32_t* __restrict__ planes,
               const uint32_t* __restrict__ filt, int* __restrict__ out,
               long long row_words, int depth) {
  constexpr int K = pilosa::kWords<T>;
  const long long s = blockIdx.y;
  const long long start = static_cast<long long>(blockIdx.x) * TILE_WORDS;
  const long long stop = min(start + TILE_WORDS, row_words);
  const uint32_t* shard = planes + s * (2 + depth) * row_words;
  const uint32_t* shard_filt = filt ? filt + s * row_words : nullptr;
  int counts[MAX_DEPTH];
  int n = 0;
#pragma unroll
  for (int i = 0; i < MAX_DEPTH; ++i) counts[i] = 0;
  for (long long w = start + static_cast<long long>(K) * threadIdx.x;
       w < stop; w += static_cast<long long>(K) * THREADS) {
    T m = pilosa::load_word(shard, w, T());  // exists: plane row 0
    if (shard_filt) m = m & pilosa::load_word(shard_filt, w, T());
    n += pilosa::popc(m);
#pragma unroll
    for (int i = 0; i < MAX_DEPTH; ++i) {
      if (i < depth)
        counts[i] += pilosa::popc(
            pilosa::load_word(shard + (2LL + i) * row_words, w, T()) & m);
    }
  }
  const bool lead = (threadIdx.x & 31) == 0;
  int* shard_out = out + s * (depth + 1);
#pragma unroll
  for (int i = 0; i < MAX_DEPTH; ++i) {
    if (i < depth) {
      const int c = warp_sum(counts[i]);
      if (lead && c != 0) atomicAdd(shard_out + i, c);
    }
  }
  n = warp_sum(n);
  if (lead && n != 0) atomicAdd(shard_out + depth, n);
}

}  // namespace

// planes: device int32[n_shards, 2 + depth, row_words]; filt: device
// int32[n_shards, row_words] or null; out: device int32[n_shards, depth +
// 1], zeroed by the caller; vec: 1 when row_words % 4 == 0 and every
// pointer is 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int bsi_sum_launch(const void* planes, const void* filt, void* out,
                              long long n_shards, long long row_words,
                              int depth, int vec, void* stream) {
  if (n_shards < 1 || n_shards > 65535 || row_words < 1 || depth < 0 ||
      depth > MAX_DEPTH || (vec && row_words % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (row_words + TILE_WORDS - 1) / TILE_WORDS;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(n_shards));
  auto st = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const uint32_t*>(planes);
  auto f = static_cast<const uint32_t*>(filt);
  auto o = static_cast<int*>(out);
  if (vec)
    bsi_sum_kernel<uint4><<<grid, THREADS, 0, st>>>(p, f, o, row_words, depth);
  else
    bsi_sum_kernel<uint32_t><<<grid, THREADS, 0, st>>>(p, f, o, row_words,
                                                        depth);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bsi_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
