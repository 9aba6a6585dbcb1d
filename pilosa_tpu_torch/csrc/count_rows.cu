// K8 count_rows: per shard, the popcount of every row of a stacked row
// matrix, under an optional filter row.
//
// Replaces pilosa_tpu/executor/expr.py's 'countrows' node (:86-90) as
// batch.py vmaps it per shard and reduces it (:608-609): out[s, r] =
// popcount(matrix[s, r] & filt[s]) summed over the row's words (no AND
// without a filter). The output is int32[S, R]: a shard row has 2^20
// bits, so each value fits. The wrapper's caller split-sums it over
// shards on the device into the reference's packed [2, R]. Pad rows and
// padding slots are zero words and count 0.
//
// Bound on an H100: memory. Every matrix word and every filter word is
// read once: (R + 1) x S x W x 4 bytes / 3.35 TB/s, 0.36 ms for TopN's
// phase-2 chunk of R = 8 candidates over 1024 shards with a filter (1 GiB
// + 128 MiB). An AND and a popcount per word are far below the integer
// rate.
//
// Design: blockIdx.y is the shard and blockIdx.x a tile of TILE_WORDS
// words of it. A thread loads its filter words of the tile once into
// registers (ITEMS words or 16-byte groups, neighbouring threads on
// neighbouring addresses), then walks the R rows of the shard: per row it
// ANDs its matrix words against the held filter, popcounts, and each warp
// adds its sum into out[s, r] with one integer atomic (exact in any
// order). The filter is read from device memory once per tile, not once
// per row.
#include <climits>

#include "words.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long TILE_WORDS = 8192;

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
count_rows_kernel(const uint32_t* __restrict__ matrix,
                  const uint32_t* __restrict__ filt, int* __restrict__ out,
                  int n_rows, long long row_words) {
  constexpr int K = pilosa::kWords<T>;
  constexpr int ITEMS = TILE_WORDS / (K * THREADS);
  const long long s = blockIdx.y;
  const long long start = static_cast<long long>(blockIdx.x) * TILE_WORDS;
  const uint32_t* shard_filt = filt ? filt + s * row_words : nullptr;
  T f[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long w = start + static_cast<long long>(K) * (threadIdx.x +
                                                             i * THREADS);
    // a word past the row's end holds no bit: mask it to zero
    if (w >= row_words)
      f[i] = pilosa::splat(0u, T());
    else if (shard_filt)
      f[i] = pilosa::load_word(shard_filt, w, T());
    else
      f[i] = pilosa::splat(0xffffffffu, T());
  }
  const uint32_t* shard = matrix + s * n_rows * row_words;
  const bool lead = (threadIdx.x & 31) == 0;
  for (int r = 0; r < n_rows; ++r) {
    const uint32_t* row = shard + static_cast<long long>(r) * row_words;
    int c = 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long w = start + static_cast<long long>(K) * (threadIdx.x +
                                                               i * THREADS);
      if (w < row_words) c += pilosa::popc(pilosa::load_word(row, w, T()) & f[i]);
    }
    c = warp_sum(c);
    if (lead && c != 0) atomicAdd(out + s * n_rows + r, c);
  }
}

}  // namespace

// matrix: device int32[n_shards, n_rows, row_words]; filt: device
// int32[n_shards, row_words] or null; out: device int32[n_shards, n_rows],
// zeroed by the caller; vec: 1 when row_words % 4 == 0 and every pointer is
// 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int count_rows_launch(const void* matrix, const void* filt,
                                 void* out, long long n_shards, int n_rows,
                                 long long row_words, int vec, void* stream) {
  if (n_shards < 1 || n_shards > 65535 || n_rows < 1 || row_words < 1 ||
      (vec && row_words % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (row_words + TILE_WORDS - 1) / TILE_WORDS;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(n_shards));
  auto st = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const uint32_t*>(matrix);
  auto f = static_cast<const uint32_t*>(filt);
  auto o = static_cast<int*>(out);
  if (vec)
    count_rows_kernel<uint4><<<grid, THREADS, 0, st>>>(m, f, o, n_rows,
                                                       row_words);
  else
    count_rows_kernel<uint32_t><<<grid, THREADS, 0, st>>>(m, f, o, n_rows,
                                                          row_words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* count_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
