// K7 bsi_minmax: per shard, the largest (or smallest) stored value among
// the columns that exist (and pass a filter row), and how many columns
// hold it.
//
// Replaces pilosa_tpu/executor/expr.py::_bsi_minmax (:147-167), the
// 'bsiminmax' node as batch.py vmaps it per shard (:602-605): a greedy
// MSB-first walk. For each plane, t = candidates & (max ? p : ~p); when
// t is non-empty IN THIS SHARD the candidates become t. The value's bit
// is "t non-empty" for max and "t empty" for min. The count is the
// popcount of the final candidates (0: the shard has none, and the
// cross-shard merge, batch.minmax_merge, masks it out).
//
// Bound on an H100: memory. The exists row, each plane and the filter
// row are read once: (depth + 1 [+ 1]) x S x W x 4 bytes / 3.35 TB/s,
// 0.84 ms unfiltered and 0.88 ms filtered at depth 20 over 1024 shards.
//
// Design: one block of 1024 threads per shard (W <= 32768 words). Each
// thread keeps its 32 candidate words in registers for the whole walk;
// per plane it reads its 32 plane words (neighbouring threads on
// neighbouring words), votes with __syncthreads_or whether any candidate
// survives, and, when one does, reads the plane words again (from L1 or
// L2) to narrow its candidates. Only the per-shard (value, count) pair
// reaches device memory.
#include "words.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WPT = 32;  // candidate words per thread
constexpr int MAX_DEPTH = 31;

__global__ void __launch_bounds__(THREADS, 1)
bsi_minmax_kernel(const uint32_t* __restrict__ planes,
                  const uint32_t* __restrict__ filt, long long row_words,
                  int depth, int want_max, int* __restrict__ values,
                  int* __restrict__ counts) {
  const long long s = blockIdx.x;
  const uint32_t* shard = planes + s * (2 + depth) * row_words;
  const uint32_t* shard_filt = filt ? filt + s * row_words : nullptr;
  uint32_t cand[WPT];
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const long long w = threadIdx.x + static_cast<long long>(k) * THREADS;
    cand[k] = 0;
    if (w < row_words) {
      cand[k] = __ldg(shard + w);  // exists: plane row 0
      if (shard_filt) cand[k] &= __ldg(shard_filt + w);
    }
  }
  // max keeps the columns with the bit set, min those with it clear
  const uint32_t flip = want_max ? 0u : 0xffffffffu;
  unsigned value = 0;
  for (int i = depth - 1; i >= 0; --i) {
    const uint32_t* p = shard + (2LL + i) * row_words;
    int hit = 0;
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      const long long w = threadIdx.x + static_cast<long long>(k) * THREADS;
      if (w < row_words) hit |= (cand[k] & (__ldg(p + w) ^ flip)) != 0;
    }
    const int nonempty = __syncthreads_or(hit);
    if (nonempty) {
#pragma unroll
      for (int k = 0; k < WPT; ++k) {
        const long long w = threadIdx.x + static_cast<long long>(k) * THREADS;
        if (w < row_words) cand[k] &= __ldg(p + w) ^ flip;
      }
    }
    if (want_max ? nonempty : !nonempty) value |= 1u << i;
  }
  int n = 0;
#pragma unroll
  for (int k = 0; k < WPT; ++k) n += __popc(cand[k]);
  n = pilosa::block_sum(n);
  if (threadIdx.x == 0) {
    values[s] = static_cast<int>(value);
    counts[s] = n;
  }
}

}  // namespace

// planes: device int32[n_shards, 2 + depth, row_words], row_words <=
// 32768; filt: device int32[n_shards, row_words] or null; values, counts:
// device int32[n_shards]. Returns the launch's cudaError_t.
extern "C" int bsi_minmax_launch(const void* planes, const void* filt,
                                 long long n_shards, long long row_words,
                                 int depth, int want_max, void* values,
                                 void* counts, void* stream) {
  if (n_shards < 1 || n_shards > 0x7fffffffLL || row_words < 1 ||
      row_words > static_cast<long long>(THREADS) * WPT || depth < 0 ||
      depth > MAX_DEPTH)
    return static_cast<int>(cudaErrorInvalidValue);
  bsi_minmax_kernel<<<static_cast<unsigned>(n_shards), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), static_cast<const uint32_t*>(filt),
      row_words, depth, want_max, static_cast<int*>(values),
      static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bsi_minmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
