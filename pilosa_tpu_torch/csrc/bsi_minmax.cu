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
// cross-shard merge, batch.minmax_merge, masks it out). The value is
// built in 64 bits, for up to 63 planes (the reference builds it in
// int32 and wraps past 31).
//
// Bound on an H100: memory. The exists row, each plane and the filter
// row are read once: (depth + 1 [+ 1]) x S x W x 4 bytes / 3.35 TB/s,
// 0.84 ms unfiltered and 0.88 ms filtered at depth 20 over 1024 shards.
//
// Design: a shard's walk is one vote per plane across the whole shard,
// so the shard is spread over a thread block cluster of C = W / 4096
// CTAs (8 at W = 32768), each CTA holding 4096 of the shard's candidate
// words in registers (16 words a thread). Per plane, a thread computes t
// = cand & (p ^ flip) from plane words it loaded before the previous
// plane's barrier, issues the loads of the next plane, and flags a
// non-empty t in its CTA's shared memory; after one cluster barrier
// every warp reads the C flags through distributed shared memory, and
// every thread sets cand = nonempty ? t : cand: each plane word is read
// once. Flags rotate through three slots so one barrier a plane orders
// both the votes and their reset. Several small CTAs share an SM, so
// one CTA's barrier is covered by the others' loads. Only the per-shard
// (value, count) pair reaches device memory.
#include <cooperative_groups.h>

#include "words.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WORDS_PER_THREAD = 16;
constexpr int CTA_WORDS = THREADS * WORDS_PER_THREAD;  // 4096
constexpr int MAX_CLUSTER = 8;                          // portable size
constexpr int MAX_DEPTH = 63;

template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
bsi_minmax_kernel(const uint32_t* __restrict__ planes,
                  const uint32_t* __restrict__ filt, long long row_words,
                  int depth, int want_max, long long* __restrict__ values,
                  int* __restrict__ counts) {
  constexpr int KW = pilosa::kWords<T>;
  constexpr int E = WORDS_PER_THREAD / KW;  // elements a thread holds
  __shared__ int flags[3];
  __shared__ int sums[THREADS / 32];
  __shared__ int cta_count;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned n_ctas = cluster.num_blocks();
  const long long s = blockIdx.x / n_ctas;
  const long long n_elems = row_words / KW;
  const long long first = rank * (CTA_WORDS / KW) + threadIdx.x;
  const uint32_t* shard = planes + s * (2 + depth) * row_words;
  const uint32_t* shard_filt = filt ? filt + s * row_words : nullptr;
  const T zero = pilosa::splat(0u, T());
  if (threadIdx.x < 3) flags[threadIdx.x] = 0;

  T cand[E], cur[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const long long e = first + k * THREADS;
    cand[k] = zero;
    cur[k] = zero;
    if (e < n_elems) {
      cand[k] = pilosa::load_word(shard, KW * e, T());  // exists: row 0
      if (shard_filt)
        cand[k] = cand[k] & pilosa::load_word(shard_filt, KW * e, T());
      if (depth > 0)
        cur[k] = pilosa::load_word(shard + (1LL + depth) * row_words, KW * e,
                                   T());
    }
  }
  __syncthreads();  // flags zeroed before any vote lands in them

  // max keeps the columns with the bit set, min those with it clear
  const T flip = pilosa::splat(want_max ? 0u : 0xffffffffu, T());
  unsigned long long value = 0;
  const int lane = threadIdx.x & 31;
  for (int i = depth - 1; i >= 0; --i) {
    T t[E];
    bool hit = false;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      t[k] = cand[k] & (cur[k] ^ flip);
      hit |= pilosa::nonzero(t[k]);
    }
    if (i > 0) {  // the next plane's loads fly across the barrier
      const uint32_t* p = shard + (1LL + i) * row_words;
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const long long e = first + k * THREADS;
        cur[k] = e < n_elems ? pilosa::load_word(p, KW * e, T()) : zero;
      }
    }
    if (hit) flags[i % 3] = 1;
    cluster.sync();
    // every warp reads the C flags, lane r from CTA r
    int remote = 0;
    if (lane < static_cast<int>(n_ctas))
      remote = cluster.map_shared_rank(flags, lane)[i % 3];
    const bool nonempty = __any_sync(0xffffffffu, remote != 0);
    // the previous plane's slot: read by everyone before this barrier,
    // written again only after the next one
    if (threadIdx.x == 0) flags[(i + 1) % 3] = 0;
#pragma unroll
    for (int k = 0; k < E; ++k)
      if (nonempty) cand[k] = t[k];
    if (want_max ? nonempty : !nonempty) value |= 1ULL << i;
  }

  int n = 0;
#pragma unroll
  for (int k = 0; k < E; ++k) n += pilosa::popc(cand[k]);
  for (int off = 16; off > 0; off >>= 1)
    n += __shfl_down_sync(0xffffffffu, n, off);
  if (lane == 0) sums[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < THREADS / 32; ++w) total += sums[w];
    cta_count = total;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    int total = 0;
    for (unsigned r = 0; r < n_ctas; ++r)
      total += *cluster.map_shared_rank(&cta_count, r);
    values[s] = static_cast<long long>(value);
    counts[s] = total;
  }
  cluster.sync();  // no CTA leaves while CTA 0 reads its count
}

template <typename T>
int launch(int n_ctas, const void* planes, const void* filt,
           long long n_shards, long long row_words, int depth, int want_max,
           void* values, void* counts, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_shards * n_ctas));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, bsi_minmax_kernel<T>, static_cast<const uint32_t*>(planes),
      static_cast<const uint32_t*>(filt), row_words, depth, want_max,
      static_cast<long long*>(values), static_cast<int*>(counts));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes: device int32[n_shards, 2 + depth, row_words], row_words <=
// 32768; filt: device int32[n_shards, row_words] or null; values: device
// int64[n_shards]; counts: device int32[n_shards]. vec: 1 when row_words
// % 4 == 0 and the pointers are 16-byte aligned. Returns the launch's
// cudaError_t.
extern "C" int bsi_minmax_launch(const void* planes, const void* filt,
                                 long long n_shards, long long row_words,
                                 int depth, int want_max, int vec,
                                 void* values, void* counts, void* stream) {
  if (n_shards < 1 || n_shards * MAX_CLUSTER > 0x7fffffffLL ||
      row_words < 1 || row_words > static_cast<long long>(CTA_WORDS) *
                                       MAX_CLUSTER ||
      (vec && row_words % 4 != 0) || depth < 0 || depth > MAX_DEPTH)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_ctas = static_cast<int>((row_words + CTA_WORDS - 1) / CTA_WORDS);
  auto st = static_cast<cudaStream_t>(stream);
  return vec ? launch<uint4>(n_ctas, planes, filt, n_shards, row_words, depth,
                             want_max, values, counts, st)
             : launch<uint32_t>(n_ctas, planes, filt, n_shards, row_words,
                                depth, want_max, values, counts, st);
}

extern "C" const char* bsi_minmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
