// K9 groupby_level: one level of GroupBy, per shard and candidate group:
// the popcount of the AND of one row of every dimension matrix (and a
// filter row), and with an aggregate the count and bit-plane counts of
// an int field under that mask.
//
// Replaces pilosa_tpu/executor/batch.py::groupby_level_body (:696-722)
// as local_groupby_level_fn vmaps it per shard (:725-762). For shard s
// and candidate c:
//   mask = AND_d dims[d][s, idx[d][c]] & filt[s]        (no filt: skipped)
//   out[s, 0, c]     = popcount(mask)
// and with planes (exists, sign, depth bit planes of the int field):
//   g                = mask & planes[s, 0]
//   out[s, 1, c]     = popcount(g)
//   out[s, 2 + b, c] = popcount(planes[s, 2 + b] & g)   for b < depth
// The output is int32[S, K, C] with K = 1 (no aggregate) or 2 + depth; a
// shard row has 2^20 bits, so every value fits. The wrapper's caller
// split-sums it over shards on the device into the reference's packed
// layout. The mask is built one word (group) at a time in registers and
// never reaches device memory: the reference materializes [C, W] masks,
// this kernel does not.
//
// Bound on an H100: memory. Counted once per distinct byte, a level reads
// the dimension rows its candidates reference, the filter row and the
// planes once: (distinct rows + 1 + [2 + depth]) x S x W x 4 bytes /
// 3.35 TB/s. This design reads each candidate's rows anew: the gather
// volume is C x n_dims x S x W x 4 bytes, served from L2 where a shard's
// rows stay resident while its candidates run (see below) and from
// device memory otherwise. Reusing rows across candidates from shared
// memory is later work.
//
// Design: blockIdx.x is the candidate and blockIdx.y the shard, so the
// blocks of one shard's candidates are scheduled next to each other and
// re-read that shard's dimension rows (at most a few MB) from the 50 MB
// L2. A block walks the whole shard row, 16 bytes a thread per step
// (neighbouring threads on neighbouring addresses); the dimension loop is
// unrolled to MAX_DIMS under a guard and the plane loop to MAX_DEPTH, so
// row pointers and counters stay in registers. Each warp adds its sums
// into the output with integer atomics, exact in any order.
#include "words.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DIMS = 16;   // kernels.MAX_LEAVES
constexpr int MAX_DEPTH = 63;  // as K6 (bsi_sum.cu)

struct GroupParams {
  const uint32_t* dims[MAX_DIMS];  // int32[S, dim_rows[d], row_words]
  long long dim_rows[MAX_DIMS];
  const int* idx;                  // int32[n_dims, n_cand]
  const uint32_t* filt;            // int32[S, row_words] or null
  const uint32_t* planes;          // int32[S, 2 + depth, row_words] or null
  int n_dims;
  int n_cand;
  int depth;
  long long row_words;
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, bool AGG>
__global__ void __launch_bounds__(THREADS)
groupby_level_kernel(const __grid_constant__ GroupParams p,
                     int* __restrict__ out) {
  constexpr int K = pilosa::kWords<T>;
  const long long c = blockIdx.x;
  const long long s = blockIdx.y;
  const long long W = p.row_words;
  const uint32_t* rows[MAX_DIMS];
#pragma unroll
  for (int d = 0; d < MAX_DIMS; ++d) {
    rows[d] = nullptr;
    if (d < p.n_dims) {
      const long long r =
          __ldg(p.idx + static_cast<long long>(d) * p.n_cand + c);
      rows[d] = p.dims[d] + (s * p.dim_rows[d] + r) * W;
    }
  }
  const uint32_t* shard_filt = p.filt ? p.filt + s * W : nullptr;
  const uint32_t* shard_planes =
      AGG ? p.planes + s * (2LL + p.depth) * W : nullptr;
  int count = 0;
  int n = 0;
  int counts[AGG ? MAX_DEPTH : 1];
#pragma unroll
  for (int b = 0; b < (AGG ? MAX_DEPTH : 1); ++b) counts[b] = 0;
  for (long long w = static_cast<long long>(K) * threadIdx.x; w < W;
       w += static_cast<long long>(K) * THREADS) {
    T m = pilosa::load_word(rows[0], w, T());
#pragma unroll
    for (int d = 1; d < MAX_DIMS; ++d)
      if (d < p.n_dims) m = m & pilosa::load_word(rows[d], w, T());
    if (shard_filt) m = m & pilosa::load_word(shard_filt, w, T());
    count += pilosa::popc(m);
    if constexpr (AGG) {
      const T g = m & pilosa::load_word(shard_planes, w, T());  // exists
      n += pilosa::popc(g);
#pragma unroll
      for (int b = 0; b < MAX_DEPTH; ++b) {
        if (b < p.depth)
          counts[b] += pilosa::popc(
              pilosa::load_word(shard_planes + (2LL + b) * W, w, T()) & g);
      }
    }
  }
  const bool lead = (threadIdx.x & 31) == 0;
  const long long n_k = AGG ? 2 + p.depth : 1;
  int* o = out + s * n_k * p.n_cand + c;  // out[s, k, c] at o[k * n_cand]
  count = warp_sum(count);
  if (lead && count != 0) atomicAdd(o, count);
  if constexpr (AGG) {
    n = warp_sum(n);
    if (lead && n != 0) atomicAdd(o + p.n_cand, n);
#pragma unroll
    for (int b = 0; b < MAX_DEPTH; ++b) {
      if (b < p.depth) {
        const int v = warp_sum(counts[b]);
        if (lead && v != 0) atomicAdd(o + (2LL + b) * p.n_cand, v);
      }
    }
  }
}

}  // namespace

// dims: host array of n_dims device pointers, matrix d int32[n_shards,
// dim_rows[d], row_words]; dim_rows: host int64[n_dims]; idx: device
// int32[n_dims, n_cand] (checked by the caller: 0 <= idx[d][c] <
// dim_rows[d]); filt: device int32[n_shards, row_words] or null; planes:
// device int32[n_shards, 2 + depth, row_words] or null; out: device
// int32[n_shards, planes ? 2 + depth : 1, n_cand], zeroed by the caller;
// vec: 1 when row_words % 4 == 0 and every pointer is 16-byte aligned.
// Returns the launch's cudaError_t.
extern "C" int groupby_level_launch(const void* const* dims,
                                    const long long* dim_rows, int n_dims,
                                    const void* idx, int n_cand,
                                    const void* filt, const void* planes,
                                    int depth, long long n_shards,
                                    long long row_words, int vec, void* out,
                                    void* stream) {
  if (n_dims < 1 || n_dims > MAX_DIMS || n_cand < 1 || n_shards < 1 ||
      n_shards > 65535 || row_words < 1 || (vec && row_words % 4 != 0) ||
      (planes && (depth < 0 || depth > MAX_DEPTH)))
    return static_cast<int>(cudaErrorInvalidValue);
  GroupParams p{};
  for (int d = 0; d < n_dims; ++d) {
    if (dim_rows[d] < 1) return static_cast<int>(cudaErrorInvalidValue);
    p.dims[d] = static_cast<const uint32_t*>(dims[d]);
    p.dim_rows[d] = dim_rows[d];
  }
  p.idx = static_cast<const int*>(idx);
  p.filt = static_cast<const uint32_t*>(filt);
  p.planes = static_cast<const uint32_t*>(planes);
  p.n_dims = n_dims;
  p.n_cand = n_cand;
  p.depth = planes ? depth : 0;
  p.row_words = row_words;
  dim3 grid(static_cast<unsigned>(n_cand), static_cast<unsigned>(n_shards));
  auto st = static_cast<cudaStream_t>(stream);
  auto o = static_cast<int*>(out);
  if (vec) {
    if (planes)
      groupby_level_kernel<uint4, true><<<grid, THREADS, 0, st>>>(p, o);
    else
      groupby_level_kernel<uint4, false><<<grid, THREADS, 0, st>>>(p, o);
  } else {
    if (planes)
      groupby_level_kernel<uint32_t, true><<<grid, THREADS, 0, st>>>(p, o);
    else
      groupby_level_kernel<uint32_t, false><<<grid, THREADS, 0, st>>>(p, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* groupby_level_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
