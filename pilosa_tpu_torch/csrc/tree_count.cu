// K1 tree_count: per-row popcount of a bitwise tree over stacked leaves.
//
// Replaces, on the TPU side:
//   - bench_pallas.py::pallas_intersect_count (the pl.pallas_call at :99):
//     per-row sum(popcount(a & (b ^ salt))) over uint32[R, W];
//   - pilosa_tpu/executor/batch.py::count_flat with expr.py::_go over
//     leaf/const0/and/or/xor/diff, micro-batched by local_fn_batched: the
//     elementwise count tree reduced in 2^18-word rows.
//
// Bound on an H100: memory. Every leaf word is read once and nothing but
// int32 partials is written, so the least time is
//   (queries x leaves x words x 4 bytes) / 3.35 TB/s,
// 80 us for one 2-leaf Count over 1B columns (2 x 128 MiB). The tree
// costs a few integer operations per 16 bytes, far below the card's
// integer rate, so operations never bound it.
//
// Design: blockIdx.y picks the query of the micro-batch, blockIdx.x a
// tile of TILE_WORDS words inside one output row. Each thread reads 16
// bytes per leaf per step (coalesced), evaluates the postfix program in
// registers and keeps a private popcount; the block reduces with warp
// shuffles and adds one int32 into its row's partial. Integer addition
// is associative, so the partials are exact and the same on every run
// whatever order the atomics land in. Intermediate words never reach
// device memory.
#include <climits>

#include "tree_program.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long TILE_WORDS = 8192;

__global__ void __launch_bounds__(THREADS)
tree_count_kernel(const __grid_constant__ pilosa::TreeParams p,
                  int* __restrict__ partials) {
  const int q = blockIdx.y;
  const long long row = blockIdx.x / p.tiles_per_row;
  const long long tile = blockIdx.x % p.tiles_per_row;
  const long long row_start = row * p.row_words;
  const long long start = row_start + tile * TILE_WORDS;
  const long long stop = min(start + TILE_WORDS, row_start + p.row_words);
  int count = 0;
  if (p.vec) {
    for (long long w = start + 4LL * threadIdx.x; w < stop; w += 4LL * THREADS)
      count += pilosa::popc(pilosa::eval_program<uint4>(p, q, w));
  } else {
    for (long long w = start + threadIdx.x; w < stop; w += THREADS)
      count += pilosa::popc(pilosa::eval_program<uint32_t>(p, q, w));
  }
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  __shared__ int warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  if (warp == 0) {
    count = lane < THREADS / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      count += __shfl_down_sync(0xffffffffu, count, off);
    if (lane == 0 && count != 0)
      atomicAdd(partials + q * p.n_rows + row, count);
  }
}

}  // namespace

// leaves: host array of n_batch x n_leaves device pointers (query-major);
// salts: host uint32[n_batch]; code: host int[n_ops]; partials: device
// int32[n_batch, n_words / row_words], zeroed by the caller. Returns the
// launch's cudaError_t (0 on success).
extern "C" int tree_count_launch(const void* const* leaves, int n_batch,
                                 int n_leaves, const uint32_t* salts,
                                 const int* code, int n_ops,
                                 long long n_words, long long row_words,
                                 int vec, int* partials, void* stream) {
  if (n_batch < 1 || n_batch > pilosa::MAX_BATCH || n_leaves < 0 ||
      n_leaves > pilosa::MAX_LEAVES || n_words < 1 || row_words < 1 ||
      n_words % row_words != 0 || (vec && row_words % 4 != 0) ||
      !pilosa::valid_program(code, n_ops, n_leaves))
    return static_cast<int>(cudaErrorInvalidValue);
  pilosa::TreeParams p{};
  for (int b = 0; b < n_batch; ++b) {
    for (int l = 0; l < n_leaves; ++l)
      p.leaves[b][l] = static_cast<const uint32_t*>(leaves[b * n_leaves + l]);
    p.salt[b] = salts[b];
  }
  for (int i = 0; i < n_ops; ++i) p.code[i] = code[i];
  p.n_ops = n_ops;
  p.vec = vec;
  p.n_words = n_words;
  p.row_words = row_words;
  p.n_rows = n_words / row_words;
  p.tiles_per_row = (row_words + TILE_WORDS - 1) / TILE_WORDS;
  const long long blocks = p.n_rows * p.tiles_per_row;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_batch));
  tree_count_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, partials);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tree_count_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
