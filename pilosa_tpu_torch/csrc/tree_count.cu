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
// Design. The wrapper classifies the program (tree_program.cuh) once per
// micro-batch: every query of a batch runs the same program over its own
// leaves, and only the salt differs, so a fold's xor mask is a per-query
// array in the parameters. A chain or head-diff runs a template kernel
// per (op, head-diff, leaf bucket 2/4/8/16) over 16-byte groups, R =
// 4, 4, 2, 1 of them a thread and step, with every leaf load of a step
// issued before any operation (eval_form); any other program runs
// eval_general's register stack (D = 4 or 8 slots of 16-byte groups,
// 16 slots of single words past depth 8, or for rows that are not
// 16-byte groups). No stack lives in local memory. blockIdx.y picks the
// query, blockIdx.x a tile of `steps` steps inside one output row; each
// thread keeps a private popcount, the block reduces it with warp
// shuffles and adds one int32 into its row's partial. Integer addition
// is associative, so the partials are exact and the same on every run
// whatever order the atomics land in. Intermediate words never reach
// device memory.
#include <climits>

#include "tree_program.cuh"

namespace {

constexpr int THREADS = 256;

struct CountParams {
  // forms: each query's leaves in fold order (the head first);
  // general: by leaf index
  const uint32_t* leaves[pilosa::MAX_BATCH][pilosa::MAX_LEAVES];
  uint32_t mask[pilosa::MAX_BATCH];  // forms: xored into the result
  uint32_t salt[pilosa::MAX_BATCH];  // general: OP_SALT's operand
  int code[pilosa::MAX_OPS];
  int n_ops;
  int n_leaves;
  int steps;               // steps a block walks inside its row
  long long row_elems;     // elements (words or groups) per output row
  long long n_rows;
  long long tiles_per_row;
};

// Sum of v over the block added into *dst (when nonzero) by thread 0.
__device__ __forceinline__ void block_add(int v, int* dst) {
  __shared__ int warp_sums[THREADS / 32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0 && v != 0) atomicAdd(dst, v);
  }
}

template <int OP, bool HEAD_DIFF, int N, int R>
__global__ void __launch_bounds__(THREADS)
tree_count_form_kernel(const __grid_constant__ CountParams p, int* __restrict__ partials) {
  const int q = blockIdx.y;
  const long long row = blockIdx.x / p.tiles_per_row;
  const long long tile = blockIdx.x % p.tiles_per_row;
  const long long end = (row + 1) * p.row_elems;
  const long long first = row * p.row_elems +
                          tile * p.steps * (THREADS * R) + threadIdx.x;
  const uint4 mask = pilosa::splat(p.mask[q], uint4());
  // the query's leaf pointers in registers once (read from the
  // parameters inside the step loop, ptxas spilled the chains of 4)
  const uint32_t* lp[N];
#pragma unroll
  for (int j = 0; j < N; ++j) lp[j] = p.leaves[q][j];
  int count = 0;
  for (int s = 0; s < p.steps; ++s) {
    const long long base = first + static_cast<long long>(s) * THREADS * R;
    if (base >= end) break;
    uint4 acc[R];
    pilosa::eval_form<OP, HEAD_DIFF, N, R>(lp, p.n_leaves, base, THREADS,
                                           end, acc);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (base + static_cast<long long>(r) * THREADS < end)
        count += pilosa::popc(acc[r] ^ mask);
  }
  block_add(count, partials + q * p.n_rows + row);
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(THREADS)
tree_count_general_kernel(const __grid_constant__ CountParams p,
               int* __restrict__ partials) {
  const int q = blockIdx.y;
  const long long row = blockIdx.x / p.tiles_per_row;
  const long long tile = blockIdx.x % p.tiles_per_row;
  const long long end = (row + 1) * p.row_elems;
  const long long first = row * p.row_elems +
                          tile * p.steps * (THREADS * R) + threadIdx.x;
  int count = 0;
  for (int s = 0; s < p.steps; ++s) {
    const long long base = first + static_cast<long long>(s) * THREADS * R;
    if (base >= end) break;
    T acc[R];
    pilosa::eval_general<T, D, R>(p.code, p.n_ops, p.leaves[q], p.salt[q],
                                  base, THREADS, end, acc);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (base + static_cast<long long>(r) * THREADS < end)
        count += pilosa::popc(acc[r]);
  }
  block_add(count, partials + q * p.n_rows + row);
}

template <typename K>
int launch(K kernel, CountParams& p, int n_batch, int per_thread,
           int* partials, cudaStream_t st) {
  const long long per_tile =
      static_cast<long long>(THREADS) * per_thread * p.steps;
  p.tiles_per_row = (p.row_elems + per_tile - 1) / per_tile;
  const long long blocks = p.n_rows * p.tiles_per_row;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_batch));
  kernel<<<grid, THREADS, 0, st>>>(p, partials);
  return static_cast<int>(cudaGetLastError());
}

template <int OP, bool HD>
int launch_form(CountParams& p, int n_batch, int* out, cudaStream_t st) {
  if (p.n_leaves <= 2)
    return launch(tree_count_form_kernel<OP, HD, 2, 4>, p, n_batch, 4, out, st);
  if (p.n_leaves <= 4)
    return launch(tree_count_form_kernel<OP, HD, 4, 4>, p, n_batch, 4, out, st);
  if (p.n_leaves <= 8)
    return launch(tree_count_form_kernel<OP, HD, 8, 2>, p, n_batch, 2, out, st);
  return launch(tree_count_form_kernel<OP, HD, 16, 1>, p, n_batch, 1, out, st);
}

template <bool HD>
int launch_op(int op, CountParams& p, int n_batch, int* out,
              cudaStream_t st) {
  switch (op) {
    case pilosa::OP_AND:
      return launch_form<pilosa::OP_AND, HD>(p, n_batch, out, st);
    case pilosa::OP_OR:
      return launch_form<pilosa::OP_OR, HD>(p, n_batch, out, st);
    default:
      return launch_form<pilosa::OP_XOR, HD>(p, n_batch, out, st);
  }
}

// Programs deeper than 8 run one word a lane: 16 slots of 16-byte groups
// would not stay in registers.
int launch_general(int depth, int vec, CountParams& p, int n_batch, int* out,
                   cudaStream_t st) {
  if (depth > 8 || !vec) {
    if (vec) p.row_elems *= 4;  // back to words
    if (depth <= 4)
      return launch(tree_count_general_kernel<uint32_t, 4, 2>, p, n_batch, 2, out, st);
    if (depth <= 8)
      return launch(tree_count_general_kernel<uint32_t, 8, 2>, p, n_batch, 2, out, st);
    return launch(tree_count_general_kernel<uint32_t, 16, 2>, p, n_batch, 2, out, st);
  }
  if (depth <= 4)
    return launch(tree_count_general_kernel<uint4, 4, 2>, p, n_batch, 2, out, st);
  return launch(tree_count_general_kernel<uint4, 8, 2>, p, n_batch, 2, out, st);
}

}  // namespace

// form: 0 general, 1 chain, 2 head-diff (kernels.classify_program).
// leaves: host array of n_batch x n_leaves device pointers, query-major
// (a form's leaves in fold order, the head first; the general form's by
// leaf index). op: the fold's OP_AND/OP_OR/OP_XOR (forms). masks: host
// uint32[n_batch], xored into a form's result; salts: host
// uint32[n_batch], the general form's OP_SALT operands. code/n_ops: the
// general form's program. steps: the
// steps of R groups a thread one block walks (>= 1). partials: device
// int32[n_batch, n_words / row_words], zeroed by the caller. vec: 1 when
// row_words % 4 == 0 and every pointer is 16-byte aligned (forms need
// it). Returns the launch's cudaError_t (0 on success).
extern "C" int tree_count_launch(const void* const* leaves, int n_batch,
                                 int n_leaves, int form, int op,
                                 const uint32_t* masks, const uint32_t* salts,
                                 const int* code, int n_ops,
                                 long long n_words, long long row_words,
                                 int vec, int steps, int* partials,
                                 void* stream) {
  if (n_batch < 1 || n_batch > pilosa::MAX_BATCH || n_leaves < 1 ||
      n_leaves > pilosa::MAX_LEAVES || n_words < 1 || row_words < 1 ||
      n_words % row_words != 0 || (vec && row_words % 4 != 0) || steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CountParams p{};
  for (int b = 0; b < n_batch; ++b) {
    for (int l = 0; l < n_leaves; ++l)
      p.leaves[b][l] = static_cast<const uint32_t*>(leaves[b * n_leaves + l]);
    p.mask[b] = masks[b];
    p.salt[b] = salts[b];
  }
  for (int i = 0; i < n_ops; ++i) p.code[i] = code[i];
  p.n_ops = n_ops;
  p.n_leaves = n_leaves;
  p.steps = steps;
  p.n_rows = n_words / row_words;
  p.row_elems = vec ? row_words / 4 : row_words;
  auto st = static_cast<cudaStream_t>(stream);
  if (form == pilosa::FORM_CHAIN || form == pilosa::FORM_HEAD_DIFF) {
    if (!vec || (op != pilosa::OP_AND && op != pilosa::OP_OR &&
                 op != pilosa::OP_XOR) ||
        (form == pilosa::FORM_HEAD_DIFF && n_leaves < 2))
      return static_cast<int>(cudaErrorInvalidValue);
    return form == pilosa::FORM_CHAIN
               ? launch_op<false>(op, p, n_batch, partials, st)
               : launch_op<true>(op, p, n_batch, partials, st);
  }
  if (form != pilosa::FORM_GENERAL ||
      !pilosa::valid_program(code, n_ops, n_leaves))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_general(pilosa::stack_depth(code, n_ops), vec, p, n_batch,
                        partials, st);
}

extern "C" const char* tree_count_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
