// K2 tree_rows: the words of a bitwise tree over stacked leaves.
//
// Replaces pilosa_tpu/executor/expr.py::_go over leaf/const0/and/or/xor/
// diff as vmapped per shard by executor/batch.py::_local_body for the
// 'row' reduce kind (batch.py:619): the [S_padded, 32768] result words
// of Row/Union/Intersect/Difference/Xor. (flipall and shift are not
// ported yet.)
//
// Bound on an H100: memory. Each leaf word is read once and each result
// word written once, so the least time is
//   ((leaves + 1) x words x 4 bytes) / 3.35 TB/s,
// 120 us for a 2-leaf tree over 1B columns.
//
// Design: a grid-stride loop over 16-byte word groups; each thread
// evaluates the postfix program (tree_program.cuh) on four words and
// stores them. No intermediate tree node reaches device memory.
#include <climits>

#include "tree_program.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132LL * 16;  // SMs x resident blocks

__global__ void __launch_bounds__(THREADS)
tree_rows_kernel(const __grid_constant__ pilosa::TreeParams p,
                 uint32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS +
                          threadIdx.x;
  if (p.vec) {
    const long long n4 = p.n_words / 4;
    for (long long i = first; i < n4; i += stride)
      pilosa::store_word(out, 4 * i, pilosa::eval_program<uint4>(p, 0, 4 * i));
  } else {
    for (long long w = first; w < p.n_words; w += stride)
      pilosa::store_word(out, w, pilosa::eval_program<uint32_t>(p, 0, w));
  }
}

}  // namespace

// leaves: host array of n_leaves device pointers; code: host int[n_ops];
// out: device int32[n_words]. Returns the launch's cudaError_t.
extern "C" int tree_rows_launch(const void* const* leaves, int n_leaves,
                                uint32_t salt, const int* code, int n_ops,
                                long long n_words, int vec, void* out,
                                void* stream) {
  if (n_leaves < 0 || n_leaves > pilosa::MAX_LEAVES || n_words < 1 ||
      (vec && n_words % 4 != 0) ||
      !pilosa::valid_program(code, n_ops, n_leaves))
    return static_cast<int>(cudaErrorInvalidValue);
  pilosa::TreeParams p{};
  for (int l = 0; l < n_leaves; ++l)
    p.leaves[0][l] = static_cast<const uint32_t*>(leaves[l]);
  p.salt[0] = salt;
  for (int i = 0; i < n_ops; ++i) p.code[i] = code[i];
  p.n_ops = n_ops;
  p.vec = vec;
  p.n_words = n_words;
  const long long items = vec ? n_words / 4 : n_words;
  long long blocks = (items + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  tree_rows_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tree_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
