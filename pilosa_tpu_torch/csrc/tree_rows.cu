// K2 tree_rows: the words of a bitwise tree over stacked leaves.
//
// Replaces pilosa_tpu/executor/expr.py::_go over leaf/const0/and/or/xor/
// diff/flipall as vmapped per shard by executor/batch.py::_local_body for
// the 'row' reduce kind (batch.py:619): the [S_padded, 32768] result words
// of Row/Union/Intersect/Difference/Xor/Not.
//
// Bound on an H100: memory. Each leaf word is read once and each result
// word written once, so the least time is
//   ((leaves + 1) x words x 4 bytes) / 3.35 TB/s,
// 120 us for a 2-leaf tree over 1B columns.
//
// Design. The wrapper classifies the program (tree_program.cuh: chain,
// head-diff or general). A chain or head-diff runs a template kernel per
// (op, head-diff, leaf-count bucket 2/4/8/16): each thread takes R
// 16-byte groups a step (R = 4, 4, 2, 1 for the four buckets, so the
// leaves of a step fill at most 64 registers), issues every leaf load of
// the step before any operation (eval_form), and writes the result with
// streaming stores (__stcs: the host reads it back, the card does not;
// plain stores ran slower, and plain loads or loads that skip L1 and
// prefetch 256-byte L2 sectors ran no faster than read-only __ldg
// loads). The general form runs eval_general with D = 4 or 8 slots of
// 16-byte groups, or 16 slots of single words for deeper programs, the
// program's depth rounded up. The grid has one block per step: capped
// at a wave of resident blocks (the occupancy calculator's count) over
// a grid-stride loop it ran 4-6% slower. Rows whose word count is not a
// multiple of 4, or that are not 16-byte aligned, take the general form
// one word at a time.
#include "tree_program.cuh"

namespace {

constexpr int THREADS = 256;
using pilosa::FORM_CHAIN;
using pilosa::FORM_GENERAL;
using pilosa::FORM_HEAD_DIFF;

struct RowsParams {
  const uint32_t* leaves[pilosa::MAX_LEAVES];
  int n_leaves;          // forms: leaves in fold order; general: by index
  uint32_t xor_mask;     // forms: applied to the result
  uint32_t salt;         // general: OP_SALT's operand
  int code[pilosa::MAX_OPS];
  int n_ops;
  long long n_words;
};

__device__ __forceinline__ void store_cs(uint32_t* p, long long w,
                                         uint32_t v) {
  __stcs(p + w, v);
}
__device__ __forceinline__ void store_cs(uint32_t* p, long long w, uint4 v) {
  __stcs(reinterpret_cast<uint4*>(p + w), v);
}

// Chain and head-diff forms over 16-byte groups: N is the leaf bucket,
// R the groups a thread takes per step.
template <int OP, bool HEAD_DIFF, int N, int R>
__global__ void __launch_bounds__(THREADS)
tree_rows_form_kernel(const __grid_constant__ RowsParams p, uint32_t* __restrict__ out) {
  const long long n4 = p.n_words / 4;
  const long long step = static_cast<long long>(gridDim.x) * THREADS * R;
  const uint4 mask = pilosa::splat(p.xor_mask, uint4());
  for (long long base = static_cast<long long>(blockIdx.x) * THREADS * R +
                        threadIdx.x;
       base < n4; base += step) {
    uint4 acc[R];
    pilosa::eval_form<OP, HEAD_DIFF, N, R>(p.leaves, p.n_leaves, base,
                                           THREADS, n4, acc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long i = base + static_cast<long long>(r) * THREADS;
      if (i < n4) store_cs(out, 4 * i, acc[r] ^ mask);
    }
  }
}

// The general form over elements of T (one word or a 16-byte group).
template <typename T, int D, int R>
__global__ void __launch_bounds__(THREADS)
tree_rows_general_kernel(const __grid_constant__ RowsParams p,
               uint32_t* __restrict__ out) {
  constexpr int KW = pilosa::kWords<T>;
  const long long n = p.n_words / KW;
  const long long step = static_cast<long long>(gridDim.x) * THREADS * R;
  for (long long base = static_cast<long long>(blockIdx.x) * THREADS * R +
                        threadIdx.x;
       base < n; base += step) {
    T acc[R];
    pilosa::eval_general<T, D, R>(p.code, p.n_ops, p.leaves, p.salt, base,
                                  THREADS, n, acc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long e = base + static_cast<long long>(r) * THREADS;
      if (e < n) store_cs(out, KW * e, acc[r]);
    }
  }
}

// One block per step of R groups a thread (a grid-stride loop covers
// what a grid cannot).
template <typename K>
int launch(K kernel, const RowsParams& p, long long items, int per_thread,
           uint32_t* out, cudaStream_t st) {
  const long long per_block = static_cast<long long>(THREADS) * per_thread;
  long long blocks = (items + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(p, out);
  return static_cast<int>(cudaGetLastError());
}

template <int OP, bool HD>
int launch_form(const RowsParams& p, uint32_t* out, cudaStream_t st) {
  const long long n4 = p.n_words / 4;
  if (p.n_leaves <= 2)
    return launch(tree_rows_form_kernel<OP, HD, 2, 4>, p, n4, 4, out, st);
  if (p.n_leaves <= 4)
    return launch(tree_rows_form_kernel<OP, HD, 4, 4>, p, n4, 4, out, st);
  if (p.n_leaves <= 8)
    return launch(tree_rows_form_kernel<OP, HD, 8, 2>, p, n4, 2, out, st);
  return launch(tree_rows_form_kernel<OP, HD, 16, 1>, p, n4, 1, out, st);
}

template <bool HD>
int launch_op(int op, const RowsParams& p, uint32_t* out, cudaStream_t st) {
  switch (op) {
    case pilosa::OP_AND: return launch_form<pilosa::OP_AND, HD>(p, out, st);
    case pilosa::OP_OR: return launch_form<pilosa::OP_OR, HD>(p, out, st);
    default: return launch_form<pilosa::OP_XOR, HD>(p, out, st);
  }
}

template <typename T>
int launch_general(int depth, const RowsParams& p, uint32_t* out,
                   cudaStream_t st) {
  const long long n = p.n_words / pilosa::kWords<T>;
  if (depth <= 4) return launch(tree_rows_general_kernel<T, 4, 2>, p, n, 2, out, st);
  return launch(tree_rows_general_kernel<T, 8, 2>, p, n, 2, out, st);
}

// Programs deeper than 8 run one word a lane: 16 slots of 16-byte groups
// would not stay in registers (ptxas spilled them).
int launch_deep(const RowsParams& p, uint32_t* out, cudaStream_t st) {
  return launch(tree_rows_general_kernel<uint32_t, 16, 2>, p, p.n_words, 2, out, st);
}

}  // namespace

// form: 0 general, 1 chain, 2 head-diff. leaves: host array of n_leaves
// device pointers (a form's leaves in fold order, the head first; the
// general form's by leaf index). op: the fold's OP_AND/OP_OR/OP_XOR
// (forms). xor_mask: xored into a form's result. code/n_ops/salt: the
// general form's program. out: device int32[n_words]. vec: 1 when
// n_words % 4 == 0 and every pointer is 16-byte aligned (forms need it).
// Returns the launch's cudaError_t.
extern "C" int tree_rows_launch(const void* const* leaves, int n_leaves,
                                int form, int op, uint32_t xor_mask,
                                uint32_t salt, const int* code, int n_ops,
                                long long n_words, int vec, void* out,
                                void* stream) {
  if (n_leaves < 1 || n_leaves > pilosa::MAX_LEAVES || n_words < 1 ||
      (vec && n_words % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  RowsParams p{};
  for (int l = 0; l < n_leaves; ++l)
    p.leaves[l] = static_cast<const uint32_t*>(leaves[l]);
  p.n_leaves = n_leaves;
  p.xor_mask = xor_mask;
  p.salt = salt;
  p.n_words = n_words;
  auto st = static_cast<cudaStream_t>(stream);
  auto o = static_cast<uint32_t*>(out);
  if (form == FORM_CHAIN || form == FORM_HEAD_DIFF) {
    if (!vec || (op != pilosa::OP_AND && op != pilosa::OP_OR &&
                 op != pilosa::OP_XOR) ||
        (form == FORM_HEAD_DIFF && n_leaves < 2))
      return static_cast<int>(cudaErrorInvalidValue);
    return form == FORM_CHAIN ? launch_op<false>(op, p, o, st)
                              : launch_op<true>(op, p, o, st);
  }
  if (form != FORM_GENERAL || !pilosa::valid_program(code, n_ops, n_leaves))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_ops; ++i) p.code[i] = code[i];
  p.n_ops = n_ops;
  const int depth = pilosa::stack_depth(code, n_ops);
  if (depth > 8) return launch_deep(p, o, st);
  return vec ? launch_general<uint4>(depth, p, o, st)
             : launch_general<uint32_t>(depth, p, o, st);
}

extern "C" const char* tree_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
