// The postfix bitwise programs of K1 (tree_count.cu) and K2
// (tree_rows.cu), and the evaluation both kernels share.
//
// A query's bitmap tree (executor/expr.py) compiles to a short postfix
// program over up to MAX_LEAVES leaves. Each instruction is one int:
// opcode in the low 8 bits, argument (a leaf index) above them. The
// wrapper (kernels.classify_program) sorts a program into one of three
// forms on the host:
//   - chain: a left fold of one op (and, or, xor) over n <= 16 leaves,
//   - head-diff: head & ~(fold of one op over n - 1 <= 15 leaves), which
//     is also a left-deep chain of diffs (a - b - c = a & ~(b | c)),
//   - general: any other program,
// the two folds followed by an xor with a mask (OP_NOT and OP_SALT after
// the root compose to one xor). eval_form evaluates a fold over R
// 16-byte groups a thread, issuing every leaf load of the step through a
// fully unrolled, guarded loop before any operation, so a thread keeps N
// x R loads in flight. eval_general interprets any program with its
// operand stack held as D registers that a push or a binary op shifts at
// compile-time positions: no stack lives in local memory. Words are the
// uint32 bit patterns that PyTorch holds as int32.
#pragma once

#include "words.cuh"

namespace pilosa {

constexpr int MAX_BATCH = 16;   // queries per launch (Executor.MICROBATCH_MAX)
constexpr int MAX_LEAVES = 16;  // leaves per query
constexpr int MAX_OPS = 64;     // instructions per program
constexpr int MAX_STACK = 16;   // operand stack depth

// Opcodes; pilosa_tpu_torch/kernels.py holds the same numbers.
enum Op : int {
  OP_LEAF = 1,  // push leaves[arg][w]
  OP_ZERO = 2,  // push 0
  OP_AND = 3,   // a & b
  OP_OR = 4,    // a | b
  OP_XOR = 5,   // a ^ b
  OP_DIFF = 6,  // a & ~b
  OP_SALT = 7,  // top ^= salt of the query
  OP_NOT = 8,   // top = ~top
};

// Forms (kernels.FORM_*).
constexpr int FORM_GENERAL = 0;
constexpr int FORM_CHAIN = 1;
constexpr int FORM_HEAD_DIFF = 2;

template <int OP>
__device__ __forceinline__ uint4 fold(uint4 a, uint4 b) {
  if constexpr (OP == OP_AND) return a & b;
  if constexpr (OP == OP_OR) return a | b;
  return a ^ b;  // OP_XOR
}

template <typename T>
__device__ __forceinline__ T apply_op(int op, T a, T b) {
  switch (op) {
    case OP_AND: return a & b;
    case OP_OR: return a | b;
    case OP_XOR: return a ^ b;
    default: return a & ~b;  // OP_DIFF
  }
}

// A chain or head-diff form over the 16-byte groups base + r * stride
// (r < R) of its n_leaves <= N leaves (in fold order, the head first);
// groups at or past `end` read as zero. The xor mask is the caller's.
template <int OP, bool HEAD_DIFF, int N, int R>
__device__ __forceinline__ void eval_form(const uint32_t* const* leaves,
                                          int n_leaves, long long base,
                                          long long stride, long long end,
                                          uint4 (&out)[R]) {
  uint4 v[N][R];
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long i = base + r * stride;
      v[j][r] = (j < n_leaves && i < end) ? load_word(leaves[j], 4 * i, uint4())
                                          : make_uint4(0, 0, 0, 0);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    constexpr int first = HEAD_DIFF ? 1 : 0;
    uint4 acc = v[first][r];
#pragma unroll
    for (int j = first + 1; j < N; ++j)
      if (j < n_leaves) acc = fold<OP>(acc, v[j][r]);
    if constexpr (HEAD_DIFF) acc = v[0][r] & ~acc;
    out[r] = acc;
  }
}

// Any valid program over the elements base + r * stride (r < R, an
// element one word or a 16-byte group); elements at or past `end` read
// as zero. The operand stack is D registers, top at st[0]: a push shifts
// every slot up one, a binary op combines st[1] and st[0] and shifts the
// rest down; every index is a compile-time constant after unrolling.
template <typename T, int D, int R>
__device__ __forceinline__ void eval_general(const int* code, int n_ops,
                                             const uint32_t* const* leaves,
                                             uint32_t salt, long long base,
                                             long long stride, long long end,
                                             T (&out)[R]) {
  constexpr int KW = kWords<T>;
  const T zero = splat(0u, T());
  T st[D][R];
#pragma unroll
  for (int k = 0; k < D; ++k)
#pragma unroll
    for (int r = 0; r < R; ++r) st[k][r] = zero;
  for (int i = 0; i < n_ops; ++i) {
    const int c = code[i];
    const int op = c & 0xff;
    if (op == OP_LEAF || op == OP_ZERO) {
#pragma unroll
      for (int k = D - 1; k > 0; --k)
#pragma unroll
        for (int r = 0; r < R; ++r) st[k][r] = st[k - 1][r];
      const uint32_t* leaf = op == OP_LEAF ? leaves[c >> 8] : nullptr;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const long long e = base + r * stride;
        st[0][r] = (leaf != nullptr && e < end) ? load_word(leaf, KW * e, T())
                                                : zero;
      }
    } else if (op == OP_SALT || op == OP_NOT) {
      const T m = splat(op == OP_SALT ? salt : ~0u, T());
#pragma unroll
      for (int r = 0; r < R; ++r) st[0][r] = st[0][r] ^ m;
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) st[0][r] = apply_op(op, st[1][r], st[0][r]);
#pragma unroll
      for (int k = 1; k < D - 1; ++k)
#pragma unroll
        for (int r = 0; r < R; ++r) st[k][r] = st[k + 1][r];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = st[0][r];
}

// Host-side check of a program before it reaches the card: every leaf
// index in range, no stack underflow or overflow, exactly one result.
inline bool valid_program(const int* code, int n_ops, int n_leaves) {
  if (n_ops < 1 || n_ops > MAX_OPS) return false;
  int sp = 0;
  for (int i = 0; i < n_ops; ++i) {
    const int op = code[i] & 0xff;
    const int arg = code[i] >> 8;
    if (op == OP_LEAF) {
      if (arg < 0 || arg >= n_leaves || ++sp > MAX_STACK) return false;
    } else if (op == OP_ZERO) {
      if (++sp > MAX_STACK) return false;
    } else if (op == OP_SALT || op == OP_NOT) {
      if (sp < 1) return false;
    } else if (op >= OP_AND && op <= OP_DIFF) {
      if (--sp < 1) return false;
    } else {
      return false;
    }
  }
  return sp == 1;
}

// The deepest a valid program's stack gets.
inline int stack_depth(const int* code, int n_ops) {
  int sp = 0, deepest = 0;
  for (int i = 0; i < n_ops; ++i) {
    const int op = code[i] & 0xff;
    if (op == OP_LEAF || op == OP_ZERO) ++sp;
    else if (op >= OP_AND && op <= OP_DIFF) --sp;
    if (sp > deepest) deepest = sp;
  }
  return deepest;
}

}  // namespace pilosa
