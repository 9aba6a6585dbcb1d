// Postfix bitwise-program interpreter shared by tree_count.cu (K1) and
// tree_rows.cu (K2), and used by no other kernel.
//
// A query's bitmap tree (executor/expr.py) compiles to a short postfix
// program over up to MAX_LEAVES leaves. Each instruction is one int:
// opcode in the low 8 bits, argument (a leaf index) above them. The
// program sits in the kernel's parameter space and is the same for every
// thread, so the decode is a uniform constant-cache read; the operand
// stack lives in each thread's registers/local memory and holds one word
// vector per slot. Words are the uint32 bit patterns that PyTorch holds
// as int32.
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

struct TreeParams {
  const uint32_t* leaves[MAX_BATCH][MAX_LEAVES];
  uint32_t salt[MAX_BATCH];
  int code[MAX_OPS];
  int n_ops;
  int vec;               // 1: 16-byte loads (checked by the wrapper)
  long long n_words;     // words per leaf
  long long row_words;   // words per output row (K1)
  long long n_rows;      // n_words / row_words (K1)
  long long tiles_per_row;
};

template <typename T>
__device__ __forceinline__ T apply(int op, T a, T b) {
  switch (op) {
    case OP_AND: return a & b;
    case OP_OR: return a | b;
    case OP_XOR: return a ^ b;
    default: return a & ~b;  // OP_DIFF
  }
}

// Evaluates query q's program at word offset w (T = one word or four).
template <typename T>
__device__ __forceinline__ T eval_program(const TreeParams& p, int q,
                                          long long w) {
  T st[MAX_STACK];
  int sp = 0;
  for (int i = 0; i < p.n_ops; ++i) {
    const int c = p.code[i];
    const int op = c & 0xff;
    if (op == OP_LEAF) {
      st[sp++] = load_word(p.leaves[q][c >> 8], w, T());
    } else if (op == OP_ZERO) {
      st[sp++] = splat(0u, T());
    } else if (op == OP_SALT) {
      st[sp - 1] = st[sp - 1] ^ splat(p.salt[q], T());
    } else if (op == OP_NOT) {
      st[sp - 1] = ~st[sp - 1];
    } else {
      --sp;
      st[sp - 1] = apply(op, st[sp - 1], st[sp]);
    }
  }
  return st[0];
}

}  // namespace pilosa

namespace pilosa {

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

}  // namespace pilosa
