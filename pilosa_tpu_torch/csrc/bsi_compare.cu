// K5 bsi_compare: the rows of columns whose bit-sliced value compares
// true against a predicate.
//
// Replaces pilosa_tpu/executor/expr.py::_bsi_compare (:114-144), the
// 'bsicmp' node vmapped per shard: for each column, walk the value's bit
// planes MSB first keeping eq / lt / gt masks, then pick the mask of the
// operator (<, <=, >, >=, ==, !=) against the offset-encoded predicate
// (the executor subtracts the field's base and clamps the range first).
// The exists operand is a separate [S, W] row (the bsig view's row 0
// leaf, as the reference compiles it), not row 0 of the planes.
//
// Bound on an H100: memory. The exists row and each of the d planes are
// read once and the result written once: (d + 2) x S x W x 4 bytes /
// 3.35 TB/s, 0.88 ms at d = 20 over 1024 shards. A few logic operations
// per word and plane are far below the integer rate.
//
// Design: blockIdx.y is the shard, blockIdx.x a tile of words in it;
// each thread takes one 16-byte group (or one word when the row is not
// 16-byte aligned) and keeps eq / lt / gt in registers through the plane
// loop, so nothing but the result reaches device memory. The predicate
// bit of each plane is the same for every thread: no divergence.
#include <climits>

#include "words.cuh"

namespace {

constexpr int THREADS = 256;

enum CmpOp : int { LT = 0, LE = 1, GT = 2, GE = 3, EQ = 4, NE = 5 };

template <typename T>
__global__ void __launch_bounds__(THREADS)
bsi_compare_kernel(const uint32_t* __restrict__ planes,
                   const uint32_t* __restrict__ exists,
                   uint32_t* __restrict__ out, long long row_words,
                   int depth, unsigned long long pred, int op) {
  const long long w = (static_cast<long long>(blockIdx.x) * THREADS +
                       threadIdx.x) * pilosa::kWords<T>;
  if (w >= row_words) return;
  const long long s = blockIdx.y;
  const uint32_t* shard_planes = planes + s * (2 + depth) * row_words;
  const T e = pilosa::load_word(exists + s * row_words, w, T());
  T eq = e;
  T lt = pilosa::splat(0u, T());
  T gt = lt;
  for (int i = depth - 1; i >= 0; --i) {
    const T p = pilosa::load_word(shard_planes + (2LL + i) * row_words, w,
                                  T());
    if ((pred >> i) & 1ULL) {
      lt = lt | (eq & ~p);
      eq = eq & p;
    } else {
      gt = gt | (eq & p);
      eq = eq & ~p;
    }
  }
  T r;
  switch (op) {
    case LT: r = lt; break;
    case LE: r = lt | eq; break;
    case GT: r = gt; break;
    case GE: r = gt | eq; break;
    case EQ: r = eq; break;
    default: r = e & ~eq; break;  // NE
  }
  pilosa::store_word(out + s * row_words, w, r);
}

}  // namespace

// planes: device int32[n_shards, 2 + depth, row_words]; exists, out:
// device int32[n_shards, row_words]; pred: the offset-encoded predicate;
// op: 0 <, 1 <=, 2 >, 3 >=, 4 ==, 5 !=; vec: 1 when row_words % 4 == 0
// and every pointer is 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int bsi_compare_launch(const void* planes, const void* exists,
                                  void* out, long long n_shards,
                                  long long row_words, int depth,
                                  unsigned long long pred, int op, int vec,
                                  void* stream) {
  if (n_shards < 1 || n_shards > 65535 || row_words < 1 || depth < 0 ||
      depth > 63 || op < 0 || op > 5 || (vec && row_words % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = vec ? row_words / 4 : row_words;
  const long long tiles = (items + THREADS - 1) / THREADS;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(n_shards));
  auto st = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const uint32_t*>(planes);
  auto e = static_cast<const uint32_t*>(exists);
  auto o = static_cast<uint32_t*>(out);
  if (vec)
    bsi_compare_kernel<uint4><<<grid, THREADS, 0, st>>>(p, e, o, row_words,
                                                         depth, pred, op);
  else
    bsi_compare_kernel<uint32_t><<<grid, THREADS, 0, st>>>(p, e, o, row_words,
                                                            depth, pred, op);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bsi_compare_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
