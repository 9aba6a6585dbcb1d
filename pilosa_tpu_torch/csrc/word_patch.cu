// K3 word_patch: OR or AND-NOT sparse word masks into one row, in place.
//
// Replaces pilosa_tpu/executor/batch.py::_or_delta / _andnot_delta
// (:195-207), the write patch that a Set/Clear/import applies to every
// resident stacked leaf holding the written shard. The JAX version
// scatters (word_idx, mask) pairs into a zero delta with an unsigned
// .at[].max, padding with (0, 0), and builds a new array. Here the pairs
// arrive host-deduplicated with their real count, so no pad ever
// reaches the card (under an int32 view a real mask with bit 31 set
// would lose a max against a pad's 0), and the row is patched in place:
// the executor flushes any pending micro-batch holding the leaf first,
// and stream order keeps launched work correct.
//
// Bound on an H100: memory and launch latency. n pairs read 8 bytes
// each and read-modify-write 4 bytes of the row each, so the least time
// is 16 x n bytes / 3.35 TB/s: a few nanoseconds for a Set (one pair),
// where the launch itself (a few microseconds) dominates.
//
// Design: one thread per pair. Word indices are unique, so no two
// threads touch one word and no atomics are needed.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
word_patch_kernel(uint32_t* __restrict__ row, const int* __restrict__ pairs,
                  int n, int clear) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t mask = static_cast<uint32_t>(pairs[n + i]);
  uint32_t* word = row + pairs[i];
  *word = clear ? (*word & ~mask) : (*word | mask);
}

}  // namespace

// row: device pointer to the first word of the patched row; pairs:
// device int32[2, n] (word indices, then masks), indices unique and
// checked in range by the caller. Returns the launch's cudaError_t.
extern "C" int word_patch_launch(void* row, const void* pairs, int n,
                                 int clear, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + THREADS - 1) / THREADS;
  word_patch_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(row), static_cast<const int*>(pairs), n, clear);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* word_patch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
