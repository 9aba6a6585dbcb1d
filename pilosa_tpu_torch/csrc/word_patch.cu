// K3 word_patch: OR or AND-NOT sparse word masks into a batch of rows, in
// place, in one launch.
//
// Replaces pilosa_tpu/executor/batch.py::_or_delta / _andnot_delta and
// their _row forms (:195-220), the write patch that a Set/Clear/import
// applies to every resident stacked leaf holding the written shard. The
// JAX version scatters (word_idx, mask) pairs into a zero delta with an
// unsigned .at[].max, padding with (0, 0), and builds a new array, one
// program per (leaf, shard slot, row). Here one write request's patches
// of every resident leaf arrive together: T targets, each a row pointer,
// a direction (OR, or AND-NOT) and a run of host-deduplicated (word,
// mask) pairs with their real count, so no pad reaches the card (under
// an int32 view a real mask with bit 31 set would lose a max against a
// pad's 0). The executor flushes any pending micro-batch holding a leaf
// before its patch is collected, and stream order keeps launched work
// correct.
//
// Bound on an H100: launch latency. N pairs read 8 bytes each and
// read-modify-write 4 bytes of a row each: 16 x N bytes / 3.35 TB/s, a
// few nanoseconds for a Set and 5 ns for a 1024-pair patch, far under
// the few microseconds a launch costs. So the design spends launches,
// not bytes: one launch (and one host-to-device copy, from a pinned
// staging buffer the wrapper keeps) per batch, whatever T is, where the
// port used to launch once per (leaf, shard, row) with a fresh pinned
// allocation each time. word_patch_empty_launch is the launch floor the
// wrapper's path is held against.
//
// Design: one thread per pair, grid-stride. A thread finds its target by
// a binary search over the T + 1 run offsets (cached loads). A target's
// word indices are unique and the batch holds each row at most once, so
// no two threads touch one word and no atomics are needed.
//
// The staged batch is one byte blob, laid out as the wrapper packs it:
//   int64 rows[T]     device address of each target's first row word
//   int32 offs[T + 1] run starts in the pair arrays, offs[T] = N
//   int32 clear[T]    1: AND-NOT, 0: OR
//   int32 word[N]     word index of each pair within its row
//   uint32 mask[N]    its mask
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;

struct Batch {
  const uint64_t* rows;
  const int* offs;
  const int* clear;
  const int* word;
  const uint32_t* mask;
};

__device__ inline Batch unpack(const unsigned char* blob, int n_targets,
                               int n_pairs) {
  Batch b;
  b.rows = reinterpret_cast<const uint64_t*>(blob);
  b.offs = reinterpret_cast<const int*>(blob + 8 * n_targets);
  b.clear = b.offs + n_targets + 1;
  b.word = b.clear + n_targets;
  b.mask = reinterpret_cast<const uint32_t*>(b.word + n_pairs);
  return b;
}

__global__ void __launch_bounds__(THREADS)
word_patch_kernel(const unsigned char* __restrict__ blob, int n_targets,
                  int n_pairs) {
  const Batch b = unpack(blob, n_targets, n_pairs);
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n_pairs;
       i += gridDim.x * THREADS) {
    // the last target whose run starts at or before pair i
    int lo = 0, hi = n_targets - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (b.offs[mid] <= i) lo = mid; else hi = mid - 1;
    }
    uint32_t* word = reinterpret_cast<uint32_t*>(b.rows[lo]) + b.word[i];
    const uint32_t m = b.mask[i];
    *word = b.clear[lo] ? (*word & ~m) : (*word | m);
  }
}

__global__ void empty_kernel() {}

int blocks_for(int n_pairs) {
  const int blocks = (n_pairs + THREADS - 1) / THREADS;
  return blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS;
}

}  // namespace

// host_blob: the batch in pinned host memory (layout above), every row
// address, word index and run checked by the caller; it is copied into
// dev_blob, then the kernel launched behind the copy. Returns the first
// cudaError_t.
extern "C" int word_patch_staged_launch(const void* host_blob, void* dev_blob,
                                        int n_bytes, int n_targets,
                                        int n_pairs, void* stream) {
  if (n_targets < 1 || n_pairs < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(dev_blob, host_blob, n_bytes,
                                    cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  word_patch_kernel<<<blocks_for(n_pairs), THREADS, 0, s>>>(
      static_cast<const unsigned char*>(dev_blob), n_targets, n_pairs);
  return static_cast<int>(cudaGetLastError());
}

// The launch alone, on a batch already in device memory.
extern "C" int word_patch_launch(const void* blob, int n_targets, int n_pairs,
                                 void* stream) {
  if (n_targets < 1 || n_pairs < 1) return static_cast<int>(cudaErrorInvalidValue);
  word_patch_kernel<<<blocks_for(n_pairs), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(blob), n_targets, n_pairs);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel through the same C path: the launch floor.
extern "C" int word_patch_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* word_patch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
