// K4 row_shift: shift every row's bits by n positions, rows independent.
//
// Replaces pilosa_tpu/ops/bitops.py::shift (:26-62), which
// executor/expr.py::_go inlines for the 'shift' node (:78-82) and
// batch.py vmaps per shard: out[s, w] = (in[s, w - ws] << b) |
// (in[s, w - ws - 1] >> (32 - b)), with n = 32 ws + b (floor division,
// so b is in [0, 32) for negative n too) and words outside the row read
// as zero. No bit crosses from one shard's row into the next; a zero
// padding row stays zero. For a negative shift the top word's spill-over
// lands at word W + ws, which the same formula gives (the reference's
// tail word, :55-62).
//
// Bound on an H100: memory. Each word is read once and written once, so
// the least time is 2 x words x 4 bytes / 3.35 TB/s: 80 us for
// int32[1024, 32768] (2 x 128 MiB). One shift and an OR per word are far
// below the integer rate.
//
// Design: blockIdx.y is the row, blockIdx.x a tile of THREADS words in
// it, one output word per thread, so no thread divides a flat index.
// Neighbouring threads read neighbouring words (coalesced); the second,
// shifted read of each word hits L1 or L2.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
row_shift_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 long long row_words, long long word_shift, int bit_shift) {
  const long long w = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (w >= row_words) return;
  const long long base = static_cast<long long>(blockIdx.y) * row_words;
  const long long src = w - word_shift;
  uint32_t v = 0;
  if (src >= 0 && src < row_words) v = __ldg(in + base + src) << bit_shift;
  if (bit_shift != 0 && src >= 1 && src <= row_words)
    v |= __ldg(in + base + src - 1) >> (32 - bit_shift);
  out[base + w] = v;
}

}  // namespace

// in, out: device int32[n_rows, row_words] (distinct buffers); n = 32 x
// word_shift + bit_shift, bit_shift in [0, 32). Returns the launch's
// cudaError_t.
extern "C" int row_shift_launch(const void* in, void* out, long long n_rows,
                                long long row_words, long long word_shift,
                                int bit_shift, void* stream) {
  if (n_rows < 1 || n_rows > 65535 || row_words < 1 || bit_shift < 0 ||
      bit_shift > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (row_words + THREADS - 1) / THREADS;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(n_rows));
  row_shift_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      row_words, word_shift, bit_shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* row_shift_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
