// K15 quant_fold: the decode side of the 8-bit candidate-ranking lane.
//
// Replaces pilosa_tpu/parallel/reduction.py::hier_quantized_counts after
// its all_gather (:169-175): approx[r] = sum over groups of q * s (the
// group's scale of r's block), trimmed to the R real candidates, then
// one error bound a block, err[b] = sum over groups of ((s + 1) >> 1)
// where s > 1 (0 where s == 1: such a block quantized losslessly), both
// in int32 arithmetic, packed to split form [2, R + n_blocks]
// (v & SPLIT_MASK, v >> SPLIT_SHIFT) for batch.merge_split.
//
// Bound on an H100: memory. q and the scales are read once and the
// packed result written once: (G * nb * (256 + 4) + 2 * (R + nb) * 4) /
// 3.35 TB/s, below the launch floor at every mesh shape.
//
// Design: one output element per thread, a loop over the G groups;
// neighbouring threads read neighbouring q bytes of one group.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCK = 256;  // QUANT_BLOCK
constexpr int SHIFT = 15;   // SPLIT_SHIFT
constexpr int32_t MASK = (1 << SHIFT) - 1;

__global__ void __launch_bounds__(THREADS)
quant_fold_kernel(const uint8_t* __restrict__ q,
                  const int32_t* __restrict__ scales, int groups,
                  long long rows, long long nb, int32_t* __restrict__ out) {
  const long long j = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  const long long total = rows + nb;
  if (j >= total) return;
  uint32_t v = 0;
  if (j < rows) {
    const long long b = j / BLOCK;
    for (int g = 0; g < groups; ++g)
      v += static_cast<uint32_t>(q[g * nb * BLOCK + j]) *
           static_cast<uint32_t>(__ldg(scales + g * nb + b));
  } else {
    const long long b = j - rows;
    for (int g = 0; g < groups; ++g) {
      const int32_t s = __ldg(scales + g * nb + b);
      if (s > 1)
        v += static_cast<uint32_t>(
            static_cast<int32_t>(static_cast<uint32_t>(s) + 1u) >> 1);
    }
  }
  const int32_t x = static_cast<int32_t>(v);
  out[j] = x & MASK;
  out[total + j] = x >> SHIFT;
}

}  // namespace

// q: device uint8[groups, nb, 256]; scales: device int32[groups, nb];
// out: device int32[2, rows + nb]; nb = ceil(rows / 256). Returns the
// launch's cudaError_t.
extern "C" int quant_fold_launch(const void* q, const void* scales,
                                 int groups, long long rows, long long nb,
                                 void* out, void* stream) {
  if (groups < 1 || rows < 1 || nb != (rows + BLOCK - 1) / BLOCK)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows + nb + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  quant_fold_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const int32_t*>(scales),
      groups, rows, nb, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quant_fold_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
