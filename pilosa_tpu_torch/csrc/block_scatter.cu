// K11 block_scatter: a flat leaf from its compacted nonzero 4 KiB blocks.
//
// Replaces pilosa_tpu/storage/residency.py::_scatter_blocks (:85-90), the
// jitted ``zeros(n_blocks, 1024).at[idx].set(blocks)`` that promotes a
// compressed-tier or host-tier copy back to a dense leaf. ``idx`` is the
// padded index list: its first nb entries are the nonzero blocks,
// strictly ascending (the wrapper checks this on the host), and the
// padding repeats a real index with identical data, so the prefix alone
// decides every output block.
//
// Bound on an H100: memory. The output is written once (n_blocks x 4 KiB:
// 128 MiB for a 1024-shard leaf, 40 us at 3.35 TB/s) and each real block
// read once; the library's zeros + index_copy_ writes the output twice.
//
// Design: one pass over the dense output, no separate memset. A warp owns
// one output block: it finds the block in idx[0, nb) by a 32-way search
// (32 lanes load 32 evenly spaced pivots, a ballot narrows the range
// 32-fold, so 512 indices take two dependent loads), then writes the
// matching compacted block or zeros as 8 rounds of 16-byte stores, 512
// contiguous bytes a round. 8 warps a thread block.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_VECS = 1024 / 4;  // uint4 in a 4 KiB block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

// Position of b in the ascending idx[0, nb), or -1 (the whole warp calls
// it and gets the same answer).
__device__ __forceinline__ int find_block(const int32_t* __restrict__ idx,
                                          int nb, int b, int lane) {
  int lo = 0, hi = nb;  // b, if present, lies in [lo, hi)
  while (hi - lo > 32) {
    const long long span = hi - lo;
    const int p = lo + static_cast<int>(span * lane / 32);
    const unsigned le = __ballot_sync(FULL, __ldg(idx + p) <= b);
    const int k = __popc(le);  // pivots <= b: lanes 0 .. k-1
    if (k == 0) return -1;     // b < idx[lo]
    const int next_hi =
        k == 32 ? hi : lo + static_cast<int>(span * k / 32);
    lo += static_cast<int>(span * (k - 1) / 32);
    hi = next_hi;
  }
  const bool hit = lane < hi - lo && __ldg(idx + lo + lane) == b;
  const unsigned m = __ballot_sync(FULL, hit);
  return m ? lo + __ffs(m) - 1 : -1;
}

__global__ void __launch_bounds__(THREADS)
block_scatter_kernel(const uint4* __restrict__ blocks,
                     const int32_t* __restrict__ idx, int nb,
                     uint4* __restrict__ out, long long n_blocks) {
  const long long b = static_cast<long long>(blockIdx.x) * WARPS +
                      (threadIdx.x >> 5);
  if (b >= n_blocks) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int j = find_block(idx, nb, static_cast<int>(b), lane);
  const uint4* src = blocks + static_cast<long long>(j) * BLOCK_VECS;
  uint4* dst = out + b * BLOCK_VECS;
#pragma unroll
  for (int k = 0; k < BLOCK_VECS / 32; ++k) {
    const int v = lane + 32 * k;
    dst[v] = j >= 0 ? __ldg(src + v) : make_uint4(0, 0, 0, 0);
  }
}

}  // namespace

// blocks: device int32[nb_padded, 1024]; idx: device int32[nb_padded]
// whose first nb entries ascend strictly within [0, n_blocks); out:
// device int32[n_blocks * 1024]; all 16-byte aligned. Returns the
// launch's cudaError_t.
extern "C" int block_scatter_launch(const void* blocks, const void* idx,
                                    int nb, void* out, long long n_blocks,
                                    void* stream) {
  if (n_blocks < 1 || n_blocks > 0x7fffffffLL || nb < 0 || nb > n_blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (n_blocks + WARPS - 1) / WARPS;
  block_scatter_kernel<<<static_cast<unsigned>(grid), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(blocks), static_cast<const int32_t*>(idx),
      nb, static_cast<uint4*>(out), n_blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* block_scatter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
