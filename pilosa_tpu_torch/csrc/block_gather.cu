// K10 block_gather: compact the listed 4 KiB blocks of a flat leaf.
//
// Replaces pilosa_tpu/storage/residency.py::_gather_blocks (:79-82), the
// jitted ``arr.reshape(-1, block_words)[idx]`` that demotes a sparse
// dense leaf to the compressed tier: out[j, :] = flat[idx[j] * 1024 :
// idx[j] * 1024 + 1024] for every j of the padded index list. Padding
// repeats a real index, so out's padding rows copy a real block again.
//
// Bound on an H100: the launch. The kernel reads and writes nb_padded x
// 4 KiB (4 MiB for a 1024-shard month leaf's 512 blocks: 1.3 us at
// 3.35 TB/s), below the ~10 us a launch costs from the host.
//
// Design: one warp a compacted block, 8 warps a thread block. A warp
// reads its index once, then copies the 4 KiB as 8 rounds of 16-byte
// loads and stores, lane l on uint4 l + 32 k, so each round moves 512
// contiguous bytes. An index outside [0, n_blocks) yields a zero block.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_VECS = 1024 / 4;  // uint4 in a 4 KiB block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

__global__ void __launch_bounds__(THREADS)
block_gather_kernel(const uint4* __restrict__ flat,
                    const int32_t* __restrict__ idx, uint4* __restrict__ out,
                    long long n_blocks, long long n_out) {
  const long long j = static_cast<long long>(blockIdx.x) * WARPS +
                      (threadIdx.x >> 5);
  if (j >= n_out) return;
  const int lane = threadIdx.x & 31;
  const long long b = __ldg(idx + j);
  const bool valid = b >= 0 && b < n_blocks;
  const uint4* src = flat + b * BLOCK_VECS;
  uint4* dst = out + j * BLOCK_VECS;
#pragma unroll
  for (int k = 0; k < BLOCK_VECS / 32; ++k) {
    const int v = lane + 32 * k;
    dst[v] = valid ? __ldg(src + v) : make_uint4(0, 0, 0, 0);
  }
}

}  // namespace

// flat: device int32[n_blocks * 1024]; idx: device int32[n_out]; out:
// device int32[n_out, 1024]; all 16-byte aligned. Returns the launch's
// cudaError_t.
extern "C" int block_gather_launch(const void* flat, const void* idx,
                                   void* out, long long n_blocks,
                                   long long n_out, void* stream) {
  if (n_blocks < 1 || n_out < 1 || n_out > 0x7fffffffLL * WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (n_out + WARPS - 1) / WARPS;
  block_gather_kernel<<<static_cast<unsigned>(grid), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(flat), static_cast<const int32_t*>(idx),
      static_cast<uint4*>(out), n_blocks, n_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* block_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
