// K14 quant_pack: the encode side of the 8-bit candidate-ranking lane,
// every group and scale block in one launch.
//
// Replaces pilosa_tpu/parallel/reduction.py::hier_quantized_counts up to
// its all_gather (:132-168), with the intra-group psum that
// parallel/dist.py runs before it (:165-175, :318-323): per group g
// (members g*per .. (g+1)*per-1) the exact int32 totals v = lo + (hi <<
// SPLIT_SHIFT) of the summed split channels, the candidates padded with
// zeros to whole QUANT_BLOCKs of 256; per block the scale
// s = max(1, (max + 254) // 255) and per candidate
// q = (v + (s >> 1)) // s as uint8, all in int32 arithmetic (floor
// division, adds modulo 2^32) as the reference's jnp program computes
// them.
//
// Bound on an H100: memory. The partials are read once and q and s
// written once: (M * 2 * R * 4 + G * nb * (256 + 4)) / 3.35 TB/s; at
// R = 65 536 and 8 members that is 1.25 us, below the launch floor.
//
// Design: one thread block per (scale block, group), one thread per
// candidate; the block's max is a warp-shuffle reduction then one pass
// over the 8 warps' maxima in shared memory. Each member channel read is
// coalesced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;  // QUANT_BLOCK: candidates a scale covers
constexpr int SHIFT = 15;   // SPLIT_SHIFT

__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  int32_t q = a / b;  // b > 0
  if ((a % b) != 0 && a < 0) --q;
  return q;
}

__global__ void __launch_bounds__(BLOCK)
quant_pack_kernel(const int32_t* __restrict__ parts, int per, long long rows,
                  uint8_t* __restrict__ q, int32_t* __restrict__ scales) {
  __shared__ int32_t warp_max[BLOCK / 32];
  const int t = threadIdx.x;
  const long long b = blockIdx.x;
  const long long g = blockIdx.y;
  const long long nb = gridDim.x;
  const long long r = b * BLOCK + t;
  int32_t v = 0;
  if (r < rows) {
    const int32_t* p = parts + g * per * 2 * rows;
    uint32_t sl = 0, sh = 0;
    for (int m = 0; m < per; ++m) {
      sl += static_cast<uint32_t>(__ldg(p + (2LL * m) * rows + r));
      sh += static_cast<uint32_t>(__ldg(p + (2LL * m + 1) * rows + r));
    }
    v = static_cast<int32_t>(sl + (sh << SHIFT));
  }
  int32_t mx = v;
  for (int o = 16; o > 0; o >>= 1) {
    const int32_t other = __shfl_xor_sync(0xffffffffu, mx, o);
    mx = other > mx ? other : mx;
  }
  if ((t & 31) == 0) warp_max[t >> 5] = mx;
  __syncthreads();
  mx = warp_max[0];
  for (int w = 1; w < BLOCK / 32; ++w) mx = warp_max[w] > mx ? warp_max[w] : mx;
  int32_t s = floordiv(static_cast<int32_t>(static_cast<uint32_t>(mx) + 254u),
                       255);
  s = s > 1 ? s : 1;
  const int32_t num =
      static_cast<int32_t>(static_cast<uint32_t>(v) +
                           static_cast<uint32_t>(s >> 1));
  q[(g * nb + b) * BLOCK + t] = static_cast<uint8_t>(floordiv(num, s));
  if (t == 0) scales[g * nb + b] = s;
}

}  // namespace

// parts: device int32[members, 2, rows] (each member's split channels);
// q: device uint8[groups, n_blocks, 256]; scales: device int32[groups,
// n_blocks], n_blocks = ceil(rows / 256). members is a multiple of
// groups. Returns the launch's cudaError_t.
extern "C" int quant_pack_launch(const void* parts, int members, int groups,
                                 long long rows, void* q, void* scales,
                                 void* stream) {
  if (members < 1 || groups < 1 || groups > 65535 || members % groups ||
      rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = (rows + BLOCK - 1) / BLOCK;
  if (nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(groups));
  quant_pack_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(parts), members / groups, rows,
      static_cast<uint8_t*>(q), static_cast<int32_t*>(scales));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quant_pack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
