// Word helpers shared by the port's kernels: a word is one uint32 or a
// 16-byte group of four (uint4), with the same bitwise operators, loads,
// stores and popcount for both, so one template body serves either
// width. Words are the uint32 bit patterns that PyTorch holds as int32.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ uint4 operator&(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}
__device__ __forceinline__ uint4 operator|(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint4 operator^(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
__device__ __forceinline__ uint4 operator~(uint4 a) {
  return make_uint4(~a.x, ~a.y, ~a.z, ~a.w);
}

namespace pilosa {

// Words per element of T: 1 for uint32_t, 4 for uint4.
template <typename T>
constexpr int kWords = sizeof(T) / sizeof(uint32_t);

__device__ __forceinline__ uint32_t splat(uint32_t s, uint32_t) { return s; }
__device__ __forceinline__ uint4 splat(uint32_t s, uint4) {
  return make_uint4(s, s, s, s);
}

// Read-only load of the word (group) starting at word offset w.
__device__ __forceinline__ uint32_t load_word(const uint32_t* p, long long w,
                                              uint32_t) {
  return __ldg(p + w);
}
__device__ __forceinline__ uint4 load_word(const uint32_t* p, long long w,
                                           uint4) {
  return __ldg(reinterpret_cast<const uint4*>(p + w));
}

__device__ __forceinline__ void store_word(uint32_t* p, long long w,
                                           uint32_t v) {
  p[w] = v;
}
__device__ __forceinline__ void store_word(uint32_t* p, long long w,
                                           uint4 v) {
  *reinterpret_cast<uint4*>(p + w) = v;
}

__device__ __forceinline__ bool nonzero(uint32_t v) { return v != 0; }
__device__ __forceinline__ bool nonzero(uint4 v) {
  return (v.x | v.y | v.z | v.w) != 0;
}

__device__ __forceinline__ int popc(uint32_t v) { return __popc(v); }
__device__ __forceinline__ int popc(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// Sum of v over the block (every thread must call it; blockDim.x a
// multiple of 32, at most 1024). The total is valid in thread 0.
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int warp_sums[32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // warp_sums may still be read by a previous call
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

}  // namespace pilosa
