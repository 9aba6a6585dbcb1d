// K13 lane_fold: the decode side of a mesh's inter-group hop, the fold
// every receiver runs over the gathered lanes.
//
// Replaces the folds of pilosa_tpu/parallel/reduction.py::
// hier_split_channels (:211-222: jnp.sum of the all-gathered lanes
// widened to int32) and gather_extreme (:225-233: jnp.max / jnp.min of
// them), and on the flat mesh parallel/dist.py's psum over the members
// (:136-142), whose lanes are the members' own int32 partials.
//
// mode 0 (split channels): lo lanes [G, N] (uint8, uint16 or int32) and
//   hi lanes [G, N] widened to int32 and summed over G (modulo 2^32, as
//   an int32 psum): out int32[2, N], lo channel then hi channel.
// mode 1 / 2 (extremum, max / min): lanes [G, N] of uint8, uint16, int32
//   or int64, widened (zero-extended for the unsigned lanes) to int32,
//   or int64 for int64 lanes, and folded: out [N].
// A lane row of G may be strided (row stride in elements), so a flat
// mesh folds its members' [M, 2, N] partials in place.
//
// Bound on an H100: memory. Each lane is read once and the result
// written once: (G * N * (lo + hi bytes) + 2 * N * 4) / 3.35 TB/s, far
// under the launch floor at the mesh's shapes.
//
// Design: one output element per thread, a loop over the G lanes (G <= 8
// on the port's meshes); neighbouring threads read neighbouring lane
// elements.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ int32_t widen32(T v) {
  return static_cast<int32_t>(v);  // uint8/uint16 zero-extend
}

template <typename TL, typename TH>
__global__ void __launch_bounds__(THREADS)
fold_sum(const TL* __restrict__ lo, long long lo_stride,
         const TH* __restrict__ hi, long long hi_stride, int groups,
         long long n, int32_t* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i >= n) return;
  uint32_t sl = 0, sh = 0;
  for (int g = 0; g < groups; ++g) {
    sl += static_cast<uint32_t>(widen32(lo[g * lo_stride + i]));
    sh += static_cast<uint32_t>(widen32(hi[g * hi_stride + i]));
  }
  out[i] = static_cast<int32_t>(sl);
  out[n + i] = static_cast<int32_t>(sh);
}

template <typename TI, typename TO, bool MAX>
__global__ void __launch_bounds__(THREADS)
fold_best(const TI* __restrict__ lanes, long long stride, int groups,
          long long n, TO* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i >= n) return;
  TO best = static_cast<TO>(lanes[i]);
  for (int g = 1; g < groups; ++g) {
    const TO v = static_cast<TO>(lanes[g * stride + i]);
    best = MAX ? (v > best ? v : best) : (v < best ? v : best);
  }
  out[i] = best;
}

template <typename TL, typename TH>
int launch_sum(const void* lo, long long lo_stride, const void* hi,
               long long hi_stride, int groups, long long n, void* out,
               unsigned blocks, cudaStream_t s) {
  fold_sum<TL, TH><<<blocks, THREADS, 0, s>>>(
      static_cast<const TL*>(lo), lo_stride, static_cast<const TH*>(hi),
      hi_stride, groups, n, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename TL>
int launch_sum_hi(const void* lo, long long lo_stride, const void* hi,
                  int hi_bytes, long long hi_stride, int groups, long long n,
                  void* out, unsigned blocks, cudaStream_t s) {
  switch (hi_bytes) {
    case 1: return launch_sum<TL, uint8_t>(lo, lo_stride, hi, hi_stride,
                                           groups, n, out, blocks, s);
    case 2: return launch_sum<TL, uint16_t>(lo, lo_stride, hi, hi_stride,
                                            groups, n, out, blocks, s);
    case 4: return launch_sum<TL, int32_t>(lo, lo_stride, hi, hi_stride,
                                           groups, n, out, blocks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TI, typename TO>
int launch_best(const void* lanes, long long stride, int groups, long long n,
                void* out, bool want_max, unsigned blocks, cudaStream_t s) {
  if (want_max)
    fold_best<TI, TO, true><<<blocks, THREADS, 0, s>>>(
        static_cast<const TI*>(lanes), stride, groups, n,
        static_cast<TO*>(out));
  else
    fold_best<TI, TO, false><<<blocks, THREADS, 0, s>>>(
        static_cast<const TI*>(lanes), stride, groups, n,
        static_cast<TO*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode 0: lo / hi device lanes of lo_bytes / hi_bytes (1 uint8, 2
// uint16, 4 int32), lane g of lo at lo + g * lo_stride elements; out
// device int32[2, n]. Modes 1 (max) and 2 (min): lo holds the lanes
// (lo_bytes 1, 2, 4 or 8), hi is unused; out is int32[n], or int64[n]
// for 8-byte lanes. Returns the launch's cudaError_t.
extern "C" int lane_fold_launch(const void* lo, int lo_bytes,
                                long long lo_stride, const void* hi,
                                int hi_bytes, long long hi_stride, int mode,
                                int groups, long long n, void* out,
                                void* stream) {
  if (groups < 1 || n < 1 || lo_stride < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned b = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    if (hi_stride < n) return static_cast<int>(cudaErrorInvalidValue);
    switch (lo_bytes) {
      case 1: return launch_sum_hi<uint8_t>(lo, lo_stride, hi, hi_bytes,
                                            hi_stride, groups, n, out, b, s);
      case 2: return launch_sum_hi<uint16_t>(lo, lo_stride, hi, hi_bytes,
                                             hi_stride, groups, n, out, b, s);
      case 4: return launch_sum_hi<int32_t>(lo, lo_stride, hi, hi_bytes,
                                            hi_stride, groups, n, out, b, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode != 1 && mode != 2) return static_cast<int>(cudaErrorInvalidValue);
  const bool want_max = mode == 1;
  switch (lo_bytes) {
    case 1: return launch_best<uint8_t, int32_t>(lo, lo_stride, groups, n,
                                                 out, want_max, b, s);
    case 2: return launch_best<uint16_t, int32_t>(lo, lo_stride, groups, n,
                                                  out, want_max, b, s);
    case 4: return launch_best<int32_t, int32_t>(lo, lo_stride, groups, n,
                                                 out, want_max, b, s);
    case 8: return launch_best<int64_t, int64_t>(lo, lo_stride, groups, n,
                                                 out, want_max, b, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* lane_fold_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
