// K12 lane_pack: the encode side of a hierarchical mesh's inter-group
// hop, every group in one launch.
//
// Replaces pilosa_tpu/parallel/reduction.py::hier_split_channels and
// gather_extreme (:211-233) up to their all_gather, with the intra-group
// psum/pmax that parallel/dist.py::_dist_body runs before them
// (:136-207): members m = g*per .. (g+1)*per-1 form group g.
//
// mode 0 (split channels): parts int32[M, 2, N] (each member's lo and
//   hi split-sum channels); lane g of lo_out is the exact int32 sum of
//   its members' lo channels cast to the lo lane's type, the same for
//   hi. The lane types are uint8, uint16 or int32 (1, 2, 4 bytes), the
//   narrowest that split_channel_bounds(group_slots) proves lossless,
//   so the cast is exact; a value past its bound would wrap modulo the
//   lane width, as the reference's astype does.
// mode 1 / 2 (extremum, max / min): parts [M, N] of int32 or int64;
//   lane g of lo_out is the best of its members, cast to the lane type
//   (uint8, uint16, int32 or int64: narrowed only where the caller's
//   bound proves it lossless).
//
// On one card the gather between groups is this kernel's own write
// into the shared gather buffer lo_out / hi_out, [G, N] each.
//
// Bound on an H100: memory. Each partial is read once and each lane
// written once: (M * 2 * N * 4 + G * N * (lo + hi bytes)) / 3.35 TB/s,
// well under the launch floor at the mesh's shapes (N of 1 to a few
// thousand). Sums and compares are far below the integer rate.
//
// Design: blockIdx.y is the group, blockIdx.x a tile of THREADS lane
// elements, one output element per thread; the group's members are
// summed in a loop (per <= 8 on the port's meshes). Reads of one member
// channel are coalesced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename TL, typename TH>
__global__ void __launch_bounds__(THREADS)
pack_sum(const int32_t* __restrict__ parts, TL* __restrict__ lo,
         TH* __restrict__ hi, int per, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i >= n) return;
  const long long g = blockIdx.y;
  const int32_t* p = parts + g * per * 2 * n;
  uint32_t sl = 0, sh = 0;  // int32 adds modulo 2^32, as the psum's
  for (int m = 0; m < per; ++m) {
    sl += static_cast<uint32_t>(__ldg(p + (2LL * m) * n + i));
    sh += static_cast<uint32_t>(__ldg(p + (2LL * m + 1) * n + i));
  }
  lo[g * n + i] = static_cast<TL>(sl);
  hi[g * n + i] = static_cast<TH>(sh);
}

template <typename TI, typename TO, bool MAX>
__global__ void __launch_bounds__(THREADS)
pack_best(const TI* __restrict__ parts, TO* __restrict__ out, int per,
          long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i >= n) return;
  const long long g = blockIdx.y;
  const TI* p = parts + g * per * n;
  TI best = p[i];
  for (int m = 1; m < per; ++m) {
    const TI v = p[m * n + i];
    best = MAX ? (v > best ? v : best) : (v < best ? v : best);
  }
  out[g * n + i] = static_cast<TO>(best);
}

template <typename TL, typename TH>
int launch_sum(const void* parts, void* lo, void* hi, int per, dim3 grid,
               long long n, cudaStream_t s) {
  pack_sum<TL, TH><<<grid, THREADS, 0, s>>>(
      static_cast<const int32_t*>(parts), static_cast<TL*>(lo),
      static_cast<TH*>(hi), per, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename TL>
int launch_sum_hi(const void* parts, void* lo, void* hi, int hi_bytes,
                  int per, dim3 grid, long long n, cudaStream_t s) {
  switch (hi_bytes) {
    case 1: return launch_sum<TL, uint8_t>(parts, lo, hi, per, grid, n, s);
    case 2: return launch_sum<TL, uint16_t>(parts, lo, hi, per, grid, n, s);
    case 4: return launch_sum<TL, int32_t>(parts, lo, hi, per, grid, n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TI, typename TO>
int launch_best(const void* parts, void* out, bool want_max, int per,
                dim3 grid, long long n, cudaStream_t s) {
  if (want_max)
    pack_best<TI, TO, true><<<grid, THREADS, 0, s>>>(
        static_cast<const TI*>(parts), static_cast<TO*>(out), per, n);
  else
    pack_best<TI, TO, false><<<grid, THREADS, 0, s>>>(
        static_cast<const TI*>(parts), static_cast<TO*>(out), per, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI>
int launch_best_out(const void* parts, void* out, int out_bytes,
                    bool want_max, int per, dim3 grid, long long n,
                    cudaStream_t s) {
  switch (out_bytes) {
    case 1: return launch_best<TI, uint8_t>(parts, out, want_max, per, grid,
                                            n, s);
    case 2: return launch_best<TI, uint16_t>(parts, out, want_max, per, grid,
                                             n, s);
    case 4: return launch_best<TI, int32_t>(parts, out, want_max, per, grid,
                                            n, s);
    case 8: return launch_best<TI, int64_t>(parts, out, want_max, per, grid,
                                            n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// parts: device [members, 2, n] int32 (mode 0) or [members, n] of
// in_bytes 4 (int32) or 8 (int64) (modes 1 max, 2 min); lo_out / hi_out:
// device [groups, n] lanes of lo_bytes / hi_bytes (1 uint8, 2 uint16, 4
// int32, 8 int64; hi_out unused outside mode 0). members is a multiple
// of groups. Returns the launch's cudaError_t.
extern "C" int lane_pack_launch(const void* parts, int in_bytes, void* lo_out,
                                int lo_bytes, void* hi_out, int hi_bytes,
                                int mode, int members, int groups,
                                long long n, void* stream) {
  if (members < 1 || groups < 1 || groups > 65535 || members % groups ||
      n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + THREADS - 1) / THREADS;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int per = members / groups;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(groups));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    if (in_bytes != 4) return static_cast<int>(cudaErrorInvalidValue);
    switch (lo_bytes) {
      case 1: return launch_sum_hi<uint8_t>(parts, lo_out, hi_out, hi_bytes,
                                            per, grid, n, s);
      case 2: return launch_sum_hi<uint16_t>(parts, lo_out, hi_out, hi_bytes,
                                             per, grid, n, s);
      case 4: return launch_sum_hi<int32_t>(parts, lo_out, hi_out, hi_bytes,
                                            per, grid, n, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode != 1 && mode != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (in_bytes == 4)
    return launch_best_out<int32_t>(parts, lo_out, lo_bytes, mode == 1, per,
                                    grid, n, s);
  if (in_bytes == 8)
    return launch_best_out<int64_t>(parts, lo_out, lo_bytes, mode == 1, per,
                                    grid, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* lane_pack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
