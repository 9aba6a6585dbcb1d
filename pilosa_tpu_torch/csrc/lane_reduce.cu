// K12+K13 lane_reduce: a mesh's whole reduce of its members' partials,
// the intra-group sum (or best), the narrow inter-group lane and the
// receivers' fold, in one launch that reads each member's partial where
// that member's kernel wrote it.
//
// Replaces pilosa_tpu/parallel/reduction.py::hier_split_channels and
// gather_extreme (:211-233) with the intra-group psum / pmax / pmin that
// parallel/dist.py::_dist_body runs before them (:121, :144, :188-191),
// and on the flat mesh the plain int32 psum over the members.
//
// mode 0 (split channels): each member's partial holds a lo and a hi
//   channel of n int32 elements. Group g (members g*per .. (g+1)*per-1)
//   sums each channel in uint32 (int32 adds wrap), casts the sum to its
//   lane (uint8, uint16 or int32: truncation, as astype does), and the
//   receiver widens each lane back (the unsigned ones zero-extend) and
//   sums the groups modulo 2^32: out int32[2, n], lo then hi. The flat
//   mesh is one group with int32 lanes: no narrowing.
// mode 1 / 2 (extremum, max / min): each member's partial holds n int32
//   or int64 elements; each group's best is cast to its lane (uint8,
//   uint16, int32 or int64) and widened back, and the groups' widened
//   bests are folded: out [n], int64 for an int64 lane, else int32.
//
// The lanes never exist in memory: the narrowing cast and the widening
// back are a mask or a sign extension in a register. The members'
// addresses travel by value in the launch's parameter space
// (__grid_constant__: read with constant-bank loads, no copy), and all
// members share one layout, an element stride and a channel stride in
// elements, so the executor's [2, N], [B, 2] (a transposed view), [2]
// and 0-d partials are read without a stack or a copy.
//
// Bound on an H100: memory. Each partial is read once and the result
// written once: (M * C * N * in_bytes + C * N * out_bytes) / 3.35 TB/s
// (C = 2 channels or 1), nanoseconds at the mesh's shapes: the launch
// floor bounds it.
//
// Design: one thread per output element, a grid-stride loop over n for
// the large GroupBy levels, and per element a loop over the groups and
// their members. Neighbouring threads read neighbouring elements of one
// member channel (coalesced at unit element stride).
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_MEMBERS = 64;  // kernels.LANE_MAX_MEMBERS
constexpr long long MAX_BLOCKS = 132 * 8;

struct Members {
  const void* p[MAX_MEMBERS];
};

struct Layout {
  int per;               // members a group
  int groups;
  long long n;           // elements a channel
  long long chan;        // channel stride (elements)
  long long elem;        // element stride (elements)
};

uint32_t lane_mask(int bytes) {
  return bytes >= 4 ? 0xffffffffu : (1u << (8 * bytes)) - 1u;
}

// The group's best cast to a lane of `bytes` and widened back.
__device__ __forceinline__ long long narrow(long long v, int bytes) {
  switch (bytes) {
    case 1: return static_cast<long long>(static_cast<uint8_t>(v));
    case 2: return static_cast<long long>(static_cast<uint16_t>(v));
    case 4: return static_cast<long long>(static_cast<int32_t>(v));
  }
  return v;
}

__global__ void __launch_bounds__(THREADS)
reduce_sum(const __grid_constant__ Members m, const Layout l,
           uint32_t lo_mask, uint32_t hi_mask, int32_t* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < l.n; i += step) {
    const long long at = i * l.elem;
    uint32_t tl = 0, th = 0;
    for (int g = 0; g < l.groups; ++g) {
      uint32_t sl = 0, sh = 0;
      for (int k = g * l.per; k < (g + 1) * l.per; ++k) {
        const int32_t* p = static_cast<const int32_t*>(m.p[k]) + at;
        sl += static_cast<uint32_t>(__ldg(p));
        sh += static_cast<uint32_t>(__ldg(p + l.chan));
      }
      tl += sl & lo_mask;
      th += sh & hi_mask;
    }
    out[i] = static_cast<int32_t>(tl);
    out[l.n + i] = static_cast<int32_t>(th);
  }
}

template <typename TI, bool MAX>
__global__ void __launch_bounds__(THREADS)
reduce_best(const __grid_constant__ Members m, const Layout l, int lane,
            bool out64, void* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < l.n; i += step) {
    const long long at = i * l.elem;
    long long best = 0;
    for (int g = 0; g < l.groups; ++g) {
      const int k0 = g * l.per;
      TI b = __ldg(static_cast<const TI*>(m.p[k0]) + at);
      for (int k = k0 + 1; k < k0 + l.per; ++k) {
        const TI v = __ldg(static_cast<const TI*>(m.p[k]) + at);
        b = MAX ? (v > b ? v : b) : (v < b ? v : b);
      }
      const long long w = narrow(static_cast<long long>(b), lane);
      best = g == 0 ? w : MAX ? (w > best ? w : best) : (w < best ? w : best);
    }
    if (out64)
      static_cast<long long*>(out)[i] = best;
    else
      static_cast<int32_t*>(out)[i] = static_cast<int32_t>(best);
  }
}

template <typename TI>
void launch_best(const Members& m, const Layout& l, int lane, bool want_max,
                 void* out, unsigned blocks, cudaStream_t s) {
  if (want_max)
    reduce_best<TI, true><<<blocks, THREADS, 0, s>>>(m, l, lane, lane == 8,
                                                     out);
  else
    reduce_best<TI, false><<<blocks, THREADS, 0, s>>>(m, l, lane, lane == 8,
                                                      out);
}

bool lane_ok(int bytes, bool wide) {
  return bytes == 1 || bytes == 2 || bytes == 4 || (wide && bytes == 8);
}

}  // namespace

// args: one host blob of little-endian int64s, as the wrapper packs it:
//   members, groups, in_bytes, lo_bytes, hi_bytes, mode, n, chan, elem,
//   then the device addresses of the `members` partials (at most 64),
// all of one layout: element i of channel c at address + c * chan + i *
// elem elements. mode 0: int32 partials (in_bytes 4), two channels,
// lanes of lo_bytes / hi_bytes (1, 2 or 4); out device int32[2, n].
// Modes 1 (max) and 2 (min): int32 or int64 partials (in_bytes 4 or 8),
// one channel, a lane of lo_bytes (1, 2, 4 or 8), hi_bytes unused; out
// device [n], int64 when lo_bytes is 8, else int32. members is a
// multiple of groups. One blob makes the host's call three arguments.
// Returns the launch's cudaError_t.
extern "C" int lane_reduce_launch(const void* args, void* out, void* stream) {
  long long h[9];
  std::memcpy(h, args, sizeof h);
  const long long members = h[0], groups = h[1], n = h[6], chan = h[7],
                  elem = h[8];
  const int in_bytes = static_cast<int>(h[2]);
  const int lo_bytes = static_cast<int>(h[3]);
  const int hi_bytes = static_cast<int>(h[4]);
  const int mode = static_cast<int>(h[5]);
  if (members < 1 || members > MAX_MEMBERS || groups < 1 ||
      members % groups || n < 1 || elem < 0 || chan < 0 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Members m{};
  std::memcpy(m.p, static_cast<const char*>(args) + sizeof h,
              sizeof(void*) * members);
  for (long long k = 0; k < members; ++k)
    if (m.p[k] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l{static_cast<int>(members / groups), static_cast<int>(groups),
                 n, chan, elem};
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const unsigned b = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    if (in_bytes != 4 || !lane_ok(lo_bytes, false) ||
        !lane_ok(hi_bytes, false))
      return static_cast<int>(cudaErrorInvalidValue);
    reduce_sum<<<b, THREADS, 0, s>>>(m, l, lane_mask(lo_bytes),
                                     lane_mask(hi_bytes),
                                     static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  if ((mode != 1 && mode != 2) || !lane_ok(lo_bytes, true))
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_bytes == 4)
    launch_best<int32_t>(m, l, lo_bytes, mode == 1, out, b, s);
  else if (in_bytes == 8)
    launch_best<long long>(m, l, lo_bytes, mode == 1, out, b, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lane_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
