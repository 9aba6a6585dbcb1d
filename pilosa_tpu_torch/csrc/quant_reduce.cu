// K14+K15 quant_reduce: the 8-bit candidate-ranking lane of a mesh's
// reduce whole, the intra-group sum, each group's max-scaled 8-bit
// encode and the receivers' decode with its error bounds, in one launch
// that reads each member's split-channel partial where that member's
// kernel wrote it.
//
// Replaces pilosa_tpu/parallel/reduction.py::hier_quantized_counts
// (:132-175) with the intra-group psum that parallel/dist.py runs before
// it (:165-175). Per group g (members g*per .. (g+1)*per-1) the exact
// int32 totals v = lo + (hi << SPLIT_SHIFT) of the summed split
// channels, the candidates padded with zeros to whole QUANT_BLOCKs of
// 256; per block the scale s = max(1, (max + 254) // 255) and per
// candidate q = (v + (s >> 1)) // s cast to uint8, all in int32
// arithmetic (floor division, adds modulo 2^32) as the reference's jnp
// program computes them; then approx[r] = sum over groups of q * s and
// per block err[b] = sum over groups of (s + 1) >> 1 where s > 1 (0 where
// s == 1: such a block quantized losslessly), packed to split form
// int32[2, R + nb] (v & SPLIT_MASK, v >> SPLIT_SHIFT) for
// batch.merge_split. Lossless (the flat mesh): the exact sum over all
// members, then nb zero bounds.
//
// The lanes never exist in memory: a group's mantissa and scale live in
// a register of the thread that owns the candidate, and the receiver's
// widening multiply adds into the same thread's accumulator. The
// members' addresses travel by value in the launch's parameter space
// (__grid_constant__: no copy), with one channel stride and one element
// stride, so TopN's [2, R] and GroupBy's [2, k, c] (as [2, k*c])
// partials are read without a stack.
//
// Bound on an H100: memory. Each partial is read once and the packed
// result written once: (M * 2 * R * 4 + 2 * (R + nb) * 4) / 3.35 TB/s;
// at R = 65 536 and 8 members that is 1.4 us, below the launch floor.
//
// Design: one thread block per 256-candidate scale block, one thread per
// candidate, a loop over the groups inside the block. Per group each
// thread sums its candidate over the group's members in uint32; the
// block's max is a warp-shuffle reduction then one pass over the 8 warps'
// maxima in shared memory (two buffers by group parity, so one barrier a
// group); thread 0 keeps the block's error bound. Neighbouring threads
// read neighbouring elements of one member channel (coalesced at unit
// element stride).
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;  // QUANT_BLOCK: candidates a scale covers
constexpr int WARPS = BLOCK / 32;
constexpr int SHIFT = 15;   // SPLIT_SHIFT
constexpr int32_t MASK = (1 << SHIFT) - 1;
constexpr int MAX_MEMBERS = 64;  // kernels.LANE_MAX_MEMBERS

struct Members {
  const int32_t* p[MAX_MEMBERS];
};

struct Layout {
  int per;          // members a group
  int groups;
  int quantized;    // 0: the lossless pass-through
  long long rows;   // candidates R
  long long chan;   // channel stride (elements)
  long long elem;   // element stride (elements)
};

__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  int32_t q = a / b;  // b > 0
  if ((a % b) != 0 && a < 0) --q;
  return q;
}

__global__ void __launch_bounds__(BLOCK)
quant_reduce_kernel(const __grid_constant__ Members m, const Layout l,
                    int32_t* __restrict__ out) {
  __shared__ int32_t warp_max[2][WARPS];
  const int t = threadIdx.x;
  const long long b = blockIdx.x;
  const long long r = b * BLOCK + t;
  const bool real = r < l.rows;
  const long long at = r * l.elem;
  const long long total = l.rows + gridDim.x;
  uint32_t acc = 0, err = 0;
  for (int g = 0; g < l.groups; ++g) {
    uint32_t sl = 0, sh = 0;
    if (real) {
      for (int k = g * l.per; k < (g + 1) * l.per; ++k) {
        const int32_t* p = m.p[k] + at;
        sl += static_cast<uint32_t>(__ldg(p));
        sh += static_cast<uint32_t>(__ldg(p + l.chan));
      }
    }
    const uint32_t v = sl + (sh << SHIFT);  // 0 on a pad lane
    if (!l.quantized) {
      acc += v;
      continue;
    }
    int32_t mx = static_cast<int32_t>(v);
    for (int o = 16; o > 0; o >>= 1) {
      const int32_t other = __shfl_xor_sync(0xffffffffu, mx, o);
      mx = other > mx ? other : mx;
    }
    int32_t* wm = warp_max[g & 1];
    if ((t & 31) == 0) wm[t >> 5] = mx;
    __syncthreads();
    mx = wm[0];
    for (int w = 1; w < WARPS; ++w) mx = wm[w] > mx ? wm[w] : mx;
    int32_t s = floordiv(static_cast<int32_t>(static_cast<uint32_t>(mx) +
                                              254u), 255);
    s = s > 1 ? s : 1;
    const int32_t num = static_cast<int32_t>(v + static_cast<uint32_t>(
                                                     s >> 1));
    // astype(uint8) truncates the quotient; the receiver widens the byte
    const uint32_t q = static_cast<uint8_t>(floordiv(num, s));
    acc += q * static_cast<uint32_t>(s);
    if (s > 1) err += static_cast<uint32_t>((s + 1) >> 1);
  }
  if (real) {
    const int32_t x = static_cast<int32_t>(acc);
    out[r] = x & MASK;
    out[total + r] = x >> SHIFT;
  }
  if (t == 0) {
    const int32_t e = static_cast<int32_t>(err);
    out[l.rows + b] = e & MASK;
    out[total + l.rows + b] = e >> SHIFT;
  }
}

}  // namespace

// args: one host blob of little-endian int64s, as the wrapper packs it:
//   members, groups, quantized, rows, chan, elem, then the device
//   addresses of the `members` int32 split-channel partials (at most
//   64), all of one layout: element r of channel c at address + c * chan
//   + r * elem elements. members is a multiple of groups; quantized 0 is
// the lossless pass-through (the sum over every member). out: device
// int32[2, rows + nb], nb = ceil(rows / 256). One blob makes the host's
// call three arguments. Returns the launch's cudaError_t.
extern "C" int quant_reduce_launch(const void* args, void* out, void* stream) {
  long long h[6];
  std::memcpy(h, args, sizeof h);
  const long long members = h[0], groups = h[1], quantized = h[2],
                  rows = h[3], chan = h[4], elem = h[5];
  if (members < 1 || members > MAX_MEMBERS || groups < 1 ||
      members % groups || (quantized != 0 && quantized != 1) || rows < 1 ||
      chan < 0 || elem < 0 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = (rows + BLOCK - 1) / BLOCK;
  if (nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Members m{};
  std::memcpy(m.p, static_cast<const char*>(args) + sizeof h,
              sizeof(void*) * members);
  for (long long k = 0; k < members; ++k)
    if (m.p[k] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l{static_cast<int>(members / groups), static_cast<int>(groups),
                 static_cast<int>(quantized), rows, chan, elem};
  quant_reduce_kernel<<<static_cast<unsigned>(nb), BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      m, l, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quant_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
