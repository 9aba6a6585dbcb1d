// K9 groupby_level: one level of GroupBy, per shard and candidate group:
// the popcount of the AND of one row of every dimension matrix (and a
// filter row), and with an aggregate the count and bit-plane counts of
// an int field under that mask.
//
// Replaces pilosa_tpu/executor/batch.py::groupby_level_body (:696-722)
// as local_groupby_level_fn vmaps it per shard (:725-762). For shard s
// and candidate c:
//   mask = AND_d dims[d][s, idx[d][c]] & filt[s]        (no filt: skipped)
//   out[s, 0, c]     = popcount(mask)
// and with planes (exists, sign, depth bit planes of the int field):
//   g                = mask & planes[s, 0]
//   out[s, 1, c]     = popcount(g)
//   out[s, 2 + b, c] = popcount(planes[s, 2 + b] & g)   for b < depth
// The output is int32[S, K, C] with K = 1 (no aggregate) or 2 + depth; a
// shard row has 2^20 bits, so every value fits. The wrapper's caller
// split-sums it over shards on the device into the reference's packed
// layout. No mask reaches device memory.
//
// Bound on an H100. Bytes: the distinct rows the candidates reference,
// the filter and the planes, each read once: (distinct rows + 1 + [1 +
// depth]) x S x W x 4 bytes / 3.35 TB/s. Operations: this design issues
// one __popc per 32-bit mask word (C x S x W popcounts, times 2 + depth
// with the aggregate), and the card issues 16 popcounts a clock per SM,
// 4.2e12 a second at 132 SMs and 1.98 GHz. A level is bounded by the
// larger: bytes at few candidates, popcount issue at many (a carry-save
// count over successive words could go below one popcount per word; this
// kernel does not).
//
// Design. The wrapper's host plan (kernels.groupby_plan) sorts the
// candidates lexicographically and cuts them into tiles whose distinct
// rows fit shared memory, and each tile into groups of at most 8
// candidates that share every dimension's row but the last (with the
// aggregate, one candidate each, its plane counts cut into parts of at
// most 8 planes). A group, or a part, is a unit; the plan deals each
// tile's units to the block's 16 warps, longest first onto the least
// loaded. A block owns one (candidate tile, shard) pair and walks that
// shard's words in word tiles of TW words: it stages each of the tile's
// distinct rows (the filter, the dimension rows its candidates
// reference, with the aggregate the exists row and the bit planes) into
// shared memory once per word tile, through a double-buffered cp.async
// ring, so the next word tile's loads overlap this one's evaluation. So
// every distinct row is read from HBM once per shard per candidate tile
// (once in all at the main path's levels, which fit one tile). Each warp
// walks its units over the word tile, 32 lanes on neighbouring 16-byte
// groups of one staged row at a time (no bank conflicts, whatever the
// rows' offsets), up to 4 groups a lane per step: it builds the unit's
// prefix (filter & every dimension but the last) once per word, then
// per candidate (unrolled, so eight counts are in flight) ANDs the last
// dimension's row and popcounts, and adds each warp total (one redux
// instruction) into the candidate's counter in shared memory. Slot
// indices come from lanes by shuffles, not from memory per candidate. At
// the end each counter is written once to out[s, k, c] at the caller's
// candidate position: no global atomics, and the output is the same
// every run.
#include "words.cuh"

namespace {

constexpr int THREADS = 512;   // kernels.GROUPBY_WARPS x 32
constexpr int WARPS = THREADS / 32;
constexpr int MAX_DIMS = 16;   // kernels.MAX_LEAVES
constexpr int MAX_DEPTH = 63;  // as K6 (bsi_sum.cu)
constexpr int MAX_SLOTS = 128; // kernels.GROUPBY_MAX_SLOTS
constexpr int SMEM_BYTES = 232448;  // kernels.GROUPBY_SMEM_BYTES
constexpr int SRC_FILT = MAX_DIMS;
constexpr int SRC_PLANES = MAX_DIMS + 1;
constexpr int KG = 8;          // kernels.GROUPBY_GROUP_MAX: candidates of a
                               // group, planes of an aggregate part
constexpr int MAX_CHUNK = 4;   // word groups per lane per chunk, at most
constexpr unsigned FULL = 0xffffffffu;

struct GroupParams {
  const uint32_t* dims[MAX_DIMS];  // int32[S, dim_rows[d], row_words]
  long long dim_rows[MAX_DIMS];
  const uint32_t* filt;            // int32[S, row_words] or null
  const uint32_t* planes;          // int32[S, 2 + depth, row_words] or null
  const int* plan;                 // the packed host plan
  int tiles_off, slots_off, groups_off, cslots_off, cout_off, units_off,
      warps_off;
  int n_dims;
  int n_cand;
  int depth;
  int part_planes;  // planes of one aggregate part (<= KG)
  int tile_words;   // TW, a multiple of 4 with 16-byte groups
  int chunk_elems;  // word groups per lane per chunk (1..MAX_CHUNK)
  long long row_words;
};

// One T (a word or a 16-byte group) from global into shared memory.
__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src,
                                         uint4) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src,
                                         uint32_t) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T lds(const uint32_t* row, int e) {
  return *reinterpret_cast<const T*>(row + e * pilosa::kWords<T>);
}

__device__ __forceinline__ int warp_total(int v) {
  return static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(v)));
}

// Sum each of the first n of v over the warp, then lane 0 adds the
// non-zero sums into dst[stride * j] (shared memory).
template <int N>
__device__ __forceinline__ void add_counts(int (&v)[N], int n, int* dst,
                                           int stride, int lane) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) v[j] = warp_total(v[j]);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < n && v[j] != 0) atomicAdd(dst + stride * j, v[j]);
  }
}

// T: a word or a 16-byte group; CE: word groups per lane per chunk.
template <typename T, int CE>
__global__ void __launch_bounds__(THREADS)
groupby_level_kernel(const __grid_constant__ GroupParams p,
                     int* __restrict__ out) {
  constexpr int KW = pilosa::kWords<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int* tile = p.plan + p.tiles_off + 6 * blockIdx.x;
  const int slot0 = tile[0], n_slots = tile[1], cand0 = tile[4],
            n_cands = tile[5];
  const long long s = blockIdx.y;
  const long long W = p.row_words;
  const int TW = p.tile_words;
  const bool agg = p.planes != nullptr;
  const int K = agg ? 2 + p.depth : 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // [MAX_SLOTS] row pointers, then stage [2][n_slots][TW], then counters
  const uint32_t** src = reinterpret_cast<const uint32_t**>(smem);
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + 8 * MAX_SLOTS);
  int* counts = reinterpret_cast<int*>(stage + 2LL * n_slots * TW);
  for (int i = threadIdx.x; i < n_slots; i += THREADS) {
    const int* sl = p.plan + p.slots_off + 2 * (slot0 + i);
    const int from = sl[0];
    const long long row = sl[1];
    if (from == SRC_FILT)
      src[i] = p.filt + s * W;
    else if (from == SRC_PLANES)
      src[i] = p.planes + (s * (2LL + p.depth) + row) * W;
    else
      src[i] = p.dims[from] + (s * p.dim_rows[from] + row) * W;
  }
  for (int i = threadIdx.x; i < n_cands * K; i += THREADS) counts[i] = 0;
  __syncthreads();

  const long long n_tiles = (W + TW - 1) / TW;
  auto load_tile = [&](long long t, int buf) {
    const long long lo = t * TW;
    const int ne = static_cast<int>(min(static_cast<long long>(TW), W - lo)) /
                   KW;
    uint32_t* dst = stage + static_cast<long long>(buf) * n_slots * TW;
    for (int i = threadIdx.x; i < n_slots * ne; i += THREADS) {
      const int sl = i / ne;
      const int e = i - sl * ne;
      cp_async(dst + sl * TW + e * KW, src[sl] + lo + e * KW, T());
    }
  };

  const int n_dims = p.n_dims;
  const bool has_filt = p.filt != nullptr;  // then slot 0 is the filter
  const int exists_slot = n_slots - 1 - p.depth;  // with the aggregate
  const int* cslots = p.plan + p.cslots_off;
  const int* groups = p.plan + p.groups_off;
  const int* units = p.plan + p.units_off;
  const int* wl = p.plan + p.warps_off + (WARPS + 1) * blockIdx.x + warp;
  const int u_begin = wl[0], u_end = wl[1];  // this warp's units
  constexpr int ch = 32 * CE;  // word groups per chunk

  load_tile(0, 0);
  cp_async_commit();
  for (long long t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1, static_cast<int>((t + 1) & 1));
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const uint32_t* rows =
        stage + static_cast<long long>(t & 1) * n_slots * TW;
    const int ne =
        static_cast<int>(min(static_cast<long long>(TW), W - t * TW)) / KW;
    for (int u = u_begin; u < u_end; ++u) {
      const int g = units[2 * u], part = units[2 * u + 1];
      const int c0 = groups[2 * g], k = groups[2 * g + 1];
      const int* cs = cslots + static_cast<long long>(c0) * n_dims;
      // slot indices, one per lane, handed round by shuffles
      const int pre_slot = lane < n_dims - 1 ? cs[lane] : 0;
      const int last_slot = lane < k ? cs[lane * n_dims + n_dims - 1] : 0;
      int* cnt = counts + (c0 - cand0) * K;
      for (int q = 0; q < ne; q += ch) {
        int e[CE];
        bool ok[CE];
        T pre[CE];
#pragma unroll
        for (int r = 0; r < CE; ++r) {
          e[r] = q + r * 32 + lane;
          ok[r] = e[r] < ne;
          pre[r] = pilosa::splat(ok[r] ? ~0u : 0u, T());
          if (ok[r] && has_filt) pre[r] = pre[r] & lds<T>(rows, e[r]);
        }
        for (int d = 0; d + 1 < n_dims; ++d) {
          const uint32_t* row = rows + __shfl_sync(FULL, pre_slot, d) * TW;
#pragma unroll
          for (int r = 0; r < CE; ++r)
            if (ok[r]) pre[r] = pre[r] & lds<T>(row, e[r]);
        }
        if (!agg) {
          int v[KG];
#pragma unroll
          for (int j = 0; j < KG; ++j) {
            v[j] = 0;
            const uint32_t* last =
                rows + __shfl_sync(FULL, last_slot, j) * TW;
            if (j < k) {
#pragma unroll
              for (int r = 0; r < CE; ++r)
                if (ok[r]) v[j] += pilosa::popc(pre[r] & lds<T>(last, e[r]));
            }
          }
          add_counts(v, k, cnt, K, lane);
          continue;
        }
        // the aggregate: one candidate, count and n in part 0, then
        // planes [b0, b0 + part_planes)
        const uint32_t* last = rows + __shfl_sync(FULL, last_slot, 0) * TW;
        const uint32_t* ex = rows + exists_slot * TW;
        int c[2] = {0, 0};
#pragma unroll
        for (int r = 0; r < CE; ++r) {
          if (!ok[r]) continue;
          pre[r] = pre[r] & lds<T>(last, e[r]);  // the mask
          if (part == 0) c[0] += pilosa::popc(pre[r]);
          pre[r] = pre[r] & lds<T>(ex, e[r]);  // g
          if (part == 0) c[1] += pilosa::popc(pre[r]);
        }
        if (part == 0) add_counts(c, 2, cnt, 1, lane);
        const int b0 = part * p.part_planes;
        const int nb = min(p.part_planes, p.depth - b0);
        int v[KG];
#pragma unroll
        for (int j = 0; j < KG; ++j) {
          v[j] = 0;
          if (j < nb) {
            const uint32_t* plane = ex + (1 + b0 + j) * TW;
#pragma unroll
            for (int r = 0; r < CE; ++r)
              if (ok[r]) v[j] += pilosa::popc(lds<T>(plane, e[r]) & pre[r]);
          }
        }
        add_counts(v, nb, cnt + 2 + b0, 1, lane);
      }
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }

  const int* cout = p.plan + p.cout_off + cand0;
  for (int i = threadIdx.x; i < n_cands * K; i += THREADS) {
    const int kk = i / n_cands;
    const int c = i - kk * n_cands;
    out[(s * K + kk) * p.n_cand + cout[c]] = counts[c * K + kk];
  }
}

template <typename T, int CE>
int launch(const GroupParams& p, int n_tiles, long long n_shards, int smem,
           int* out, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      groupby_level_kernel<T, CE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(n_shards));
  groupby_level_kernel<T, CE><<<grid, THREADS, smem, st>>>(p, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_chunk(const GroupParams& p, int n_tiles, long long n_shards,
                 int smem, int* out, cudaStream_t st) {
  if (p.chunk_elems == 4)
    return launch<T, 4>(p, n_tiles, n_shards, smem, out, st);
  if (p.chunk_elems == 2)
    return launch<T, 2>(p, n_tiles, n_shards, smem, out, st);
  return launch<T, 1>(p, n_tiles, n_shards, smem, out, st);
}

}  // namespace

// dims: host array of n_dims device pointers, matrix d int32[n_shards,
// dim_rows[d], row_words]; dim_rows: host int64[n_dims]; plan: the device
// copy of kernels.GroupPlan.packed (candidate rows checked by the caller
// against dim_rows); meta: host int[12] = n_tiles, the seven array
// offsets (tiles, slots, groups, cslots, cout, units, warp lists),
// tile_words, chunk_elems (1, 2 or 4), part_planes and the launch's
// shared-memory bytes; filt: device int32[n_shards, row_words]
// or null; planes: device int32[n_shards, 2 + depth, row_words] or null;
// out: device int32[n_shards, planes ? 2 + depth : 1, n_cand], every
// entry written; vec: 1 when row_words % 4 == 0 and every pointer is
// 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int groupby_level_launch(const void* const* dims,
                                    const long long* dim_rows, int n_dims,
                                    const void* plan, const int* meta,
                                    const void* filt, const void* planes,
                                    int depth, long long n_shards,
                                    long long row_words, int vec, int n_cand,
                                    void* out, void* stream) {
  const int n_tiles = meta[0], tile_words = meta[8], chunk = meta[9],
            part_planes = meta[10], smem = meta[11];
  if (n_dims < 1 || n_dims > MAX_DIMS || n_cand < 1 || n_shards < 1 ||
      n_shards > 65535 || row_words < 1 || (vec && row_words % 4 != 0) ||
      (planes && (depth < 0 || depth > MAX_DEPTH)) || n_tiles < 1 ||
      tile_words < 1 || (vec && tile_words % 4 != 0) ||
      (chunk != 1 && chunk != 2 && chunk != MAX_CHUNK) || part_planes < 1 ||
      part_planes > KG || smem < 1 ||
      smem > SMEM_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  GroupParams p{};
  for (int d = 0; d < n_dims; ++d) {
    if (dim_rows[d] < 1) return static_cast<int>(cudaErrorInvalidValue);
    p.dims[d] = static_cast<const uint32_t*>(dims[d]);
    p.dim_rows[d] = dim_rows[d];
  }
  p.filt = static_cast<const uint32_t*>(filt);
  p.planes = static_cast<const uint32_t*>(planes);
  p.plan = static_cast<const int*>(plan);
  p.tiles_off = meta[1];
  p.slots_off = meta[2];
  p.groups_off = meta[3];
  p.cslots_off = meta[4];
  p.cout_off = meta[5];
  p.units_off = meta[6];
  p.warps_off = meta[7];
  p.part_planes = part_planes;
  p.n_dims = n_dims;
  p.n_cand = n_cand;
  p.depth = planes ? depth : 0;
  p.tile_words = tile_words;
  p.chunk_elems = chunk;
  p.row_words = row_words;
  auto st = static_cast<cudaStream_t>(stream);
  auto o = static_cast<int*>(out);
  return vec ? launch_chunk<uint4>(p, n_tiles, n_shards, smem, o, st)
             : launch_chunk<uint32_t>(p, n_tiles, n_shards, smem, o, st);
}

extern "C" const char* groupby_level_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
