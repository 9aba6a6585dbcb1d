// K10 block_gather: compact the listed 4 KiB blocks of one flat leaf, or
// of a batch of leaves, in one launch.
//
// Replaces pilosa_tpu/storage/residency.py::_gather_blocks (:79-82), the
// jitted ``arr.reshape(-1, block_words)[idx]`` that demotes a sparse
// dense leaf to the compressed tier (and, in the port, to the host tier
// before its readback): out[j, :] = flat[idx[j] * 1024 : idx[j] * 1024 +
// 1024] for every j of the padded index list. Padding repeats a real
// index, so out's padding rows copy a real block again. A batch writes
// each leaf's rows to that leaf's own output (and, where asked, its
// index to a device copy of its own); an index outside its leaf yields a
// zero block.
//
// Bound on an H100: the launch for one leaf (a 1024-shard month leaf's
// 512 blocks read and written: 4 MiB, 1.3 us at 3.35 TB/s, below the few
// microseconds of a launch), memory for a tier pass's batch (16 month
// leaves: 64 MiB, 20 us). So the design spends one launch on every leaf
// a demotion step moves, and moves each block as one bulk copy.
//
// Design: one warp a CTA, ROWS output rows a CTA, each its own 4 KiB
// shared-memory slot and mbarrier. The lanes find their rows' sources
// and destinations (a binary search over the batch's row starts, then
// the index); one elected lane issues every row's Tensor Memory
// Accelerator bulk copy into shared memory (cp.async.bulk, completing on
// the slot's mbarrier with a 4096-byte transaction count), then, as each
// lands, the bulk store back to global memory
// (cp.async.bulk.global.shared::cta, after a proxy fence), and waits for
// the stores before the CTA exits. Rows whose index lies outside the
// leaf are zero-filled by ordinary stores.
//
// Three ways in, one body. One leaf whose padded index fits
// INLINE_ROWS (a month leaf's 512) takes its index in the launch's
// parameter space (__grid_constant__: no staging buffer, no copy, the
// kernel writing the device copy K11 needs), as the residency cache
// demotes one victim; a larger batch takes its table through a staging
// buffer on the card; the one-leaf call on a device index takes neither.
//
// The batch's table is one device byte blob, laid out as the wrapper
// packs it:
//   int64 leaf[N][4]    per leaf: the device address of its first word,
//                       its 4 KiB blocks, the address of its output and
//                       that of its index copy (0: none)
//   int32 start[N + 1]  its first row in the index, start[N] = n_out
//   (zero padding to idx_offset, a multiple of 16)
//   int32 idx[n_out]    the concatenated padded indices
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_VECS = 1024 / 4;  // uint4 in a 4 KiB block
constexpr unsigned BLOCK_BYTES = 4096;
constexpr int ROWS = 4;               // rows (shared-memory slots) a CTA
constexpr int LEAF_BYTES = 32;        // a leaf's entry in the table
constexpr int INLINE_ROWS = 960;      // an index in parameter space
constexpr unsigned FULL = 0xffffffffu;

struct Gather {
  const unsigned char* table;  // the batch's table, or nullptr: one leaf
  int n_leaves;
  const uint4* flat;           // the one leaf when table is nullptr
  long long n_blocks;
  const int32_t* idx;          // n_out padded indices
  uint4* out;                  // the one leaf's int32[n_out, 1024]
  int32_t* idx_out;            // the one leaf's index copy, or nullptr
  int n_out;
};

// One leaf with its index in the launch's parameters (under 4 KiB).
struct Inline {
  Gather g;
  int32_t idx[INLINE_ROWS];
};

struct Row {
  const uint4* src;  // nullptr for an index outside its leaf
  uint4* dst;
};

// Row j's source and destination blocks; also its index into the
// leaf's index copy, when the leaf has one. g.idx may lie in parameter
// space: a generic load.
__device__ __forceinline__ Row row_at(const Gather& g, int j) {
  const long long b = g.idx[j];
  if (g.table == nullptr) {
    if (g.idx_out != nullptr) g.idx_out[j] = static_cast<int32_t>(b);
    return {b >= 0 && b < g.n_blocks ? g.flat + b * BLOCK_VECS : nullptr,
            g.out + static_cast<long long>(j) * BLOCK_VECS};
  }
  const int* start =
      reinterpret_cast<const int*>(g.table + LEAF_BYTES * g.n_leaves);
  int lo = 0, hi = g.n_leaves - 1;  // the last leaf starting at or before j
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(start + mid) <= j) lo = mid; else hi = mid - 1;
  }
  const long long* leaf =
      reinterpret_cast<const long long*>(g.table + LEAF_BYTES * lo);
  const long long local = j - __ldg(start + lo);
  int32_t* idx_copy = reinterpret_cast<int32_t*>(__ldg(leaf + 3));
  if (idx_copy != nullptr) idx_copy[local] = static_cast<int32_t>(b);
  const uint4* flat = reinterpret_cast<const uint4*>(__ldg(leaf));
  return {b >= 0 && b < __ldg(leaf + 1) ? flat + b * BLOCK_VECS : nullptr,
          reinterpret_cast<uint4*>(__ldg(leaf + 2)) + local * BLOCK_VECS};
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.b32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

template <typename T>
__device__ __forceinline__ T* shfl_ptr(T* p, int lane) {
  return reinterpret_cast<T*>(__shfl_sync(
      FULL, reinterpret_cast<unsigned long long>(p), lane));
}

__device__ __forceinline__ void gather_rows(const Gather& g) {
  __shared__ alignas(128) uint4 slot[ROWS][BLOCK_VECS];
  __shared__ alignas(8) unsigned long long bar[ROWS];
  const int lane = threadIdx.x;
  const int j0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, g.n_out - j0);
  const Row mine = lane < rows ? row_at(g, j0 + lane) : Row{nullptr, nullptr};
  const unsigned valid = __ballot_sync(FULL, mine.src != nullptr);
  Row row[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    row[r] = {shfl_ptr(mine.src, r), shfl_ptr(mine.dst, r)};
  const unsigned zero = ((1u << rows) - 1) & ~valid;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (!(zero >> r & 1)) continue;
#pragma unroll
    for (int k = 0; k < BLOCK_VECS / 32; ++k)
      row[r].dst[lane + 32 * k] = make_uint4(0, 0, 0, 0);
  }
  if (lane != 0 || valid == 0) return;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (valid >> r & 1)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem(&bar[r])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (!(valid >> r & 1)) continue;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
        :: "r"(smem(&bar[r])), "r"(BLOCK_BYTES) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem(slot[r])), "l"(row[r].src), "r"(BLOCK_BYTES),
           "r"(smem(&bar[r])) : "memory");
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (!(valid >> r & 1)) continue;
    while (!mbar_try_wait(smem(&bar[r]), 0)) {
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
        :: "l"(row[r].dst), "r"(smem(slot[r])), "r"(BLOCK_BYTES) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
  // the stores read shared memory and write the output before the exit
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__global__ void __launch_bounds__(32) gather_kernel(const Gather g) {
  gather_rows(g);
}

__global__ void __launch_bounds__(32) gather_inline_kernel(
    const __grid_constant__ Inline p) {
  Gather g = p.g;
  g.idx = p.idx;
  gather_rows(g);
}

int grid(int n_out) { return (n_out + ROWS - 1) / ROWS; }

int launch(const Gather& g, cudaStream_t s) {
  if (g.n_out < 1) return static_cast<int>(cudaErrorInvalidValue);
  gather_kernel<<<grid(g.n_out), 32, 0, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One leaf. flat: device int32[n_blocks * 1024]; idx: device
// int32[n_out]; out: device int32[n_out, 1024]; all 16-byte aligned.
// Returns the launch's cudaError_t.
extern "C" int block_gather_launch(const void* flat, const void* idx,
                                   void* out, long long n_blocks, int n_out,
                                   void* stream) {
  if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Gather g{nullptr, 1, static_cast<const uint4*>(flat), n_blocks,
                 static_cast<const int32_t*>(idx), static_cast<uint4*>(out),
                 nullptr, n_out};
  return launch(g, static_cast<cudaStream_t>(stream));
}

// One leaf, its index from host memory into the launch's parameters:
// host_idx int32[n_out], n_out <= INLINE_ROWS; out: device
// int32[n_out, 1024]; idx_out: device int32[n_out] or null. Returns the
// launch's cudaError_t.
extern "C" int block_gather_inline_launch(const void* flat,
                                          long long n_blocks,
                                          const int32_t* host_idx, int n_out,
                                          void* out, void* idx_out,
                                          void* stream) {
  if (n_blocks < 1 || n_out < 1 || n_out > INLINE_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  Inline p;
  p.g = Gather{nullptr, 1, static_cast<const uint4*>(flat), n_blocks,
               nullptr, static_cast<uint4*>(out),
               static_cast<int32_t*>(idx_out), n_out};
  std::memcpy(p.idx, host_idx, sizeof(int32_t) * n_out);
  gather_inline_kernel<<<grid(n_out), 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// A batch of n_leaves leaves. dev_blob: the table (layout above) on the
// card, its indices at idx_offset; when host_blob is not null it is first
// copied there from pinned host memory (n_bytes), the launch behind the
// copy. Every address, block count and row start is checked by the
// caller. Returns the first cudaError_t.
extern "C" int block_gather_batch_launch(const void* host_blob,
                                         void* dev_blob, int n_bytes,
                                         int idx_offset, int n_leaves,
                                         int n_out, void* stream) {
  if (n_leaves < 1 || idx_offset % 16 ||
      idx_offset < (LEAF_BYTES + 4) * n_leaves + 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (host_blob != nullptr) {
    const cudaError_t err = cudaMemcpyAsync(dev_blob, host_blob, n_bytes,
                                            cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned char* table = static_cast<const unsigned char*>(dev_blob);
  const Gather g{table, n_leaves, nullptr, 0,
                 reinterpret_cast<const int32_t*>(table + idx_offset),
                 nullptr, nullptr, n_out};
  return launch(g, s);
}

extern "C" const char* block_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
