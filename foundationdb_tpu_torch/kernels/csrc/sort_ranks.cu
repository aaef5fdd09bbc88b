// Kernel L: sort_ranks — dense ranks of packed keys, their distinct rows in
// order, and the count of distinct valid keys.
//
// Replaces K17, foundationdb_tpu/ops/keys.py:84 sort_ranks:
//   ranks[i]        dense rank of point i among the distinct rows;
//   unique_keys[r]  the row of rank r, sentinel past the last rank;
//   unique_count    the distinct rows that are not the all-ones sentinel
//                   (invalid points were replaced by it, so they sort last
//                   and share one block, which does not count).
// The lexicographic order stays the library's stable sort passes (ops/keys.
// lex_sort_perm, one stable radix sort per word, as K12 and dense_ranks use
// it); the three entries below do the rest, over the sorted order i with
// row perm[i]:
//   sr_heads    one block per tile of kThreads sorted rows: head[i] = row
//               perm[i] differs from row perm[i-1] in any of the W words
//               (compared as uint32), head[0] = 1; the tile's head count
//               into sums[tile] (__syncthreads_count, no atomics);
//   sr_offsets  one block: the tile sums turned into exclusive prefixes in
//               place, a chunk of blockDim tiles at a time with a carry;
//               unique_count = all heads, less one when the last sorted row
//               is the all-ones sentinel;
//   sr_write    one block per tile: a block scan of the head flags plus the
//               tile's prefix is each row's rank; ranks[perm[i]] = rank
//               (written back through the permutation), and a head copies
//               its row to unique_keys[rank] (the caller filled it with the
//               sentinel, which is the tail JAX leaves).
//
// Bound on this card: bytes. The function reads the [P, W] rows and the
// permutation once and writes the ranks and the [P, W] unique rows once;
// at 262,144 x 3 words that is ~9.4 MB, a few microseconds at 3.35 TB/s.
// The design reads each row twice (as itself and as its successor's
// predecessor, through the permutation, so gathers) and the head flags
// once more; the three launches cost more than those extra bytes at this
// size.

#include "common.cuh"

namespace {

using namespace fdb;

template <int W>
__device__ __forceinline__ bool rows_differ(const uint32_t* a,
                                            const uint32_t* b) {
  bool d = false;
#pragma unroll
  for (int j = 0; j < W; ++j) d |= __ldg(a + j) != __ldg(b + j);
  return d;
}

template <int W>
__device__ __forceinline__ bool all_ones(const uint32_t* a) {
  bool s = true;
#pragma unroll
  for (int j = 0; j < W; ++j) s &= __ldg(a + j) == 0xFFFFFFFFu;
  return s;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    heads_kernel(const uint32_t* __restrict__ pts,
                 const long long* __restrict__ perm, int n,
                 int32_t* __restrict__ head, int32_t* __restrict__ sums) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool h = false;
  if (i < n) {
    h = true;
    if (i > 0)
      h = rows_differ<W>(pts + static_cast<size_t>(perm[i]) * W,
                         pts + static_cast<size_t>(perm[i - 1]) * W);
    head[i] = h ? 1 : 0;
  }
  int count = __syncthreads_count(h);
  if (threadIdx.x == 0) sums[blockIdx.x] = count;
}

// Inclusive scan of v over the block's threads; *total gets the block sum.
// blockDim.x must be a multiple of 32 and at most 1024.
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int up = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += up;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int up = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += up;
    }
    if (lane < n_warps) warp_sums[lane] = s;  // inclusive warp prefixes
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums may be reused by the caller
  return v;
}

template <int W>
__global__ void __launch_bounds__(1024)
    offsets_kernel(int32_t* __restrict__ sums, int nb,
                   const uint32_t* __restrict__ pts,
                   const long long* __restrict__ perm, int n,
                   int32_t* __restrict__ count) {
  __shared__ int warp_sums[32];
  int carry = 0;
  for (int base = 0; base < nb; base += blockDim.x) {
    int i = base + threadIdx.x;
    int v = i < nb ? sums[i] : 0;
    int total;
    int incl = block_inclusive_scan(v, warp_sums, &total);
    if (i < nb) sums[i] = carry + incl - v;  // exclusive prefix
    carry += total;
  }
  if (threadIdx.x == 0) {
    bool sentinel = all_ones<W>(pts + static_cast<size_t>(perm[n - 1]) * W);
    *count = carry - (sentinel ? 1 : 0);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    write_kernel(const uint32_t* __restrict__ pts,
                 const long long* __restrict__ perm, int n,
                 const int32_t* __restrict__ head,
                 const int32_t* __restrict__ offsets,
                 int32_t* __restrict__ ranks, uint32_t* __restrict__ ukeys) {
  __shared__ int warp_sums[32];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int h = i < n ? head[i] : 0;
  int total;
  int incl = block_inclusive_scan(h, warp_sums, &total);
  if (i >= n) return;
  int rank = offsets[blockIdx.x] + incl - 1;
  long long p = perm[i];
  ranks[p] = rank;
  if (h) {
    const uint32_t* src = pts + static_cast<size_t>(p) * W;
    uint32_t* dst = ukeys + static_cast<size_t>(rank) * W;
#pragma unroll
    for (int j = 0; j < W; ++j) dst[j] = __ldg(src + j);
  }
}

}  // namespace

extern "C" {

// Words of scratch the tile sums need for n rows (one per tile).
int sr_tiles(int n) { return n <= 0 ? 0 : blocks_for(n); }

int sr_heads(const void* pts, const void* perm, int n, int w, void* head,
             void* sums, void* stream) {
  if (n <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const uint32_t*>(pts);
  auto o = static_cast<const long long*>(perm);
  auto h = static_cast<int32_t*>(head);
  auto t = static_cast<int32_t*>(sums);
  FDB_DISPATCH_W(w, heads_kernel<W><<<blocks_for(n), kThreads, 0, s>>>(
      p, o, n, h, t));
  return static_cast<int>(cudaGetLastError());
}

int sr_offsets(void* sums, const void* pts, const void* perm, int n, int w,
               void* count, void* stream) {
  if (n <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto t = static_cast<int32_t*>(sums);
  auto p = static_cast<const uint32_t*>(pts);
  auto o = static_cast<const long long*>(perm);
  auto c = static_cast<int32_t*>(count);
  FDB_DISPATCH_W(w, offsets_kernel<W><<<1, 1024, 0, s>>>(
      t, blocks_for(n), p, o, n, c));
  return static_cast<int>(cudaGetLastError());
}

int sr_write(const void* pts, const void* perm, int n, int w,
             const void* head, const void* offsets, void* ranks, void* ukeys,
             void* stream) {
  if (n <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const uint32_t*>(pts);
  auto o = static_cast<const long long*>(perm);
  auto h = static_cast<const int32_t*>(head);
  auto f = static_cast<const int32_t*>(offsets);
  auto r = static_cast<int32_t*>(ranks);
  auto u = static_cast<uint32_t*>(ukeys);
  FDB_DISPATCH_W(w, write_kernel<W><<<blocks_for(n), kThreads, 0, s>>>(
      p, o, n, h, f, r, u));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
