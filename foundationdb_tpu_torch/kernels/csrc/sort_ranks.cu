// Kernel L: sort_ranks — dense ranks of packed keys, their distinct rows in
// order, and the count of distinct valid keys.
//
// Replaces K17, foundationdb_tpu/ops/keys.py:84 sort_ranks:
//   ranks[i]        dense rank of point i among the distinct rows;
//   unique_keys[r]  the row of rank r, sentinel past the last rank;
//   unique_count    the distinct rows that are not the all-ones sentinel
//                   (invalid points were replaced by it, so they sort last
//                   and share one block, which does not count).
// Kernel N (lex_order.cu) sorts the rows first and hands over the sorted
// rows and the int32 permutation; the two entries below read the sorted
// rows contiguously (row i and row i - 1) and go through the permutation
// only to write each rank back:
//   sr_heads  one block per tile of kTile sorted rows: the tile's count of
//             heads (a row that differs from the row before it in any of
//             the W words, compared as uint32; row 0 is a head) into
//             sums[tile] (__syncthreads_count, no atomics);
//   sr_write  one block per tile: the heads before the tile and in all
//             (a block reduction over the tile sums, which sit in L2), then
//             a block scan of the tile's heads, recomputed from the rows:
//             rank = heads up to row i, less one; ranks[perm[i]] = rank, a
//             head copies its row to unique_keys[rank], and row i past the
//             last rank writes the sentinel to unique_keys[i] (so the
//             caller fills nothing); block 0 writes unique_count = all
//             heads, less one when the last sorted row is all ones.
// W runs to 16 words: the read-dedup rows of K12 (a begin key then an end
// key) go through the same two entries.
//
// Bound on this card: bytes. The function reads the [P, W] rows and the
// permutation once and writes the ranks and the [P, W] unique rows once;
// at 262,144 x 3 words that is ~7.3 MB with N's share counted in N, a few
// microseconds at 3.35 TB/s. The design reads each sorted row twice per
// entry (as itself and as its successor's predecessor, both contiguous, the
// second from L1) and the tile sums once per block.

#include "common.cuh"

namespace {

using namespace fdb;

constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // 1024 sorted rows per block

int tiles(int n) { return static_cast<int>((n + (kTile - 1LL)) / kTile); }

template <int W>
__device__ __forceinline__ bool is_head(const uint32_t* srt, int i) {
  if (i == 0) return true;
  const uint32_t* a = srt + static_cast<size_t>(i) * W;
  bool d = false;
#pragma unroll
  for (int j = 0; j < W; ++j) d |= __ldg(a + j) != __ldg(a + j - W);
  return d;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    heads_kernel(const uint32_t* __restrict__ srt, int n,
                 int32_t* __restrict__ sums) {
  int count = 0;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    int i = blockIdx.x * kTile + it * kThreads + threadIdx.x;
    count += __syncthreads_count(i < n && is_head<W>(srt, i));
  }
  if (threadIdx.x == 0) sums[blockIdx.x] = count;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    write_kernel(const uint32_t* __restrict__ srt,
                 const int32_t* __restrict__ perm, int n,
                 const int32_t* __restrict__ sums, int nb,
                 int32_t* __restrict__ ranks, uint32_t* __restrict__ ukeys,
                 int32_t* __restrict__ count) {
  __shared__ int warp_sums[32];
  int pre = 0, all = 0;
  for (int t = threadIdx.x; t < nb; t += kThreads) {
    int v = __ldg(sums + t);
    all += v;
    if (t < static_cast<int>(blockIdx.x)) pre += v;
  }
  int carry, heads;
  block_inclusive_scan(pre, warp_sums, &carry);  // heads before the tile
  block_inclusive_scan(all, warp_sums, &heads);  // heads in all
  for (int it = 0; it < kItems; ++it) {
    int i = blockIdx.x * kTile + it * kThreads + threadIdx.x;
    bool h = i < n && is_head<W>(srt, i);
    int total;
    int incl = block_inclusive_scan(h ? 1 : 0, warp_sums, &total);
    if (i < n) {
      int rank = carry + incl - 1;
      ranks[perm[i]] = rank;
      const uint32_t* src = srt + static_cast<size_t>(i) * W;
      if (h) {
        uint32_t* dst = ukeys + static_cast<size_t>(rank) * W;
#pragma unroll
        for (int j = 0; j < W; ++j) dst[j] = __ldg(src + j);
      }
      if (i >= heads) {
        uint32_t* dst = ukeys + static_cast<size_t>(i) * W;
#pragma unroll
        for (int j = 0; j < W; ++j) dst[j] = 0xFFFFFFFFu;
      }
    }
    carry += total;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const uint32_t* last = srt + static_cast<size_t>(n - 1) * W;
    bool sentinel = true;
#pragma unroll
    for (int j = 0; j < W; ++j) sentinel &= __ldg(last + j) == 0xFFFFFFFFu;
    *count = heads - (sentinel ? 1 : 0);
  }
}

}  // namespace

extern "C" {

// Words of scratch the tile sums need for n rows (one per tile).
int sr_tiles(int n) { return n <= 0 ? 0 : tiles(n); }

int sr_heads(const void* srt, int n, int w, void* sums, void* stream) {
  if (n <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const uint32_t*>(srt);
  auto t = static_cast<int32_t*>(sums);
  FDB_DISPATCH_ROW_W(w, heads_kernel<W><<<tiles(n), kThreads, 0, s>>>(
      r, n, t));
  return static_cast<int>(cudaGetLastError());
}

int sr_write(const void* srt, const void* perm, int n, int w,
             const void* sums, void* ranks, void* ukeys, void* count,
             void* stream) {
  if (n <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const uint32_t*>(srt);
  auto p = static_cast<const int32_t*>(perm);
  auto t = static_cast<const int32_t*>(sums);
  auto k = static_cast<int32_t*>(ranks);
  auto u = static_cast<uint32_t*>(ukeys);
  auto c = static_cast<int32_t*>(count);
  FDB_DISPATCH_ROW_W(w, write_kernel<W><<<tiles(n), kThreads, 0, s>>>(
      r, p, n, t, tiles(n), k, u, c));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
