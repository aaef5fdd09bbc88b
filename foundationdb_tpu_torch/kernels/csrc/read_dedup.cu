// Kernel F: read_dedup — distinct (begin, end) read ranges of a batch, so
// only the distinct ones probe the main tier.
//
// Replaces (JAX/XLA programs of foundationdb_tpu):
//   K12 ops/delta.py:120 _main_stale with dedup_reads = U: the batch's
//       [NR, 2W] rows (begin words, then end words; dead reads keyed to
//       the all-ones sentinel) sorted, unique heads flagged, the first U
//       heads compacted into [U, W] begin/end buffers, kernel A's probe of
//       those, and every read's vmax gathered back from its head. The
//       count of distinct live rows, n_uniq, decides the latch
//       (n_uniq <= U), so it is exact. JAX compacts the heads and
//       inverts the permutation with two more sorts (sorts were the
//       cheap primitive there).
//
// Here the rows go through kernel N (lex_order.cu, the sort) and kernel L
// (sort_ranks.cu at width 2W): L's ranks are each read's unique rank in
// input order, its unique rows are the distinct rows in order with a
// sentinel tail, and its count is the distinct rows that are not all ones,
// which is n_uniq: a dead read's row is all ones, and a live read's begin
// length word is a real length, never 0xFFFFFFFF. The two entries below
// do the rest:
//   dd_split   row i < U of the unique rows into urb[i] (its first W words)
//              and ure[i] (its last W), the sentinel past the NR rows L
//              wrote; the dead reads' all-ones row, when it falls below U,
//              is the sentinel too, as in the plain version (rows past
//              n_uniq serve only dead reads, whose result is masked);
//   dd_gather  vmax[i] = vmax_u[min(rank[i], U - 1)], after kernel A's
//              probe of the U buffer rows.
//
// Bound on this card: bytes. dd_split writes 2 U W words and reads as
// many; dd_gather reads NR ranks and writes NR versions (the U probe
// results sit in L2). At NR = 65,536 both are well under a megabyte, so
// each launch costs its latency.

#include "common.cuh"

namespace {

using namespace fdb;

template <int W>
__global__ void split_kernel(const uint32_t* __restrict__ ukeys, int nr,
                             int u, uint32_t* __restrict__ urb,
                             uint32_t* __restrict__ ure) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= u) return;
  const uint32_t* src = ukeys + static_cast<size_t>(i) * (2 * W);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    urb[static_cast<size_t>(i) * W + j] = i < nr ? __ldg(src + j) : 0xFFFFFFFFu;
    ure[static_cast<size_t>(i) * W + j] =
        i < nr ? __ldg(src + W + j) : 0xFFFFFFFFu;
  }
}

__global__ void gather_kernel(const int32_t* __restrict__ vmax_u,
                              const int32_t* __restrict__ rank, int n, int u,
                              int32_t* __restrict__ vmax) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  vmax[i] = __ldg(vmax_u + min(max(rank[i], 0), u - 1));
}

}  // namespace

extern "C" {

int dd_split(const void* ukeys, int nr, int w, int u, void* urb, void* ure,
             void* stream) {
  if (u <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto k = static_cast<const uint32_t*>(ukeys);
  auto b = static_cast<uint32_t*>(urb);
  auto e = static_cast<uint32_t*>(ure);
  FDB_DISPATCH_W(w, split_kernel<W><<<blocks_for(u), kThreads, 0, s>>>(
      k, nr, u, b, e));
  return static_cast<int>(cudaGetLastError());
}

int dd_gather(const void* vmax_u, const void* rank, int n, int u, void* vmax,
              void* stream) {
  if (n <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gather_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const int32_t*>(vmax_u), static_cast<const int32_t*>(rank),
      n, u, static_cast<int32_t*>(vmax));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
