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
//       cheap primitive there); here both are scatters.
//
// The lexicographic sort of the rows stays the library's stable radix
// sort (ops/keys.lex_sort_perm) and the unique rank one torch.cumsum;
// the three entries below do the rest:
//   dd_heads    head[i] = sorted row i differs from row i-1 (full 2W
//               words), n_uniq += heads whose begin length word is not
//               the sentinel (a warp ballot, one atomic per warp);
//   dd_compact  uh_in[perm[i]] = rank of sorted row i; live heads of
//               rank < U copy their begin/end words to row rank of the
//               [U, W] buffers;
//   dd_gather   vmax[i] = vmax_u[min(uh_in[i], U - 1)].
//
// Bound on this card: the [NR, 2W] rows and the int64 permutation read
// once, the head flags and ranks written and read once, U begin/end rows
// written, NR int32 out; all of it a few MB at NR = 65,536, so the floor
// is bytes and the cost is launch latency plus the gathers through perm.

#include "common.cuh"

namespace {

using namespace fdb;

template <int W>
__device__ __forceinline__ bool live_row(const uint32_t* row) {
  return row[W - 1] != 0xFFFFFFFFu;  // begin length word
}

template <int W>
__global__ void heads_kernel(const uint32_t* __restrict__ rows,
                             const long long* __restrict__ perm, int n,
                             int32_t* __restrict__ head,
                             int32_t* __restrict__ n_uniq) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool counted = false;
  if (i < n) {
    const uint32_t* cur = rows + static_cast<size_t>(perm[i]) * (2 * W);
    bool h = true;
    if (i > 0) {
      const uint32_t* prev =
          rows + static_cast<size_t>(perm[i - 1]) * (2 * W);
      h = false;
#pragma unroll
      for (int j = 0; j < 2 * W; ++j) h |= __ldg(cur + j) != __ldg(prev + j);
    }
    head[i] = h ? 1 : 0;
    counted = h && live_row<W>(cur);
  }
  unsigned ballot = __ballot_sync(0xFFFFFFFFu, counted);
  if ((threadIdx.x & 31) == 0 && ballot != 0)
    atomicAdd(n_uniq, __popc(ballot));
}

template <int W>
__global__ void compact_kernel(const uint32_t* __restrict__ rows,
                               const long long* __restrict__ perm,
                               const int32_t* __restrict__ head,
                               const int32_t* __restrict__ rank_incl, int n,
                               int u, uint32_t* __restrict__ urb,
                               uint32_t* __restrict__ ure,
                               int32_t* __restrict__ uh_in) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long p = perm[i];
  int uh = rank_incl[i] - 1;
  uh_in[p] = uh;
  const uint32_t* row = rows + static_cast<size_t>(p) * (2 * W);
  if (head[i] && uh < u && live_row<W>(row)) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      urb[static_cast<size_t>(uh) * W + j] = __ldg(row + j);
      ure[static_cast<size_t>(uh) * W + j] = __ldg(row + W + j);
    }
  }
}

__global__ void gather_kernel(const int32_t* __restrict__ vmax_u,
                              const int32_t* __restrict__ uh_in, int n, int u,
                              int32_t* __restrict__ vmax) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  vmax[i] = __ldg(vmax_u + min(max(uh_in[i], 0), u - 1));
}

}  // namespace

extern "C" {

int dd_heads(const void* rows, const void* perm, int n, int w, void* head,
             void* n_uniq, void* stream) {
  if (n <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const uint32_t*>(rows);
  auto p = static_cast<const long long*>(perm);
  auto h = static_cast<int32_t*>(head);
  auto c = static_cast<int32_t*>(n_uniq);
  FDB_DISPATCH_W(w, heads_kernel<W><<<blocks_for(n), kThreads, 0, s>>>(
      r, p, n, h, c));
  return static_cast<int>(cudaGetLastError());
}

int dd_compact(const void* rows, const void* perm, const void* head,
               const void* rank_incl, int n, int w, int u, void* urb,
               void* ure, void* uh_in, void* stream) {
  if (n <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const uint32_t*>(rows);
  auto p = static_cast<const long long*>(perm);
  auto h = static_cast<const int32_t*>(head);
  auto k = static_cast<const int32_t*>(rank_incl);
  auto b = static_cast<uint32_t*>(urb);
  auto e = static_cast<uint32_t*>(ure);
  auto o = static_cast<int32_t*>(uh_in);
  FDB_DISPATCH_W(w, compact_kernel<W><<<blocks_for(n), kThreads, 0, s>>>(
      r, p, h, k, n, u, b, e, o));
  return static_cast<int>(cudaGetLastError());
}

int dd_gather(const void* vmax_u, const void* uh_in, int n, int u, void* vmax,
              void* stream) {
  if (n <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gather_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const int32_t*>(vmax_u), static_cast<const int32_t*>(uh_in),
      n, u, static_cast<int32_t*>(vmax));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
