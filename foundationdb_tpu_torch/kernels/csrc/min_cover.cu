// Kernel C: min_cover — for each leaf, the min of val[j] over the
// intervals [lo_j, hi_j) that cover it.
//
// Replaces K5, foundationdb_tpu/ops/segtree.py:25 min_cover, with the same
// two-step cover:
//   scatter  each interval (clipped to [0, leaves]) with len = hi - lo > 0
//            atomicMin's its value at level k = floor(log2(len)) at lo and
//            at hi - 2^k; an interval with lo >= hi touches nothing;
//   sweep    for j = log .. 1:
//              t[j-1][i] = min(t[j-1][i], t[j][i], t[j][i - 2^(j-1)]),
//            the shifted operand +inf for i < 2^(j-1); t[0] is the answer.
// The caller fills the [log+1, leaves] table with INT32_POS first.
//
// Bound on this card: the sweep's bytes (read two levels, write one:
// ~12 B x leaves per level; 2^18 leaves x 18 levels = 57 MB at bench
// shape, L2-resident) and, on the scatter, atomic throughput on 2 x NW
// addresses. Design: the scatter is one thread per interval with native
// 32-bit atomicMin (the v5e design avoided scatters; Hopper's L2 atomics
// make them the cheap step); the sweep is one coalesced launch per
// level, reading level j and writing level j-1 in place, so no level is
// both read and written by one launch.

#include "common.cuh"

namespace {

using namespace fdb;

__global__ void scatter_kernel(const int32_t* __restrict__ lo,
                               const int32_t* __restrict__ hi,
                               const int32_t* __restrict__ val, int n,
                               int leaves, int32_t* __restrict__ table) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  int l = min(max(lo[j], 0), leaves);
  int h = min(max(hi[j], 0), leaves);
  if (h <= l) return;
  int k = floor_log2(h - l);
  int32_t v = val[j];
  int32_t* row = table + static_cast<size_t>(k) * leaves;
  atomicMin(row + l, v);
  atomicMin(row + (h - (1 << k)), v);
}

__global__ void sweep_kernel(int32_t* __restrict__ table, int leaves,
                             int level) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= leaves) return;
  const int32_t* up = table + static_cast<size_t>(level) * leaves;
  int32_t* down = table + static_cast<size_t>(level - 1) * leaves;
  int half = 1 << (level - 1);
  int32_t v = min(down[i], up[i]);
  if (i >= half) v = min(v, up[i - half]);
  down[i] = v;
}

}  // namespace

extern "C" {

int mc_scatter(const void* lo, const void* hi, const void* val, int n,
               int leaves, void* table, void* stream) {
  if (n <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  scatter_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
      static_cast<const int32_t*>(val), n, leaves,
      static_cast<int32_t*>(table));
  return static_cast<int>(cudaGetLastError());
}

int mc_sweep_level(void* table, int leaves, int level, void* stream) {
  if (leaves <= 0 || level < 1) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sweep_kernel<<<blocks_for(leaves), kThreads, 0, s>>>(
      static_cast<int32_t*>(table), leaves, level);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
