// Kernel M: rangemax4 — the radix-4 range table and interval cover.
//
// Replaces K19, three XLA programs of foundationdb_tpu:
//   rm4_build_level  ops/rangemax.py:190 build4, one launch per level:
//                      t[0]    = values
//                      t[k][i] = op(t[k-1][min(i + sh_j, m - 1)], j = 0..3),
//                      sh_j    = min(j * s, m - 1), s = min(4^(k-1), m - 1),
//                    i.e. op over values[i : i + 4^k] clamped at the end, for
//                    every k >= 1 with 4^(k-1) < m;
//   rm4_query        ops/rangemax.py:210 query4: per query, loc/hic = lo/hi
//                    clipped to [0, m], k = min(floor(log2(max(hic - loc,
//                    1))) >> 1, L - 1), s = 4^k, and op over the four spans
//                    of s starting at clamp(min(loc + j*s, hic - s), 0, m-1),
//                    j = 0..3 (overlapping, exact for max and min); the
//                    identity where hic <= loc;
//   rm4_cover_*      ops/segtree.py:79 min_cover4: each interval (clipped to
//                    [0, leaves], len = hi - lo > 0) atomicMin's its value
//                    at level k = min(floor(log2(len)) >> 1, nlev - 1) at
//                    the four positions min(lo + j*s, hi - s), s = 4^k; then
//                    for j = nlev-1 .. 1, one launch each,
//                      t[j-1][i] = min(t[j-1][i], t[j][i],
//                                      t[j][i - c*4^(j-1)] for c = 1..3
//                                      where c*4^(j-1) < leaves and i >= it),
//                    and t[0] is the answer. nlev = (log2(leaves) + 1) / 2 + 1,
//                    so an odd log2 width gets its top level of 4^(nlev-1)
//                    < leaves spans as JAX builds it. The caller fills the
//                    [nlev, leaves] table with INT32_POS.
//
// Bound on this card: bytes. A build level reads one level (four shifted
// streams of the same row, three of them L2 hits) and writes the next,
// 8 B a row; at 262,144 leaves and 10 levels ~21 MB. A query is 12 B plus
// four 4-byte gathers; the cover's scatter is 12 B an interval plus four
// atomics, its sweep 8 B a leaf per level. Design: the shapes of kernel
// B's and C's first designs (one coalesced launch per level; one thread
// per interval with native atomicMin, then one launch per level reading
// level j and writing level j-1 in place) and of A's query entry (one
// thread per query), with half their levels.

#include "common.cuh"

namespace {

using namespace fdb;

template <bool MIN>
__device__ __forceinline__ int32_t op(int32_t a, int32_t b) {
  return MIN ? min(a, b) : max(a, b);
}

template <bool MIN>
__global__ void build_kernel(const int32_t* __restrict__ values,
                             int32_t* __restrict__ table, int m, int level,
                             int s) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  if (level == 0) {
    table[i] = values[i];
    return;
  }
  const int32_t* prev = table + static_cast<size_t>(level - 1) * m;
  int32_t v = prev[i];
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    long long sh = min(static_cast<long long>(j) * s,
                       static_cast<long long>(m - 1));
    long long at = min(i + sh, static_cast<long long>(m - 1));
    v = op<MIN>(v, prev[at]);
  }
  table[static_cast<size_t>(level) * m + i] = v;
}

template <bool MIN>
__global__ void query_kernel(const int32_t* __restrict__ table, int levels,
                             int m, const int32_t* __restrict__ lo,
                             const int32_t* __restrict__ hi, int q,
                             int32_t* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  int loc = min(max(lo[i], 0), m);
  int hic = min(max(hi[i], 0), m);
  if (hic <= loc) {
    out[i] = MIN ? INT32_POS : INT32_NEG;
    return;
  }
  int k = min(floor_log2(hic - loc) >> 1, levels - 1);
  long long s = 1LL << (2 * k);
  const int32_t* row = table + static_cast<size_t>(k) * m;
  int32_t v = MIN ? INT32_POS : INT32_NEG;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    long long at = min(loc + j * s, hic - s);
    at = min(max(at, 0LL), static_cast<long long>(m - 1));
    v = op<MIN>(v, __ldg(row + at));
  }
  out[i] = v;
}

__global__ void cover_scatter_kernel(const int32_t* __restrict__ lo,
                                     const int32_t* __restrict__ hi,
                                     const int32_t* __restrict__ val, int n,
                                     int leaves, int nlev,
                                     int32_t* __restrict__ table) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  int l = min(max(lo[j], 0), leaves);
  int h = min(max(hi[j], 0), leaves);
  if (h <= l) return;
  int k = min(floor_log2(h - l) >> 1, nlev - 1);
  long long s = 1LL << (2 * k);
  int32_t v = val[j];
  int32_t* row = table + static_cast<size_t>(k) * leaves;
#pragma unroll
  for (int c = 0; c < 4; ++c) atomicMin(row + min(l + c * s, h - s), v);
}

__global__ void cover_sweep_kernel(int32_t* __restrict__ table, int leaves,
                                   int level) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= leaves) return;
  const int32_t* up = table + static_cast<size_t>(level) * leaves;
  int32_t* down = table + static_cast<size_t>(level - 1) * leaves;
  long long step = 1LL << (2 * (level - 1));
  int32_t v = min(down[i], up[i]);
#pragma unroll
  for (int c = 1; c < 4; ++c) {
    long long sh = c * step;
    if (sh < leaves && i >= sh) v = min(v, up[i - sh]);
  }
  down[i] = v;
}

}  // namespace

extern "C" {

int rm4_build_level(const void* values, void* table, int m, int level, int s,
                    int op_min, void* stream) {
  if (m <= 0) return kNoLaunch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const int32_t*>(values);
  auto t = static_cast<int32_t*>(table);
  if (op_min)
    build_kernel<true><<<blocks_for(m), kThreads, 0, st>>>(v, t, m, level, s);
  else
    build_kernel<false><<<blocks_for(m), kThreads, 0, st>>>(v, t, m, level, s);
  return static_cast<int>(cudaGetLastError());
}

int rm4_query(const void* table, int levels, int m, const void* lo,
              const void* hi, int q, int op_min, void* out, void* stream) {
  if (q <= 0) return kNoLaunch;
  if (m <= 0 || levels <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto t = static_cast<const int32_t*>(table);
  auto l = static_cast<const int32_t*>(lo);
  auto h = static_cast<const int32_t*>(hi);
  auto o = static_cast<int32_t*>(out);
  if (op_min)
    query_kernel<true><<<blocks_for(q), kThreads, 0, st>>>(t, levels, m, l, h,
                                                            q, o);
  else
    query_kernel<false><<<blocks_for(q), kThreads, 0, st>>>(t, levels, m, l,
                                                             h, q, o);
  return static_cast<int>(cudaGetLastError());
}

int rm4_cover_scatter(const void* lo, const void* hi, const void* val, int n,
                      int leaves, int nlev, void* table, void* stream) {
  if (n <= 0) return kNoLaunch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cover_scatter_kernel<<<blocks_for(n), kThreads, 0, st>>>(
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
      static_cast<const int32_t*>(val), n, leaves, nlev,
      static_cast<int32_t*>(table));
  return static_cast<int>(cudaGetLastError());
}

int rm4_cover_sweep_level(void* table, int leaves, int level, void* stream) {
  if (leaves <= 0 || level < 1) return kNoLaunch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cover_sweep_kernel<<<blocks_for(leaves), kThreads, 0, st>>>(
      static_cast<int32_t*>(table), leaves, level);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
