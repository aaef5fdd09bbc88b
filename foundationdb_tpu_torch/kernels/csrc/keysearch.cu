// Kernel A: keysearch — binary search over sorted packed keys, the O(1)
// doubling-table query, and the two fused into one history probe.
//
// Replaces (JAX/XLA programs of foundationdb_tpu):
//   search  K2 ops/keys.py:50 searchsorted (and K6 ops/group.py:105
//           _sorted_counts, which is a left search at W=1 over
//           nondecreasing txn ids);
//   query   K3 ops/rangemax.py:71 query;
//   probe   K4 ops/history.py:77 query_reads_vmax: il = search_right(rb)-1,
//           ir = search_left(re)-1, then a max query over [max(il,0), ir+1).
//           A full search for `re` gives the same ir as the JAX 4-boundary
//           window with its fallback on every live read.
//
// Bound on this card: a search reads ~log2(M) rows per query from a key
// array that fits the 50 MB L2 (786,432 x 3 words = 9.4 MB at bench
// shape), so the cost is dependent-load latency, not bandwidth. Design:
// one thread per query, the query key held in registers, compare as
// uint32 word by word; many queries in flight hide the latency. The
// table query is two gathers per query.

#include "common.cuh"

namespace {

using namespace fdb;

template <int W, bool RIGHT>
__global__ void search_kernel(const uint32_t* __restrict__ keys, int m,
                              const uint32_t* __restrict__ queries, int q,
                              int32_t* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  uint32_t k[W];
  load_key<W>(k, queries + static_cast<size_t>(i) * W);
  out[i] = search<W, RIGHT>(keys, m, k);
}

template <bool MIN>
__device__ __forceinline__ int32_t table_query(const int32_t* __restrict__ t,
                                               int levels, int m, int lo,
                                               int hi) {
  int loc = min(max(lo, 0), m);
  int hic = min(max(hi, 0), m);
  if (hic <= loc) return MIN ? INT32_POS : INT32_NEG;
  int k = min(floor_log2(hic - loc), levels - 1);
  int a = min(max(loc, 0), m - 1);
  int b = min(max(hic - (1 << k), 0), m - 1);
  int32_t va = __ldg(t + static_cast<size_t>(k) * m + a);
  int32_t vb = __ldg(t + static_cast<size_t>(k) * m + b);
  return MIN ? min(va, vb) : max(va, vb);
}

template <bool MIN>
__global__ void query_kernel(const int32_t* __restrict__ table, int levels,
                             int m, const int32_t* __restrict__ lo,
                             const int32_t* __restrict__ hi, int q,
                             int32_t* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  out[i] = table_query<MIN>(table, levels, m, lo[i], hi[i]);
}

template <int W>
__global__ void probe_kernel(const uint32_t* __restrict__ keys, int m,
                             const int32_t* __restrict__ table, int levels,
                             const uint32_t* __restrict__ rb,
                             const uint32_t* __restrict__ re, int q,
                             int32_t* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  uint32_t k[W];
  load_key<W>(k, rb + static_cast<size_t>(i) * W);
  int il = search<W, true>(keys, m, k) - 1;
  load_key<W>(k, re + static_cast<size_t>(i) * W);
  int ir = search<W, false>(keys, m, k) - 1;
  out[i] = table_query<false>(table, levels, m, max(il, 0), ir + 1);
}

}  // namespace

extern "C" {

int ks_search(const void* keys, int m, int w, const void* queries, int q,
              int right, void* out, void* stream) {
  if (q <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto k = static_cast<const uint32_t*>(keys);
  auto qs = static_cast<const uint32_t*>(queries);
  auto o = static_cast<int32_t*>(out);
  FDB_DISPATCH_W(w, {
    if (right)
      search_kernel<W, true><<<blocks_for(q), kThreads, 0, s>>>(k, m, qs, q, o);
    else
      search_kernel<W, false><<<blocks_for(q), kThreads, 0, s>>>(k, m, qs, q, o);
  });
  return static_cast<int>(cudaGetLastError());
}

int ks_query(const void* table, int levels, int m, const void* lo,
             const void* hi, int q, int op_min, void* out, void* stream) {
  if (q <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto t = static_cast<const int32_t*>(table);
  auto l = static_cast<const int32_t*>(lo);
  auto h = static_cast<const int32_t*>(hi);
  auto o = static_cast<int32_t*>(out);
  if (op_min)
    query_kernel<true><<<blocks_for(q), kThreads, 0, s>>>(t, levels, m, l, h, q, o);
  else
    query_kernel<false><<<blocks_for(q), kThreads, 0, s>>>(t, levels, m, l, h, q, o);
  return static_cast<int>(cudaGetLastError());
}

int ks_probe(const void* keys, int m, int w, const void* table, int levels,
             const void* rb, const void* re, int q, void* out, void* stream) {
  if (q <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto k = static_cast<const uint32_t*>(keys);
  auto t = static_cast<const int32_t*>(table);
  auto b = static_cast<const uint32_t*>(rb);
  auto e = static_cast<const uint32_t*>(re);
  auto o = static_cast<int32_t*>(out);
  FDB_DISPATCH_W(w, probe_kernel<W><<<blocks_for(q), kThreads, 0, s>>>(
      k, m, t, levels, b, e, q, o));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
