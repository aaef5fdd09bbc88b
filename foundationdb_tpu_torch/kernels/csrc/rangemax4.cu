// Kernel M: rangemax4's query — op over [lo, hi) against the radix-4 table.
//
// Replaces K19's query4, foundationdb_tpu/ops/rangemax.py:210: per query,
// loc/hic = lo/hi clipped to [0, m], k = min(floor(log2(max(hic - loc,
// 1))) >> 1, L - 1), s = 4^k, and op over the four spans of s starting at
// clamp(min(loc + j*s, hic - s), 0, m-1), j = 0..3 (overlapping, exact
// for max and min); the identity where hic <= loc. Kernel M's build and
// cover are kernels B's and C's at radix 4 (rangemax_build.cu rm4_build,
// min_cover.cu mc_cover4).
//
// Bound on this card: bytes. A query reads lo and hi and writes its answer
// (12 B) and gathers up to four 4-byte table entries: 0.55 us at 65,536
// queries. One thread a query, as A's query entry: the work is two
// dependent memory round trips (the ends, then the four gathers, issued
// together) and the launch, which more queries a thread do not shorten
// (phase_trace.py rangemax4_query).

#include "common.cuh"

#ifndef FDB_MARK
#define FDB_MARK(k)  // phase_trace.py's %globaltimer marks; none here
#endif
#ifndef FDB_MARK_AFTER
#define FDB_MARK_AFTER(k, v)  // a mark once v has arrived; none here
#endif

namespace {

using namespace fdb;

template <bool MIN>
__device__ __forceinline__ int32_t op(int32_t a, int32_t b) {
  return MIN ? min(a, b) : max(a, b);
}

template <bool MIN>
__global__ void query_kernel(const int32_t* __restrict__ table, int levels,
                             int m, const int32_t* __restrict__ lo,
                             const int32_t* __restrict__ hi, int q,
                             int32_t* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  FDB_MARK(0)
  int loc = min(max(lo[i], 0), m);
  int hic = min(max(hi[i], 0), m);
  FDB_MARK_AFTER(1, loc ^ hic)
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
  FDB_MARK_AFTER(2, v)
  out[i] = v;
}

}  // namespace

extern "C" {

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

}  // extern "C"
