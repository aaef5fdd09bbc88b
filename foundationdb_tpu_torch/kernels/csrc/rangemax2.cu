// Kernel G: rangemax2 — exact range max (or min) over [lo, hi) from the
// values themselves, their 32-row chunk maxima, and one doubling table over
// the maxima of 1024-row superchunks.
//
// Replaces K14's two-level table, foundationdb_tpu/ops/rangemax.py:119
// build2 and :145 query2, which the group kernel's cross-batch phase
// (foundationdb_tpu/ops/group.py:477-504) builds once per batch over the
// running map `seg_ver` of the group's committed-write versions (up to
// 2 x 8 x (65,536 + 65,536) = 2,097,152 leaves at bench shape) and
// queries once per read. It computes what build2/query2 compute, not
// their layout: the JAX fine table (CHUNK_BITS + 1 full-width levels,
// four gathers per query) is not built, and the coarse doubling table
// sits over superchunks, so it is 1/1024 of the width (2,048 entries and
// 12 levels at bench shape) and one block builds it in one launch (a
// table over the 65,536 chunk maxima would take 17 level launches).
//
//   rm2_chunks  one block of 256 threads per superchunk s: each team of 8
//               lanes reduces one 32-row chunk from one 16-byte load per
//               lane and a shuffle reduction,
//               chunk[c] = op(values[32c : 32c + 32]), and the block's 32
//               chunk maxima reduce into table[0][s] (op identity past m
//               and past the last chunk);
//   rm2_levels  one block: table[k][i] = op(table[k-1][i],
//               table[k-1][min(i + 2^(k-1), ns - 1)]) for k = 1 .. L-1
//               (kernel B's recurrence, a barrier between levels; each
//               level is read back by the block that wrote it);
//   rm2_query   a team of 8 lanes per query, [l, h) = [lo, hi) clamped to
//               [0, m]: the head and tail partial chunks (fewer than 32
//               rows each) read from the values, the head and tail partial
//               superchunks (fewer than 32 chunks each) from the chunk
//               maxima, each as one 16-byte load per lane (a team reads a
//               whole chunk or 32 chunk maxima at once) masked to the
//               range; the whole superchunks [s0, s1) from two table
//               lookups at level floor(log2(s1 - s0)); a shuffle reduction
//               over the team. A range with no whole chunk (fewer than 64
//               rows) reads its one or two chunks of rows, one with no
//               whole superchunk its one or two groups of chunk maxima.
//               Exact for max and min; an empty range gives the identity
//               (INT32_NEG for max, INT32_POS for min), as query2.
//
// Bound on this card: bytes. The build reads the values once and writes
// m / 32 chunk maxima and L x m / 1024 table entries (4 B x m x ~1.04);
// the query reads each query's two ends and writes its answer (12 B per
// query) plus the partial chunks and superchunks it covers (at most 62
// rows, 62 chunk maxima and 2 table entries per query). Design: every
// read is a whole 128-byte line shared by a team (values and chunk maxima
// must be 16-byte aligned; torch allocations are, and the entry points
// refuse others), so a query's loads are at most four per lane and all
// independent: one memory latency however wide its range. The build is
// one pass over the values plus a table small enough to stay in L2; two
// launches build, one queries.

#include "common.cuh"

namespace {

using namespace fdb;

constexpr int kSuper = 1024;  // rows per superchunk: 32 chunks of 32
// lanes per query (and per chunk in the build): 8 x 16 bytes = 32 entries
constexpr int kTeam = 8;

template <bool MIN>
__device__ __forceinline__ int32_t op(int32_t a, int32_t b) {
  return MIN ? min(a, b) : max(a, b);
}

template <bool MIN>
__device__ __forceinline__ int32_t ident() {
  return MIN ? INT32_POS : INT32_NEG;
}

// This lane's four entries of 32-entry group c of arr[0, n) as one 16-byte
// load (the group's eight lanes read it whole), the op identity past n or
// for c < 0. arr is 16-byte aligned (the C entry points check it).
template <bool MIN>
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ arr,
                                      long long n, long long c, int lane) {
  const int32_t id = ident<MIN>();
  int4 v = make_int4(id, id, id, id);
  if (c < 0) return v;
  long long r = (c << 5) + 4 * lane;
  if (r + 3 < n) return __ldg(reinterpret_cast<const int4*>(arr + r));
  if (r < n) v.x = __ldg(arr + r);
  if (r + 1 < n) v.y = __ldg(arr + r + 1);
  if (r + 2 < n) v.z = __ldg(arr + r + 2);
  return v;
}

// op over the entries of load4(.., c, lane) whose index is in [a, b).
template <bool MIN>
__device__ __forceinline__ int32_t in_range(int4 v, long long c, int lane,
                                            long long a, long long b) {
  int32_t acc = ident<MIN>();
  if (c < 0) return acc;
  long long r = (c << 5) + 4 * lane;
  if (r >= a && r < b) acc = op<MIN>(acc, v.x);
  if (r + 1 >= a && r + 1 < b) acc = op<MIN>(acc, v.y);
  if (r + 2 >= a && r + 2 < b) acc = op<MIN>(acc, v.z);
  if (r + 3 >= a && r + 3 < b) acc = op<MIN>(acc, v.w);
  return acc;
}

// op over the kTeam lanes of a team (lanes aligned to kTeam in the warp)
template <bool MIN>
__device__ __forceinline__ int32_t team_reduce(int32_t v) {
#pragma unroll
  for (int o = kTeam / 2; o > 0; o >>= 1)
    v = op<MIN>(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One block of kTeam x 32 threads per superchunk; each team of kTeam lanes
// reduces one chunk from a 16-byte load per lane.
template <bool MIN>
__global__ void __launch_bounds__(kTeam * 32)
    chunk_kernel(const int32_t* __restrict__ values, int m,
                 int32_t* __restrict__ chunk, int nc,
                 int32_t* __restrict__ table) {
  __shared__ int32_t warp_max[kTeam];
  int lane = threadIdx.x & (kTeam - 1);
  long long c = static_cast<long long>(blockIdx.x) * 32 + threadIdx.x / kTeam;
  int4 v = load4<MIN>(values, m, c, lane);
  int32_t x = team_reduce<MIN>(
      op<MIN>(op<MIN>(v.x, v.y), op<MIN>(v.z, v.w)));
  if (lane == 0 && c < nc) chunk[c] = x;
  // the warp's 32 / kTeam chunk maxima, then the block's kTeam warps
#pragma unroll
  for (int o = 16; o >= kTeam; o >>= 1)
    x = op<MIN>(x, __shfl_xor_sync(0xffffffffu, x, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {  // all of warp 0, for the shuffles
    x = team_reduce<MIN>(threadIdx.x < kTeam ? warp_max[threadIdx.x]
                                             : ident<MIN>());
    if (threadIdx.x == 0) table[blockIdx.x] = x;
  }
}

// One block. The table is read back after the barrier that follows each
// level's writes, so it is read with plain loads (not the read-only path).
template <bool MIN>
__global__ void levels_kernel(int32_t* table, int ns, int levels) {
  for (int k = 1; k < levels; ++k) {
    int half = min(1 << (k - 1), ns - 1);
    const int32_t* prev = table + static_cast<size_t>(k - 1) * ns;
    int32_t* cur = table + static_cast<size_t>(k) * ns;
    for (int i = threadIdx.x; i < ns; i += blockDim.x)
      cur[i] = op<MIN>(prev[i], prev[min(i + half, ns - 1)]);
    __syncthreads();
  }
}

template <bool MIN>
__global__ void query_kernel(const int32_t* __restrict__ values, int m,
                             const int32_t* __restrict__ chunk, int nc,
                             const int32_t* __restrict__ table, int ns,
                             const int32_t* __restrict__ lo,
                             const int32_t* __restrict__ hi, int q,
                             int32_t* __restrict__ out) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long j = t / kTeam;
  int lane = threadIdx.x & (kTeam - 1);
  // a team past the last query still takes part in the shuffles below
  bool live = j < q;
  long long l = live ? min(max(__ldg(lo + j), 0), m) : 0;
  long long h = live ? min(max(__ldg(hi + j), 0), m) : 0;
  // at most two chunks of rows (ra, rb) and two groups of 32 chunk
  // maxima (ga, gb), -1 where unused, and the table over [s0, s1)
  long long ra = -1, rb = -1, ga = -1, gb = -1, s0 = 0, s1 = 0;
  // whole chunks inside [l, h): [c0, c1); c0 rounds l up
  long long c0 = (l + 31) >> 5, c1 = h >> 5;
  if (h > l && c0 >= c1) {  // no whole chunk: the rows, in one or two
    ra = l >> 5;
    if (((h - 1) >> 5) != ra) rb = (h - 1) >> 5;
  } else if (h > l) {
    if (l < (c0 << 5)) ra = c0 - 1;  // head rows [l, 32 c0)
    if (h > (c1 << 5)) rb = c1;      // tail rows [32 c1, h)
    // whole superchunks inside [c0, c1): [s0, s1)
    s0 = (c0 + 31) >> 5;
    s1 = c1 >> 5;
    if (s0 >= s1) {  // no whole superchunk: the chunk maxima
      ga = c0 >> 5;
      if (((c1 - 1) >> 5) != ga) gb = (c1 - 1) >> 5;
      s1 = s0;
    } else {
      if (c0 < (s0 << 5)) ga = s0 - 1;  // head chunks [c0, 32 s0)
      if (c1 > (s1 << 5)) gb = s1;      // tail chunks [32 s1, c1)
    }
  }
  // four independent 16-byte loads per lane, and the table's two
  int4 x0 = load4<MIN>(values, m, ra, lane);
  int4 x1 = load4<MIN>(values, m, rb, lane);
  int4 x2 = load4<MIN>(chunk, nc, ga, lane);
  int4 x3 = load4<MIN>(chunk, nc, gb, lane);
  int32_t acc = ident<MIN>();
  if (s1 > s0 && lane == 0) {
    int k = floor_log2(static_cast<int>(s1 - s0));
    const int32_t* row = table + static_cast<size_t>(k) * ns;
    acc = op<MIN>(__ldg(row + s0), __ldg(row + s1 - (1LL << k)));
  }
  acc = op<MIN>(acc, op<MIN>(in_range<MIN>(x0, ra, lane, l, h),
                             in_range<MIN>(x1, rb, lane, l, h)));
  acc = op<MIN>(acc, op<MIN>(in_range<MIN>(x2, ga, lane, c0, c1),
                             in_range<MIN>(x3, gb, lane, c0, c1)));
  acc = team_reduce<MIN>(acc);
  if (live && lane == 0) out[j] = acc;
}

}  // namespace

static bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

extern "C" {

int rm2_chunks(const void* values, int m, void* chunk, int nc, void* table,
               int ns, int op_min, void* stream) {
  if (m <= 0) return kNoLaunch;
  // the caller sizes the outputs: ops/rangemax.build2 (CHUNK, SUPER)
  if (nc != (m + 31LL) / 32 || ns != (m + kSuper - 1LL) / kSuper)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const int32_t*>(values);
  auto c = static_cast<int32_t*>(chunk);
  auto t = static_cast<int32_t*>(table);
  if (!aligned16(values) || !aligned16(chunk))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (op_min)
    chunk_kernel<true><<<ns, kTeam * 32, 0, s>>>(v, m, c, nc, t);
  else
    chunk_kernel<false><<<ns, kTeam * 32, 0, s>>>(v, m, c, nc, t);
  return static_cast<int>(cudaGetLastError());
}

int rm2_levels(void* table, int ns, int levels, int op_min, void* stream) {
  if (ns <= 0 || levels <= 1) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto t = static_cast<int32_t*>(table);
  if (op_min)
    levels_kernel<true><<<1, 1024, 0, s>>>(t, ns, levels);
  else
    levels_kernel<false><<<1, 1024, 0, s>>>(t, ns, levels);
  return static_cast<int>(cudaGetLastError());
}

int rm2_query(const void* values, int m, const void* chunk, int nc,
              const void* table, int ns, const void* lo, const void* hi,
              int q, int op_min, void* out, void* stream) {
  if (q <= 0) return kNoLaunch;
  if (m <= 0 || nc != (m + 31LL) / 32 || ns != (m + kSuper - 1LL) / kSuper)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(values) || !aligned16(chunk))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const int32_t*>(values);
  auto c = static_cast<const int32_t*>(chunk);
  auto t = static_cast<const int32_t*>(table);
  auto l = static_cast<const int32_t*>(lo);
  auto h = static_cast<const int32_t*>(hi);
  auto o = static_cast<int32_t*>(out);
  int blocks = blocks_for(static_cast<long long>(q) * kTeam);
  if (op_min)
    query_kernel<true><<<blocks, kThreads, 0, s>>>(v, m, c, nc, t, ns, l, h,
                                                   q, o);
  else
    query_kernel<false><<<blocks, kThreads, 0, s>>>(v, m, c, nc, t, ns, l, h,
                                                    q, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
