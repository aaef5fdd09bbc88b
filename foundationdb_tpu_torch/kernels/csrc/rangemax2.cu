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
// 12 levels at bench shape).
//
//   rm2_build   ONE launch of 1,024-thread blocks, kBuildPerSm an SM, each
//               walking four superchunks at a time: each team of 8 lanes
//               reduces one 32-row chunk from one 16-byte load per lane
//               and a shuffle reduction, chunk[c] = op(values[32c : 32c +
//               32]), and each superchunk's 32 chunk maxima (8 warps)
//               reduce into table[0][s] (op identity past m and past the
//               last chunk). Each block then takes a ticket from an arrival
//               counter on the card (after a __threadfence); the last to
//               arrive reads level 0 back and builds levels 1 .. L-1 in
//               shared memory, two buffers of ns entries (16 KB at 2,048),
//               two levels a step from the level below them (level k + d
//               at i is op of level k - 1 at i + j 2^(k-1), j < 2^(d+1),
//               clamped at ns - 1: kernel B's recurrence), one
//               __syncthreads a step, each level written out once,
//               coalesced; then it sets the counter back to 0. Nothing
//               comes from the host, so a CUDA graph replays the launch as
//               it is. A counter that did not start at 0 (a ticket past
//               the grid, or more tickets than blocks) fails the launch
//               by a device assert, never a wrong table in silence. At most kMaxSuper superchunks (the buffers' 128
//               KB): 16,777,216 values; the wrapper raises past that. The
//               last block's tail, level 0's read back and the levels on
//               one SM, is serial work the grid cannot share, so the one
//               launch saves a launch and its host gap, not device time
//               (kernels/phase_trace.py --kernel rangemax2_build);
//   rm2_query   one thread per query, [l, h) = [lo, hi) clamped to [0, m]:
//               a range of at most kShortRows rows (every read at a uniform
//               stream's own ranks: spans 1 and 2) loads just those rows,
//               all at once, and answers. The warp then takes its wider
//               queries (a ballot) four at a time, a team of 8 lanes each:
//               the head and tail partial chunks (fewer than 32 rows each)
//               from the values, the head and tail partial superchunks
//               (fewer than 32 chunks each) from the chunk maxima, each as
//               one 16-byte load per lane (a team reads a whole chunk or 32
//               chunk maxima at once) masked to the range; the whole
//               superchunks [s0, s1) from two table lookups at level
//               floor(log2(s1 - s0)); a shuffle reduction over the team,
//               whose first lane writes the answer. A range with no whole
//               chunk reads its one or two chunks of rows, one with no
//               whole superchunk its one or two groups of chunk maxima.
//               Exact for max and min; an empty range gives the identity
//               (INT32_NEG for max, INT32_POS for min), as query2.
//
// Bound on this card: bytes. The build reads the values once and writes
// m / 32 chunk maxima and L x m / 1024 table entries (4 B x m x ~1.04);
// the query reads each query's two ends and writes its answer (12 B per
// query) plus the rows, partial chunks and superchunks it covers (at most
// 62 rows, 62 chunk maxima and 2 table entries per query). Values and
// chunk maxima must be 16-byte aligned (torch allocations are, and the
// entry points refuse others).

#include <cassert>

#include "common.cuh"

#ifndef FDB_MARK
#define FDB_MARK(k)  // phase_trace.py's %globaltimer marks; none here
#endif
#ifndef FDB_MARK_AFTER
#define FDB_MARK_AFTER(k, v)  // a mark once v has arrived; none here
#endif

namespace {

using namespace fdb;

constexpr int kSuper = 1024;  // rows per superchunk: 32 chunks of 32
// lanes per query (and per chunk in the build): 8 x 16 bytes = 32 entries
constexpr int kTeam = 8;
// the build's block: kQuad superchunks of 32 chunks, a team a chunk
constexpr int kQuad = 4;
constexpr int kBuildThreads = kQuad * kTeam * 32;
// the most superchunks the last block's two level buffers hold
constexpr int kMaxSuper = 16384;
// rows a query's own thread reads; a wider range takes a team
constexpr int kShortRows = 8;
// entries a thread of the last block builds a step (2,048 superchunks:
// every entry of a level in one step), and the levels a step builds
constexpr int kLevelUnroll = 2;
constexpr int kLevelsAtOnce = 2;
// the build's blocks an SM, each walking kQuad superchunks at a time
constexpr int kBuildPerSm = 2;

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

// op over [l, h) (clamped, l < h or empty) by a team of kTeam lanes
// (tl its lane): the partial chunks' rows, the partial superchunks' chunk
// maxima and the table, four 16-byte loads a lane and two table loads, all
// independent, then a shuffle reduction; every lane of the warp calls it.
template <bool MIN>
__device__ __forceinline__ int32_t team_range(
    const int32_t* __restrict__ values, int m,
    const int32_t* __restrict__ chunk, int nc,
    const int32_t* __restrict__ table, int ns, long long l, long long h,
    int tl) {
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
  int4 x0 = load4<MIN>(values, m, ra, tl);
  int4 x1 = load4<MIN>(values, m, rb, tl);
  int4 x2 = load4<MIN>(chunk, nc, ga, tl);
  int4 x3 = load4<MIN>(chunk, nc, gb, tl);
  int32_t acc = ident<MIN>();
  if (s1 > s0 && tl == 0) {
    int k = floor_log2(static_cast<int>(s1 - s0));
    const int32_t* row = table + static_cast<size_t>(k) * ns;
    acc = op<MIN>(__ldg(row + s0), __ldg(row + s1 - (1LL << k)));
  }
  acc = op<MIN>(acc, op<MIN>(in_range<MIN>(x0, ra, tl, l, h),
                             in_range<MIN>(x1, rb, tl, l, h)));
  acc = op<MIN>(acc, op<MIN>(in_range<MIN>(x2, ga, tl, c0, c1),
                             in_range<MIN>(x3, gb, tl, c0, c1)));
  return team_reduce<MIN>(acc);
}

// Blocks of kBuildThreads, kQuad superchunks at a time: each team of kTeam
// lanes reduces one chunk from a 16-byte load per lane, each 8 warps one
// superchunk. The last block to take a ticket builds the table's levels
// above 0 in shared memory (2 x ns entries, dynamic).
template <bool MIN>
__global__ void __launch_bounds__(kBuildThreads)
    build_kernel(const int32_t* __restrict__ values, int m,
                 int32_t* __restrict__ chunk, int nc, int32_t* table, int ns,
                 int levels, unsigned int* arrive) {
  extern __shared__ int32_t lv[];  // [2][ns], the last block's
  __shared__ int32_t warp_max[kBuildThreads / 32];
  __shared__ bool last;
  FDB_MARK(0)
  const int lane = threadIdx.x & (kTeam - 1);
  const int quads = (ns + kQuad - 1) / kQuad;
  for (int g = blockIdx.x; g < quads; g += gridDim.x) {
    long long c = static_cast<long long>(g) * kQuad * 32 + threadIdx.x / kTeam;
    int4 v = load4<MIN>(values, m, c, lane);
    int32_t x = team_reduce<MIN>(
        op<MIN>(op<MIN>(v.x, v.y), op<MIN>(v.z, v.w)));
    if (lane == 0 && c < nc) chunk[c] = x;
    // the warp's 32 / kTeam chunk maxima, then each superchunk's 8 warps
#pragma unroll
    for (int o = 16; o >= kTeam; o >>= 1)
      x = op<MIN>(x, __shfl_xor_sync(0xffffffffu, x, o));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = x;
    __syncthreads();
    if (threadIdx.x < 32) {  // all of warp 0, for the shuffles
      x = team_reduce<MIN>(threadIdx.x < kBuildThreads / 32
                               ? warp_max[threadIdx.x]
                               : ident<MIN>());
      const int q = threadIdx.x / kTeam;  // lane 8q holds superchunk q's
      const int sc = g * kQuad + q;
      if (lane == 0 && q < kQuad && sc < ns) table[sc] = x;
    }
    __syncthreads();  // warp_max is the next quad's
  }
  if (threadIdx.x == 0) {
    FDB_MARK(1)
    __threadfence();  // level 0's entries are seen before the ticket
    const unsigned ticket = atomicAdd(arrive, 1u);
    // a launch starts at 0: a ticket past the grid is a counter left off
    assert(ticket < gridDim.x);
    last = ticket == gridDim.x - 1;
    FDB_MARK_AFTER(2, static_cast<int>(last))
  }
  __syncthreads();
  if (!last) return;
  // -- the last block: every block's level-0 entry is in, fenced before
  //    its ticket; read it past L1 (the other SMs wrote it)
  __threadfence();
  int32_t* prev = lv;
  int32_t* cur = lv + ns;
  // a thread's kLevelUnroll entries a step, their loads issued together
  // (one L2 trip for level 0, one shared-memory trip a step above it)
  constexpr int kStep = kLevelUnroll * kBuildThreads;
  for (int i0 = threadIdx.x; i0 < ns; i0 += kStep) {
    int32_t y[kLevelUnroll];
#pragma unroll
    for (int u = 0; u < kLevelUnroll; ++u) {
      const int i = i0 + u * kBuildThreads;
      y[u] = i < ns ? __ldcg(table + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kLevelUnroll; ++u)
      if (i0 + u * kBuildThreads < ns) prev[i0 + u * kBuildThreads] = y[u];
  }
  __syncthreads();
  FDB_MARK(3)
  // levels k .. k + kLevelsAtOnce - 1 from level k - 1 alone (one barrier
  // a step): level k + d at i is op of level k - 1 at i + j 2^(k-1), j <
  // 2^(d+1), each clamped at ns - 1 (an idempotent op: the clamp of the
  // recurrence); only the step's top level goes back to shared memory
  for (int k = 1; k < levels; k += kLevelsAtOnce) {
    const int h = 1 << (k - 1);
    const int top = min(k + kLevelsAtOnce, levels) - 1;
    for (int i0 = threadIdx.x; i0 < ns; i0 += kStep) {
      int32_t p[kLevelUnroll][1 << kLevelsAtOnce];
#pragma unroll
      for (int u = 0; u < kLevelUnroll; ++u) {
        const int i = i0 + u * kBuildThreads;
#pragma unroll
        for (int j = 0; j < (1 << kLevelsAtOnce); ++j)
          p[u][j] = i < ns && j < (2 << (top - k))
                        ? prev[min(i + j * h, ns - 1)]
                        : ident<MIN>();
      }
#pragma unroll
      for (int u = 0; u < kLevelUnroll; ++u) {
        const int i = i0 + u * kBuildThreads;
        if (i >= ns) continue;
        int32_t y = p[u][0];
#pragma unroll
        for (int d = 0; d < kLevelsAtOnce; ++d) {
          if (k + d > top) break;
#pragma unroll
          for (int j = 1 << d; j < (2 << d); ++j) y = op<MIN>(y, p[u][j]);
          table[static_cast<size_t>(k + d) * ns + i] = y;
        }
        cur[i] = y;
      }
    }
    __syncthreads();  // the step's top level whole before the next reads
    int32_t* t = prev;
    prev = cur;
    cur = t;
  }
  FDB_MARK(4)
  if (threadIdx.x == 0) {  // every block has taken its ticket
    const unsigned taken = atomicExch(arrive, 0u);
    assert(taken == gridDim.x);  // none past the last, none before 0
  }
}

template <bool MIN>
__global__ void __launch_bounds__(kThreads)
    query_kernel(const int32_t* __restrict__ values, int m,
                 const int32_t* __restrict__ chunk, int nc,
                 const int32_t* __restrict__ table, int ns,
                 const int32_t* __restrict__ lo,
                 const int32_t* __restrict__ hi, int q,
                 int32_t* __restrict__ out) {
  FDB_MARK(0)
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int lane = threadIdx.x & 31;
  // no early exit: the ballot and the teams' shuffles need every lane
  const bool live = j < q;
  const long long l = live ? min(max(__ldg(lo + j), 0), m) : 0;
  const long long h = live ? min(max(__ldg(hi + j), 0), m) : 0;
  FDB_MARK_AFTER(1, static_cast<int>(l ^ h))
  const bool wide = h - l > kShortRows;
  int32_t acc = ident<MIN>();
  if (!wide) {  // the range's own rows, all loads in flight together
    int32_t r[kShortRows];
#pragma unroll
    for (int i = 0; i < kShortRows; ++i)
      r[i] = l + i < h ? __ldg(values + l + i) : ident<MIN>();
#pragma unroll
    for (int i = 0; i < kShortRows; ++i) acc = op<MIN>(acc, r[i]);
    if (live) out[j] = acc;
  }
  FDB_MARK_AFTER(2, acc)
  // the warp's wide queries, four at a time: team t takes the t-th
  // lowest still pending
  unsigned pending = __ballot_sync(0xffffffffu, live && wide);
  const int team = lane / kTeam, tl = lane & (kTeam - 1);
  while (pending) {  // warp-uniform
    unsigned mine = pending;
    for (int t = 0; t < team; ++t) mine &= mine - 1;
    const int src = mine ? __ffs(mine) - 1 : lane;
    const long long a = __shfl_sync(0xffffffffu, l, src);
    const long long b = __shfl_sync(0xffffffffu, h, src);
    const int32_t x = team_range<MIN>(values, m, chunk, nc, table, ns,
                                      mine ? a : 0, mine ? b : 0, tl);
    if (mine && tl == 0) out[j - lane + src] = x;
#pragma unroll
    for (int t = 0; t < 32 / kTeam; ++t) pending &= pending - 1;
  }
  FDB_MARK(3)
}

struct Plan {
  int blocks;  // the most blocks of the build's grid
  int err;     // a CUDA error from asking, 0 if none
};

// The build's plan, asked once per op: the shared memory the last block's
// two level buffers may take, and the grid's cap, kBuildPerSm an SM.
template <bool MIN>
const Plan& build_plan() {
  static const Plan p = [] {
    Plan r{0, 0};
    cudaError_t e = cudaFuncSetAttribute(
        build_kernel<MIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        2 * kMaxSuper * static_cast<int>(sizeof(int32_t)));
    int dev = 0, sms = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    r.err = static_cast<int>(e);
    r.blocks = kBuildPerSm * sms;
    return r;
  }();
  return p;
}

}  // namespace

static bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

extern "C" {

int rm2_build(const void* values, int m, void* chunk, int nc, void* table,
              int ns, int levels, void* arrive, int op_min, void* stream) {
  if (m <= 0) return kNoLaunch;
  // the caller sizes the outputs: ops/rangemax.build2 (CHUNK, SUPER)
  if (nc != (m + 31LL) / 32 || ns != (m + kSuper - 1LL) / kSuper ||
      ns > kMaxSuper || levels < 1 || levels > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(values) || !aligned16(chunk))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Plan& plan = op_min ? build_plan<true>() : build_plan<false>();
  if (plan.err) return plan.err;
  const int quads = (ns + kQuad - 1) / kQuad;
  const int grid = plan.blocks < quads ? plan.blocks : quads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const int32_t*>(values);
  auto c = static_cast<int32_t*>(chunk);
  auto t = static_cast<int32_t*>(table);
  auto a = static_cast<unsigned int*>(arrive);
  const size_t smem = 2 * static_cast<size_t>(ns) * sizeof(int32_t);
  if (op_min)
    build_kernel<true><<<grid, kBuildThreads, smem, s>>>(v, m, c, nc, t,
                                                         ns, levels, a);
  else
    build_kernel<false><<<grid, kBuildThreads, smem, s>>>(v, m, c, nc, t,
                                                          ns, levels, a);
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
  if (op_min)
    query_kernel<true><<<blocks_for(q), kThreads, 0, s>>>(v, m, c, nc, t, ns,
                                                          l, h, q, o);
  else
    query_kernel<false><<<blocks_for(q), kThreads, 0, s>>>(v, m, c, nc, t,
                                                           ns, l, h, q, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
