// Kernel A: keysearch — the fenced search over sorted packed keys, the
// segment-id counts, the doubling-table query, and the history probe.
//
// Replaces (JAX/XLA programs of foundationdb_tpu):
//   search  K2 ops/keys.py:50 searchsorted: left, right, or both sides of
//           each query in one launch;
//   counts  K6 ops/group.py:105 _sorted_counts: off[t] = #{ids < t} for
//           t in [0, n_seg] over nondecreasing segment ids;
//   query   K3 ops/rangemax.py:71 query;
//   probe   K4 ops/history.py:77 query_reads_vmax: il = search_right(rb)-1,
//           ir = search_left(re)-1, then a max query over [max(il,0), ir+1).
//
// Bound on this card, search and probe: the passes of dependent loads,
// not bytes (the tier fits the 50 MB L2; the byte floor is the queries
// in, the indices out and the key rows that decide them). Both run on
// the fenced tier search of tier_search.cuh, which kernel E shares; its
// note says why the fence, the 16-byte row loads and the window. The
// search's first design (one thread a query, ~20 steps of W dependent
// word loads) was the probe's too; the probe went 19.2 -> 10.0 us on the
// fence (an H100, chip_smoke.py --probe-fold). Its both-sides mode takes
// the left index by the fence and its bucket and the rows equal to the
// query from one window load, so a right and a left search of one key
// cost one search (ops/group._block_spans).
//
// The counts are one coalesced pass, no search a segment id: the ids are
// sorted and the t's dense, so a block owns a tile of kCountTile segment
// ids [t0, t1), finds a = #{ids < t0} and b = #{ids < t1} by two warps'
// searches side by side (rounds of a load a lane, the first about the
// interpolated place: two where it was near, at most six at 524,288
// ids, in place of ~19 dependent loads a thread a segment id; a first
// design, the whole block's 513-ary search, issued 512 scattered loads a
// round and ran slower than the search it replaced: 17.4 against 8.2 us
// at a group of 8's 524,288 ids), counts ids[a, b) into a shared-memory
// histogram with integer atomics, one a run of equal ids a warp
// (__match_any_sync: the padding rows, all at id B, are one run, which
// a thread a row would serialise on), and writes off[t] = a + the
// histogram's exclusive scan. Order does not matter, and a tile whose
// ids outnumber the block strides over them. Bound: the ids read once
// and the offsets written once.
//
// The query reads a table [L, m], t[k][i] = op(values[i : i + 2^k]), of
// ANY depth L from 1 to bit_length(m - 1) + 1, and returns op over
// values[lo, hi) clamped to [0, m) exactly (the identity where empty):
// a span of at most 2^L takes two lookups at level min(floor(log2(span)),
// L - 1), both loaded together after both ends (every span over a full
// table, so the probe's and the sweep's callers read what they read
// before); a longer span the level-(L - 1) entries at lo, lo + 2^(L-1),
// ..., and one at hi - 2^(L-1), taken by the whole warp in turn (a ballot
// of its long queries), 32 x kLongUnroll entries a step, then a shuffle
// reduction: the read over all m leaves costs m / 2^(L-1) / 32 loads a
// lane, not a serial loop. Why: the exact fixpoint's reads span at most
// a few hundred local ranks (ops/group.py FIXPOINT_LEVELS), so it asks
// kernel B for a table of that depth only, not the 19 levels of its 2^18
// leaves; B then writes (1 + L) in place of (1 + 19) x 4 B a leaf and
// takes no grid sync. The query is two dependent memory trips and the
// launch ramp: latency, not bytes, bounds it.
//
// The probe's byte floor is the key rows that decide its reads' ends (the
// rows on both sides of each end, chip_smoke.py's deciding_rows), the
// reads and the output, each read or written once. Each read takes
// tier_ends (the begin's right search by the fence and its bucket, the
// end from the begin by a gallop over the fence and the window), then
// the table's two loads, issued together. Reads with re <= rb (inverted
// or empty, and the all-ones dead rows) take the full search for re,
// which keeps the plain formula's answer for them exactly. The passes,
// not the latency, bound it: a read's two bucket searches run in one
// loop, their loads in flight together, measured no faster.

#include "common.cuh"
#include "tier_search.cuh"

namespace {

using namespace fdb;

constexpr int kBoth = 2;          // the search's side: 0 left, 1 right, 2 both

// Each query's left or right index, or both (left to out[i], right to
// out[q + i]), on the fence staged once a block.
template <int W, int SIDE>
__global__ void __launch_bounds__(kFenceThreads)
    search_kernel(const uint32_t* __restrict__ keys, int m,
                  const uint32_t* __restrict__ queries, int q,
                  int32_t* __restrict__ out, int shift, int nf) {
  extern __shared__ uint32_t fence[];
  FDB_MARK(0)
  stage_fence<W>(fence, keys, shift, nf);
  FDB_MARK(1)
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < q;
       i += gridDim.x * blockDim.x) {
    uint32_t k[W];
    ld_row<W>(k, queries + static_cast<size_t>(i) * W);
    if (SIDE == kBoth) {
      int left, right;
      tier_both<W>(keys, m, fence, nf, shift, k, left, right);
      out[i] = left;
      out[q + i] = right;
    } else {
      int c;
      out[i] = tier_bound<W, SIDE == 1>(keys, m, fence, nf, shift, k, c);
    }
    FDB_MARK(5)
  }
}

constexpr int kCountThreads = 512;
constexpr int kCountTile = 2 * kCountThreads;  // segment ids a block owns

// #{ids < x} over the nondecreasing ids[0, n), compared as uint32 (the
// W = 1 search's order), found by one warp in rounds of one load a lane:
// the loads below x are a prefix of a round's, so a ballot's count names
// the part of the range that holds the answer. The first round's loads
// are 32 ids apart about x's interpolated place x * n / (n_seg + 1)
// (K6's ids run about one a segment, so the answer most often lies
// among them: then one round of 32 ids is left); past them, each round
// splits the range left into 33 parts; a range of at most 32 ids takes a
// last round. Two rounds where the place was near, at most six at
// 524,288 ids.
__device__ __forceinline__ int warp_count_below(
    const uint32_t* __restrict__ ids, int n, int n_seg, uint32_t x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  if (n > 32 * 32) {
    const long long guess = static_cast<long long>(x) * n / (n_seg + 1LL);
    const int w0 = static_cast<int>(min(max(guess - 16 * 32, 0LL),
                                        n - 32 * 32LL));
    // loads at w0 + 31, w0 + 63, ..., w0 + 1023
    const int cnt = __popc(__ballot_sync(
        0xffffffffu, __ldg(ids + w0 + 32 * lane + 31) < x));
    lo = cnt == 0 ? lo : w0 + 32 * cnt;
    hi = cnt == 32 ? hi : w0 + 32 * cnt + 31;
  }
  while (hi - lo > 32) {  // warp-uniform
    const long long len = hi - lo;
    const int p = lo + static_cast<int>((lane + 1) * len / 33);
    const int cnt = __popc(__ballot_sync(0xffffffffu, __ldg(ids + p) < x));
    // the answer lies in (p[cnt - 1], p[cnt]]
    const int a = cnt == 0 ? lo : lo + static_cast<int>(cnt * len / 33) + 1;
    hi = cnt == 32 ? hi : lo + static_cast<int>((cnt + 1) * len / 33);
    lo = a;
  }
  const int p = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu,
                                   p < hi && __ldg(ids + p) < x));
}

// off[t] = #{ids < t} for t in [0, n_seg]: a block a tile of kCountTile
// segment ids [t0, t1) (two bins a thread), warps 0 and 1 searching a =
// #{ids < t0} and b = #{ids < t1} together, a histogram of ids[a, b), a
// scan.
__global__ void __launch_bounds__(kCountThreads)
    counts_kernel(const uint32_t* __restrict__ ids, int n, int n_seg,
                  int32_t* __restrict__ off) {
  __shared__ int bins[kCountTile];
  __shared__ int warp_sums[32];
  __shared__ int ends[2];
  const int t0 = blockIdx.x * kCountTile;
  const int t1 = min(t0 + kCountTile, n_seg + 1);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int c = warp_count_below(
        ids, n, n_seg, static_cast<uint32_t>(warp == 0 ? t0 : t1));
    if ((threadIdx.x & 31) == 0) ends[warp] = c;
  }
  bins[2 * threadIdx.x] = 0;
  bins[2 * threadIdx.x + 1] = 0;
  __syncthreads();
  const int a = ends[0], b = ends[1];
  const uint32_t span = static_cast<uint32_t>(t1 - t0);
  for (int base = a; base < b; base += kCountThreads) {  // block-uniform
    const int i = base + threadIdx.x;
    int bin = -1;  // ids[a, b) lie in [t0, t1); an id outside (unsorted
    if (i < b) {   // ids break the contract) is dropped, not written
      const uint32_t d = __ldg(ids + i) - static_cast<uint32_t>(t0);
      if (d < span) bin = static_cast<int>(d);
    }
    const unsigned run = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && (threadIdx.x & 31) == __ffs(run) - 1)
      atomicAdd(&bins[bin], __popc(run));
  }
  __syncthreads();
  const int v0 = bins[2 * threadIdx.x], v1 = bins[2 * threadIdx.x + 1];
  int total;
  const int incl = block_inclusive_scan(v0 + v1, warp_sums, &total);
  const int t = t0 + 2 * static_cast<int>(threadIdx.x);
  if (t < t1) off[t] = a + incl - v0 - v1;
  if (t + 1 < t1) off[t + 1] = a + incl - v1;
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

constexpr int kLongUnroll = 4;  // a lane's long-path loads in flight

// One thread a query over a table of any depth `levels` (at most
// bit_length(m - 1) + 1). Both ends are loaded before any branch; a span
// of at most 2^levels takes its two lookups, issued together; the warp
// then takes its long queries in turn (a ballot), 32 x kLongUnroll
// level-(levels - 1) entries a step, and reduces them by shuffles.
template <bool MIN>
__global__ void __launch_bounds__(kThreads)
    query_kernel(const int32_t* __restrict__ table, int levels, int m,
                 const int32_t* __restrict__ lo,
                 const int32_t* __restrict__ hi, int q,
                 int32_t* __restrict__ out) {
  constexpr int32_t kIdent = MIN ? INT32_POS : INT32_NEG;
  FDB_MARK(0)
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = i < q;  // no early exit: the ballot needs every lane
  const int l = live ? __ldg(lo + i) : 0;
  const int h = live ? __ldg(hi + i) : 0;
  FDB_MARK_AFTER(1, l ^ h)
  const int loc = min(max(l, 0), m);
  const int hic = min(max(h, 0), m);
  const int span = hic - loc;
  // 2^levels > m >= span for levels >= 31: never long there
  const bool lng = levels < 31 && span > (1 << levels);
  int32_t acc = kIdent;
  if (span > 0 && !lng) {
    const int k = min(floor_log2(span), levels - 1);
    const int32_t* row = table + static_cast<size_t>(k) * m;
    const int32_t va = __ldg(row + loc);
    const int32_t vb = __ldg(row + hic - (1 << k));
    acc = MIN ? min(va, vb) : max(va, vb);
  }
  FDB_MARK_AFTER(2, acc)
  unsigned pending = __ballot_sync(0xffffffffu, live && lng);
  if (pending) {  // warp-uniform
    const int half = 1 << (levels - 1);
    const int32_t* row = table + static_cast<size_t>(levels - 1) * m;
    while (pending) {
      const int src = __ffs(pending) - 1;
      pending &= pending - 1;
      const int a = __shfl_sync(0xffffffffu, loc, src);
      const int b = __shfl_sync(0xffffffffu, hic, src);
      const int n = (b - a - 1) / half + 1;  // entries; the last at b - half
      int32_t x = kIdent;
      for (int j0 = lane; j0 < n; j0 += 32 * kLongUnroll) {
        int32_t v[kLongUnroll];
#pragma unroll
        for (int u = 0; u < kLongUnroll; ++u) {
          const int j = j0 + 32 * u;
          v[u] = j < n ? __ldg(row + min(a + j * half, b - half)) : kIdent;
        }
#pragma unroll
        for (int u = 0; u < kLongUnroll; ++u)
          x = MIN ? min(x, v[u]) : max(x, v[u]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const int32_t y = __shfl_xor_sync(0xffffffffu, x, o);
        x = MIN ? min(x, y) : max(x, y);
      }
      if (lane == src) acc = x;
    }
  }
  FDB_MARK_AFTER(3, acc)
  if (live) out[i] = acc;
}


template <int W>
__global__ void __launch_bounds__(kFenceThreads)
    probe_kernel(const uint32_t* __restrict__ keys, int m,
                 const int32_t* __restrict__ table, int levels,
                 const uint32_t* __restrict__ rb,
                 const uint32_t* __restrict__ re, int q,
                 int32_t* __restrict__ out, int shift, int nf) {
  extern __shared__ uint32_t fence[];
  FDB_MARK(0)
  stage_fence<W>(fence, keys, shift, nf);
  FDB_MARK(1)
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < q;
       i += gridDim.x * blockDim.x) {
    uint32_t kb[W], ke[W];
    ld_row<W>(kb, rb + static_cast<size_t>(i) * W);
    ld_row<W>(ke, re + static_cast<size_t>(i) * W);
    int first, p;
    tier_ends<W>(keys, m, fence, nf, shift, kb, ke, first, p);
    out[i] = table_query<false>(table, levels, m, max(first - 1, 0), p);
    FDB_MARK(5)
  }
}

}  // namespace

extern "C" {

int ks_search(const void* keys, int m, int w, const void* queries, int q,
              int side, void* out, void* stream) {
  if (q <= 0) return kNoLaunch;
  if (side < 0 || side > kBoth) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto k = static_cast<const uint32_t*>(keys);
  auto qs = static_cast<const uint32_t*>(queries);
  auto o = static_cast<int32_t*>(out);
  const Fence f = fence_of(m, w);
  const int blocks = fence_blocks(q);
  FDB_DISPATCH_W(w, {
    if (side == 0)
      search_kernel<W, 0><<<blocks, kFenceThreads, f.smem, s>>>(
          k, m, qs, q, o, f.shift, f.nf);
    else if (side == 1)
      search_kernel<W, 1><<<blocks, kFenceThreads, f.smem, s>>>(
          k, m, qs, q, o, f.shift, f.nf);
    else
      search_kernel<W, kBoth><<<blocks, kFenceThreads, f.smem, s>>>(
          k, m, qs, q, o, f.shift, f.nf);
  });
  return static_cast<int>(cudaGetLastError());
}

int ks_counts(const void* ids, int n, int n_seg, void* off, void* stream) {
  if (n_seg < 0 || n < 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = static_cast<int>((n_seg + 1LL + kCountTile - 1) /
                                      kCountTile);
  counts_kernel<<<blocks, kCountThreads, 0, s>>>(
      static_cast<const uint32_t*>(ids), n, n_seg, static_cast<int32_t*>(off));
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
  const Fence f = fence_of(m, w);
  FDB_DISPATCH_W(w, {
    probe_kernel<W><<<fence_blocks(q), kFenceThreads, f.smem, s>>>(
        k, m, t, levels, b, e, q, o, f.shift, f.nf);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
