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
//
// Bound on this card, search and query: a search reads ~log2(M) rows per
// query from a key array that fits the 50 MB L2 (786,432 x 3 words =
// 9.4 MB at bench shape), so the cost is dependent-load latency, not
// bandwidth. Design: one thread per query, the query key held in
// registers, compare as uint32 word by word; many queries in flight hide
// the latency.
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
// reads and the output, each read or written once. The first design ran
// two full searches a read, ~20 steps each, each step's row compare
// issuing its W word loads one after another (less_rm's early exit): 17.7
// us at long reads, 19.2 at the uniform stream's point reads (an H100,
// chip_smoke.py --probe-fold). Every warp of a batch is resident at once,
// and a step's uncoalesced loads cost the L1 one pass per distinct line
// each (kernels/phase_trace.py --kernel keysearch_probe: a step in global
// memory ~0.35 us with every warp of the SM issuing); so this design cuts
// the passes a read makes:
//   fence   each block stages every 2^s-th row of the tier (the fence, at
//           most kFenceBytes: s = 10 at 786,432 x 3 words, 768 rows, 9
//           KB) in shared memory by 4-byte cp.async, once, and strides
//           over its reads; the top levels of a search run there, then at
//           most s steps in global memory, each loading its row as the
//           16-byte chunks that hold it (1.5 loads a row at W = 3, in
//           place of 3). A sentinel tail costs nothing: its rows are
//           fence rows like any other. A larger fence stages longer than
//           it saves (24 and 48 KB measured slower at both shapes);
//   window  the end from the begin: for rb < re every row up to il is
//           <= rb < re, so search_left(re) >= il + 1, and re's fence
//           count comes by a gallop from rb's. Where no fence row lies
//           between (a point read: always), the kWindow rows after il
//           (the JAX program's 4-boundary window) are loaded in one go
//           and one of them >= re is the answer; past them, the rest of
//           that bucket. Otherwise re's own bucket, from il + 1 on. Reads
//           with re <= rb (inverted or empty, and the all-ones dead rows)
//           take the full search for re, which keeps the plain formula's
//           answer for them exactly (an inverted read strictly inside one
//           segment returns that segment's version; elsewhere the window
//           is empty);
//   gather  the table's two loads, issued together.
// The passes, not the latency, bound it: a read's two bucket searches run
// in one loop, their loads in flight together, measured no faster.

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

#ifndef FDB_MARK
#define FDB_MARK(k)  // phase_trace.py's %globaltimer marks; none here
#endif
#ifndef FDB_MARK_AFTER
#define FDB_MARK_AFTER(k, v)  // a mark once v has arrived; none here
#endif

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

// ---------------------------------------------------------------------------
// the probe

constexpr int kProbeThreads = 512;
constexpr int kFenceBytes = 12 * 1024;    // the fence's most bytes
constexpr int kWindow = 4;                // rows after il loaded at once

// a < b for W-word keys in registers, every word compared (no branch)
template <int W>
__device__ __forceinline__ bool lt_rr(const uint32_t (&a)[W],
                                      const uint32_t (&b)[W]) {
  bool lt = false;
#pragma unroll
  for (int i = W - 1; i >= 0; --i)
    lt = a[i] < b[i] ? true : (a[i] > b[i] ? false : lt);
  return lt;
}

// The search's predicate on a row: true while the answer lies past it.
template <int W, bool RIGHT>
__device__ __forceinline__ bool past(const uint32_t (&row)[W],
                                     const uint32_t (&q)[W]) {
  return RIGHT ? !lt_rr<W>(q, row) : lt_rr<W>(row, q);
}

template <int W>
__device__ __forceinline__ void fence_row(uint32_t (&r)[W],
                                          const uint32_t* fence, int j) {
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = fence[j * W + i];
}

// Words [p, p + n) (n <= N) from the aligned 16-byte chunks that hold
// them: ceil((p % 16 + 4n) / 16) vector loads in place of n word loads
// (an uncoalesced load costs the L1 a pass per distinct line whatever its
// width, so wide ones cost fewer passes). A chunk holding a word of the
// tensor lies within its allocation.
template <int N>
__device__ __forceinline__ void ld_words(uint32_t (&out)[N],
                                         const uint32_t* p, int n) {
  constexpr int kChunks = (N + 6) / 4;  // the most N words can touch
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint4* c = reinterpret_cast<const uint4*>(a & ~uintptr_t{15});
  const int off = static_cast<int>((a >> 2) & 3);
  const int need = n > 0 ? (off + n + 3) >> 2 : 0;
  uint32_t buf[4 * kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (i < need) v = __ldg(c + i);
    buf[4 * i] = v.x;
    buf[4 * i + 1] = v.y;
    buf[4 * i + 2] = v.z;
    buf[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    out[i] = off == 0 ? buf[i]
                      : off == 1 ? buf[i + 1]
                                 : off == 2 ? buf[i + 2] : buf[i + 3];
}

template <int W>
__device__ __forceinline__ void ld_row(uint32_t (&r)[W], const uint32_t* p) {
  ld_words<W>(r, p, W);
}

// 4 bytes from device memory (L2) to shared memory, asynchronously
__device__ __forceinline__ void copy4(uint32_t* dst, const uint32_t* src) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// The first fence row in [lo, hi) the predicate fails on, or hi.
template <int W, bool RIGHT>
__device__ __forceinline__ int fence_search(const uint32_t* fence, int lo,
                                            int hi, const uint32_t (&q)[W]) {
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    uint32_t row[W];
    fence_row<W>(row, fence, mid);
    if (past<W, RIGHT>(row, q)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The rows' bucket after c passed fence rows: ((c-1) << s, min(c << s,
// m)] holds the search's answer, or it is 0 when c = 0; as [lo, hi].
__device__ __forceinline__ void bucket_of(int c, int shift, int m, int& lo,
                                          int& hi) {
  lo = c == 0 ? 0 : ((c - 1) << shift) + 1;
  hi = c == 0 ? 0 : min(c << shift, m);
}

// The first row of [lo, hi) the predicate fails on, or hi (which the
// caller knows to be the answer when every row before it passes).
template <int W, bool RIGHT>
__device__ __forceinline__ int bucket_search(const uint32_t* __restrict__ keys,
                                             int lo, int hi,
                                             const uint32_t (&q)[W]) {
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    uint32_t row[W];
    ld_row<W>(row, keys + static_cast<size_t>(mid) * W);
    if (past<W, RIGHT>(row, q)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <int W>
__global__ void __launch_bounds__(kProbeThreads)
    probe_kernel(const uint32_t* __restrict__ keys, int m,
                 const int32_t* __restrict__ table, int levels,
                 const uint32_t* __restrict__ rb,
                 const uint32_t* __restrict__ re, int q,
                 int32_t* __restrict__ out, int shift, int nf) {
  extern __shared__ uint32_t fence[];
  FDB_MARK(0)
  for (int i = threadIdx.x; i < nf * W; i += blockDim.x) {
    int j = i / W;
    copy4(fence + i, keys + (static_cast<size_t>(j) << shift) * W + (i - j * W));
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  FDB_MARK(1)
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < q;
       i += gridDim.x * blockDim.x) {
    uint32_t kb[W], ke[W];
    ld_row<W>(kb, rb + static_cast<size_t>(i) * W);
    ld_row<W>(ke, re + static_cast<size_t>(i) * W);
    // il: the begin's right search, the fence then its bucket
    const int c = fence_search<W, true>(fence, 0, nf, kb);
    int lo, hi;
    bucket_of(c, shift, m, lo, hi);
    FDB_MARK(2)
    const int first = bucket_search<W, true>(keys, lo, hi, kb);  // il + 1
    FDB_MARK(3)
    // ir + 1 = search_left(re). For rb < re every row before `first` is
    // <= rb < re, so it is >= first, and the fence rows before c are
    // passed: re's fence count fc comes by a gallop from c (a read's end
    // lies few fence rows past its begin). fc == c: no fence row between,
    // so the answer is in [first, min(c << s, m)]: the window, then the
    // rest of that bucket. Otherwise re's own bucket, from `first` on.
    // For re <= rb the full search from the fence. Each search has one
    // call site, so the warp's lanes step through it together whichever
    // case each is in.
    const bool fwd = lt_rr<W>(kb, ke);
    int from = 0, to = nf;  // for rb < re, fence rows [c, from) are < re
    if (fwd) {
      from = c;
      for (int step = 1;; step <<= 1) {
        int j = c + step - 1;
        if (j >= nf) break;
        uint32_t row[W];
        fence_row<W>(row, fence, j);
        if (!lt_rr<W>(row, ke)) { to = j; break; }
        from = j + 1;
      }
    }
    const int fc = fence_search<W, false>(fence, from, to, ke);
    if (fwd && fc == c) {
      const int rows = min(kWindow, m - first);
      uint32_t win[kWindow * W];
      ld_words<kWindow * W>(win, keys + static_cast<size_t>(first) * W,
                            max(rows, 0) * W);
      int cnt = 0;
#pragma unroll
      for (int k = 0; k < kWindow; ++k) {
        uint32_t row[W];
#pragma unroll
        for (int w = 0; w < W; ++w) row[w] = win[k * W + w];
        cnt += (k < rows && lt_rr<W>(row, ke)) ? 1 : 0;
      }
      lo = first + cnt;  // the answer, unless past the window
      hi = cnt < kWindow ? lo : c == nf ? m : min(c << shift, m);
    } else {
      bucket_of(fc, shift, m, lo, hi);
      if (fwd) lo = max(lo, first);
    }
    const int p = bucket_search<W, false>(keys, lo, hi, ke);
    FDB_MARK(4)
    out[i] = table_query<false>(table, levels, m, max(first - 1, 0), p);
    FDB_MARK(5)
  }
}

// The fence's shift s: the least with ceil(m / 2^s) rows of W words
// within kFenceBytes.
int fence_shift(int m, int w) {
  int s = 0;
  while (((static_cast<long long>(m) + (1LL << s) - 1) >> s) * w * 4 >
         kFenceBytes)
    ++s;
  return s;
}

int probe_blocks(int q) {
  static const int most = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
    return 2 * sms;
  }();
  long long want = (q + kProbeThreads - 1LL) / kProbeThreads;
  return static_cast<int>(most > 0 && want > most ? most : want);
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
  const int shift = fence_shift(m, w);
  const int nf = static_cast<int>((m + (1LL << shift) - 1) >> shift);
  const size_t smem = static_cast<size_t>(nf) * w * 4;
  FDB_DISPATCH_W(w, {
    probe_kernel<W><<<probe_blocks(q), kProbeThreads, smem, s>>>(
        k, m, t, levels, b, e, q, o, shift, nf);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
