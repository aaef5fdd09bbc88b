// The fenced tier search: kernel A's search and probe (keysearch.cu) and
// kernel E (sweep_ranks.cu) find a key's place in a sorted tier with it.
//
// A search over a tier that fits the 50 MB L2 (786,432 x 3 words = 9.4 MB
// at bench shape) is bound by its passes, not its bytes: a plain binary
// search takes ~20 steps, each issuing its row's W word loads one after
// another, and an uncoalesced load costs the L1 one pass per distinct
// line whatever its width (kernels/phase_trace.py --kernel
// keysearch_probe: a step in global memory ~0.35 us with every warp of
// the SM issuing). So:
//   fence   each block stages every 2^s-th row of the tier (the fence, at
//           most kFenceBytes: s = 10 at 786,432 x 3 words, 768 rows, 9
//           KB) in shared memory by 4-byte cp.async, once, and strides
//           over its queries; the top levels of a search run there, then
//           at most s steps in the fence's bucket in global memory, each
//           loading its row as the 16-byte chunks that hold it (1.5 loads
//           a row at W = 3, in place of 3). A sentinel tail costs
//           nothing: its rows are fence rows like any other. A larger
//           fence stages longer than it saves (24 and 48 KB measured
//           slower at both of the probe's shapes);
//   window  a second search near the first reads the kWindow rows after
//           the first's answer in one go (tier_ends: a read's end from
//           its begin; the both-sides search: the rows equal to its
//           query), and a bucket search only past them.
// Neither assumes the tier's rows distinct: the sentinel tail repeats.
#pragma once

#include "common.cuh"

#ifndef FDB_MARK
#define FDB_MARK(k)  // phase_trace.py's %globaltimer marks; none here
#endif
#ifndef FDB_MARK_AFTER
#define FDB_MARK_AFTER(k, v)  // a mark once v has arrived; none here
#endif

namespace fdb {

constexpr int kFenceThreads = 512;
constexpr int kFenceBytes = 12 * 1024;    // the fence's most bytes
constexpr int kWindow = 4;                // rows loaded at once

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

// The block stages the fence: rows 0, 2^s, 2 * 2^s, ... of keys[0, m),
// nf of them, then meets.
template <int W>
__device__ __forceinline__ void stage_fence(uint32_t* fence,
                                            const uint32_t* keys, int shift,
                                            int nf) {
  for (int i = threadIdx.x; i < nf * W; i += blockDim.x) {
    int j = i / W;
    copy4(fence + i, keys + (static_cast<size_t>(j) << shift) * W + (i - j * W));
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
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

// numpy.searchsorted of q over keys[0, m) (left: the first row >= q;
// right: the first row > q), the fence then its bucket; c gets the fence
// rows passed.
template <int W, bool RIGHT>
__device__ __forceinline__ int tier_bound(const uint32_t* __restrict__ keys,
                                          int m, const uint32_t* fence,
                                          int nf, int shift,
                                          const uint32_t (&q)[W], int& c) {
  c = fence_search<W, RIGHT>(fence, 0, nf, q);
  int lo, hi;
  bucket_of(c, shift, m, lo, hi);
  FDB_MARK(2)
  const int at = bucket_search<W, RIGHT>(keys, lo, hi, q);
  FDB_MARK(3)
  return at;
}

// One read [kb, ke)'s two ends in the tier: first = search_right(kb) and
// p = search_left(ke) (il + 1 and ir + 1 of K4 and K11).
template <int W>
__device__ __forceinline__ void tier_ends(const uint32_t* __restrict__ keys,
                                          int m, const uint32_t* fence,
                                          int nf, int shift,
                                          const uint32_t (&kb)[W],
                                          const uint32_t (&ke)[W], int& first,
                                          int& p) {
  int c;
  first = tier_bound<W, true>(keys, m, fence, nf, shift, kb, c);
  // p = search_left(ke). For kb < ke every row before `first` is <= kb <
  // ke, so it is >= first, and the fence rows before c are passed: ke's
  // fence count fc comes by a gallop from c (a read's end lies few fence
  // rows past its begin). fc == c: no fence row between, so the answer
  // is in [first, min(c << s, m)]: the window, then the rest of that
  // bucket. Otherwise ke's own bucket, from `first` on. For ke <= kb the
  // full search from the fence. Each search has one call site, so the
  // warp's lanes step through it together whichever case each is in.
  const bool fwd = lt_rr<W>(kb, ke);
  int from = 0, to = nf;  // for kb < ke, fence rows [c, from) are < ke
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
  int lo, hi;
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
  p = bucket_search<W, false>(keys, lo, hi, ke);
  FDB_MARK(4)
}

// Both sides of q: left = search_left(q) by the fence and its bucket;
// the rows equal to q follow it, so the kWindow rows from left are
// loaded in one go and right = left + the equal ones among them; only
// when all kWindow are equal (a key repeated, as the sentinel tail) does
// right look further: m if q equals the tier's last row, else a bucket
// search past the window.
template <int W>
__device__ __forceinline__ void tier_both(const uint32_t* __restrict__ keys,
                                          int m, const uint32_t* fence,
                                          int nf, int shift,
                                          const uint32_t (&q)[W], int& left,
                                          int& right) {
  int c;
  left = tier_bound<W, false>(keys, m, fence, nf, shift, q, c);
  const int rows = min(kWindow, m - left);
  uint32_t win[kWindow * W];
  ld_words<kWindow * W>(win, keys + static_cast<size_t>(left) * W,
                        max(rows, 0) * W);
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kWindow; ++k) {
    uint32_t row[W];
#pragma unroll
    for (int w = 0; w < W; ++w) row[w] = win[k * W + w];
    cnt += (k < rows && !lt_rr<W>(q, row)) ? 1 : 0;  // row >= q: equal
  }
  right = left + cnt;
  if (cnt == kWindow) {
    // q equal to the tier's last row (the sentinel tail: half of a
    // group's distinct point keys) ends at m, with no search
    uint32_t last[W];
    ld_row<W>(last, keys + static_cast<size_t>(m - 1) * W);
    if (!lt_rr<W>(q, last)) {
      right = m;
    } else {
      // the fence rows before c are < q, so <= q: q's right count is >= c
      const int cr = fence_search<W, true>(fence, c, nf, q);
      int lo, hi;
      bucket_of(cr, shift, m, lo, hi);
      right = bucket_search<W, true>(keys, max(lo, right), hi, q);
    }
  }
  FDB_MARK(4)
}

// The fence of a tier of m rows of w words: its shift s (the least with
// ceil(m / 2^s) rows within kFenceBytes), rows and shared-memory bytes.
struct Fence {
  int shift;
  int nf;
  size_t smem;
};

inline Fence fence_of(int m, int w) {
  int s = 0;
  while (((static_cast<long long>(m) + (1LL << s) - 1) >> s) * w * 4 >
         kFenceBytes)
    ++s;
  const int nf = static_cast<int>((m + (1LL << s) - 1) >> s);
  return Fence{s, nf, static_cast<size_t>(nf) * w * 4};
}

// Blocks of kFenceThreads for q queries: one a kFenceThreads, at most two
// an SM (each stages the fence once and strides over the rest).
inline int fence_blocks(int q) {
  static const int most = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
    return 2 * sms;
  }();
  long long want = (q + kFenceThreads - 1LL) / kFenceThreads;
  return static_cast<int>(most > 0 && want > most ? most : want);
}

}  // namespace fdb
