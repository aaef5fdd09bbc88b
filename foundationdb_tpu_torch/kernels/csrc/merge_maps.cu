// Kernel D: merge_maps — the pointwise max of two sorted piecewise-constant
// key -> version maps, with GC at a floor and canonical compaction.
//
// Replaces two JAX programs of foundationdb_tpu, which both fold one map
// into another:
//   K9     ops/delta.py:378 compact — main (+) delta at floor
//          max(main.oldest, delta.oldest);
//   K7(j)  ops/group.py:676-736, the merge phase of resolve_group — delta
//          (+) the batch's committed write coverage at its version.
//
// Map semantics: a map is rows (key, value) sorted by key (duplicate keys
// allowed; the last row of a key wins), the all-ones sentinel rows at the
// tail; the value in force at key k is the value of the last row with
// key <= k (search_right - 1), NEG before the first row. The result at k
// is max(A(k), B(k)), NEG where below the floor. A row survives iff it is
// real (last word not all ones), the first row of its key in merge order
// (A rows before B rows at equal keys) and its value differs from the
// value in force just before its key. That is the canonical form both JAX
// programs produce, so the outputs match row for row. Kept rows are
// compacted in key order into `cap` rows with a sentinel / NEG tail;
// `count` is the number of rows the canonical map needs, so rows past cap
// are dropped and the caller latches overflow (count > cap), never a
// silent truncation.
//
// mm_merge: one launch a call, a merge path in tiles with a decoupled
// look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016). A persistent grid (the co-resident block
// count) takes tiles by an atomic ticket, never by blockIdx, so a tile
// only waits on tiles that started before it. The tiles cover only the
// merged positions of the real rows, [0, R), R = the rows before each
// list's sentinel tail (every row past them is a sentinel, never kept):
// at the batch merge's shape more than half the positions. A tile is
// 1,024 positions (4 a thread) when ceil(R / 1,024) tiles fit in one
// round of the grid, else 2,048 (8 a thread): the smaller tile halves a
// tile's staging and merge where the grid has room, the larger keeps a
// large R to one round. Per tile:
//   1  partition: warps 0 and 1 find the tile's two ends on the merge-path
//      diagonals d0 and d1, i = how many of the first d merged rows are A
//      rows, under the merge order's tie rule (A[i-1] <= B[d-i] and
//      B[d-i-1] < A[i]: A first at equal keys), so i is the first m with
//      B[d-1-m] < A[m]. A warp probes 32 evenly spaced m a step: four
//      dependent steps over 786,432 rows where a binary search takes 20.
//      On a block's first draw R and the tile size are not known yet:
//      warps 0, 1 split for a small tile, warps 4, 5 for a large one, and
//      warps 2, 3 find each list's sentinel tail the same way, at once;
//   2  stage: the tile's A rows [i0, i1) and B rows [j0, j1), each list
//      with a halo row before (the merged key before the tile) and one
//      after (the first row past it), keys and values, into shared memory
//      by 4-byte cp.async copies, which hold no registers;
//   3  merge: each thread walks its 4 or 8 merged positions from its own
//      split, found in shared memory, the next row of each list in
//      registers. A
//      run of equal keys is decided at its LAST row, which stands for it
//      (same key, same place in key order): a row whose successor in the
//      merge holds another key ends its run, and the value in force there,
//      at = gc(max(A_val[i-1], B_val[j-1])) at the merge coordinates (i,
//      j) after the row, is both the run's value and `before` of the next
//      run. The run is kept iff real and at != before. A thread's first
//      row that continues a run from before the thread finds the run's
//      first rows by galloping back (doubling steps, then a binary
//      search) in each list, from device memory past the tile's halo: one
//      compare for the usual run of one or two rows, O(log L) for a run of
//      L equal keys (the coverage repeats a key where many writes end on
//      it). A thread's last row ends its run iff neither list's next row
//      holds its key; else the thread that holds the run's last row, in
//      this tile or a later one, decides it. No value is carried across
//      tiles, and the sentinel run, never kept, is never galloped;
//   4  offsets: the block scans its kept counts; warp 0 publishes the
//      tile's aggregate, looks back over the earlier tiles' status words
//      (an aggregate or an inclusive prefix, each stamped with the call's
//      epoch, so the array is never cleared between calls), 32 tiles a
//      step, to its exclusive prefix, and publishes its inclusive prefix.
//      The last tile's inclusive prefix is `count`;
//   5  write: the tile's kept rows, staged in shared memory in key order,
//      go out once, coalesced, at dest < cap;
//   6  tail: each real row that is not kept frees one output row of
//      [count, R), counted down from R: tile t fills the rows freed by its
//      own dropped rows, below those of the tiles before it, which it
//      knows from its prefix, so no tile waits for `count`. Output rows
//      [R, cap) are tickets past the tiles, 2,048 rows each, taken by
//      blocks out of tiles (at once by those that never had one). Every
//      output word is written once, and the wrapper allocates with
//      torch.empty.
// Scratch (mm_scratch_words): a ticket word, put back to 0 by the launch's
// last draw, then one status word per small tile of na + nb positions;
// the wrapper keeps it per device and passes a new epoch each call.
//
// Bound on this card: bytes. The function reads its inputs once and writes
// its output once, 4 (na + nb + cap) (W + 1) bytes: 37.7 MB at the
// compaction's 786,432 + 786,432 -> 786,432 rows of W = 3 words (11.3 us
// at 3.35 TB/s), 27.3 MB at the batch merge's 786,432 + 131,072 (8.1 us).
// The design reads the real rows once (plus two halo rows a list a tile,
// the galloped rows of long runs and the searches) and writes each output
// word once: below the bound where R is short of na + nb, so the live
// rows' floor, 4 (R + cap) (W + 1) bytes, stands beside it. Its tiles run
// in step (one round of the grid at these shapes), so the partition's and
// the look-back's latency and the merge's instructions add to the bytes'
// time instead of hiding behind them (kernels/phase_trace.py --kernel
// merge_maps shows each phase).
//
// K16, foundationdb_tpu/ops/history.py:114 merge_writes, runs on the same
// kernel in its row-keeping mode (mm_merge_writes, the template's kRows).
// merge_writes overwrites the union of sorted disjoint run intervals (b0,
// e0, b1, e1, ...) with the batch version. Its JAX program keeps rows, not
// keys: it sorts the tier's rows (A) and the run bounds (B) together (a
// tier row before a run bound at equal keys, each list in its own order:
// the merge path's tie rule), gives each row the tier value in force there
// raised to the version inside a run, NEG under the floor, and keeps a real
// row whose value differs from the row just before it in that order. In
// merge coordinates, with a and b the A and B rows at or before a merged
// position, the position's value depends on those two counts alone:
//   new(a, b) = gc(b odd ? max(A_val[a-1], version) : A_val[a-1]),
// A_val[-1] = NEG, and the position is kept iff real and new(a, b) differs
// from new at the position before it (new(0, 0) = NEG). A run begin equal
// to a tier key so keeps two rows of one key, which the canonical merge
// folds into one; and there are no runs of equal keys to gallop over: a
// thread's value before its first position comes from its own split (the
// A row before it, a halo row in shared memory, and the parity of the B
// rows before it), so no tile or thread waits on another but for the
// look-back over kept counts. Everything else (the grid and its ticket,
// the partition, the staging, the scan and look-back, the write, the tail)
// is mm_merge's, on the same scratch; the last tile also writes
// overflow = overflow_in | (count > cap) on the card. Its bound: bytes, the
// tier and the bounds read once and the tier written once, 4 ((na + cap)
// (W + 1) + nb W); 8.0 us at 786,432 + 131,072 rows of W = 3 words.

#include "common.cuh"

namespace {

using namespace fdb;

__device__ __forceinline__ int32_t gc(int32_t v, int32_t floor) {
  return v < floor ? VERSION_NEG : v;
}

// ---------------------------------------------------------------------------
// mm_merge

constexpr int kMergeThreads = 256;
constexpr int kItems = 8;                      // merged positions a thread
constexpr int kTile = kMergeThreads * kItems;  // 2,048 a tile
// the small tile, 4 positions a thread, taken when its tiles of the real
// rows fit in one round of the grid
constexpr int kSmallTile = kTile / 2;
constexpr int kSlots = kTile + 4;  // + a halo row each side, each list
constexpr int kWarps = kMergeThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
// a status word: epoch << 32 | state | value, the value under 2^30
constexpr unsigned long long kAggregate = 1ull << 30;
constexpr unsigned long long kInclusive = 2ull << 30;
constexpr unsigned long long kStates = 3ull << 30;
constexpr unsigned kValueMask = (1u << 30) - 1;
// na + nb must stay under this (a prefix fits a status word's value)
constexpr long long kMaxRows = 1ll << 30;

template <int W>
constexpr int merge_smem_bytes() {
  // keys and values of kSlots rows, then the kept rows' values and key
  // offsets
  return kSlots * W * 4 + kSlots * 4 + kTile * 4 + kTile * 2;
}

struct MergeArgs {
  const uint32_t* a_keys;
  const int32_t* a_val;
  int na;
  const uint32_t* b_keys;
  const int32_t* b_val;
  int nb;
  int32_t floor;
  int cap;
  uint32_t* out_keys;
  int32_t* out_val;
  long long* count;
  unsigned* ticket;
  unsigned long long* status;  // one a small tile of na + nb positions
  unsigned epoch;
  // the row-keeping mode's (K16's): the run version, and the overflow flag
  // before the call and after it (bytes, 0 or 1)
  int32_t version;
  const uint8_t* overflow_in;
  uint8_t* overflow_out;
};

// One sorted list as a tile reads it: rows [lo, hi) staged in shared
// memory, `s` / `sv` where row `org` (the tile's first) sits there; other
// rows from device memory.
template <int W>
struct List {
  const uint32_t* g;
  const int32_t* gv;
  int lo, hi, org;
  const uint32_t* s;
  const int32_t* sv;

  __device__ __forceinline__ const uint32_t* row(int i) const {
    return (i >= lo && i < hi) ? s + (i - org) * W
                               : g + static_cast<size_t>(i) * W;
  }
  // the value of row i, NEG before the first row
  __device__ __forceinline__ int32_t val(int i) const {
    if (i < 0) return VERSION_NEG;
    return (i >= lo && i < hi) ? sv[i - org] : __ldg(gv + i);
  }
};

// a < b for two rows in shared or device memory, every word loaded first
template <int W>
__device__ __forceinline__ bool less_rr(const uint32_t* a, const uint32_t* b) {
  uint32_t x[W], y[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    x[w] = a[w];
    y[w] = b[w];
  }
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (x[w] != y[w]) return x[w] < y[w];
  return false;
}

template <int W>
__device__ __forceinline__ bool eq_row(const uint32_t (&k)[W],
                                       const uint32_t* r) {
  bool same = true;
#pragma unroll
  for (int w = 0; w < W; ++w) same &= r[w] == k[w];
  return same;
}

// The first row of k's run among rows [0, i), every row before i being
// <= k: i when row i - 1 is not k; else doubling steps back while the key
// holds, then a binary search.
template <int W>
__device__ int run_begin(const List<W>& x, int i, const uint32_t (&k)[W]) {
  if (i <= 0 || !eq_row<W>(k, x.row(i - 1))) return i;
  int p = i - 1, step = 1;  // row p holds k
  while (p - step >= 0 && eq_row<W>(k, x.row(p - step))) {
    p -= step;
    step <<= 1;
  }
  int lo = max(p - step + 1, 0), hi = p;  // row hi holds k, row lo - 1 not
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (eq_row<W>(k, x.row(mid))) hi = mid; else lo = mid + 1;
  }
  return lo;
}

template <int W>
__device__ __forceinline__ void load_row(uint32_t (&r)[W], const uint32_t* p) {
#pragma unroll
  for (int w = 0; w < W; ++w) r[w] = p[w];
}

// a < b for two rows in registers
template <int W>
__device__ __forceinline__ bool lex_less(const uint32_t (&a)[W],
                                         const uint32_t (&b)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (a[w] != b[w]) return a[w] < b[w];
  return false;
}

// The merge path's split on diagonal d, by one warp: how many of the
// first d merged rows are A rows, the first m with B[d-1-m] < A[m].
// Each step the 32 lanes probe the ends of 32 equal chunks of [lo, hi);
// the probes that hold (A[m] first) are a prefix of the lanes.
template <int W>
__device__ int split(const MergeArgs& a, int d, int lane) {
  int lo = max(0, d - a.nb), hi = min(d, a.na);
  while (lo < hi) {
    const int s = (hi - lo + 31) >> 5;
    const int m = lo + lane * s + s - 1;
    bool a_first = false;
    if (m < hi)
      a_first = !less_rr<W>(a.b_keys + static_cast<size_t>(d - 1 - m) * W,
                            a.a_keys + static_cast<size_t>(m) * W);
    lo += __popc(__ballot_sync(kFull, a_first)) * s;
    hi = min(hi, lo + s - 1);
  }
  return lo;
}

// The first all-ones row of a sorted list, by one warp as split() does:
// rows before it may be real, rows from it on are the sentinel tail.
template <int W>
__device__ int first_sentinel(const uint32_t* keys, int n, int lane) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int s = (hi - lo + 31) >> 5;
    const int m = lo + lane * s + s - 1;
    bool live = false;
    if (m < hi) {
      const uint32_t* r = keys + static_cast<size_t>(m) * W;
#pragma unroll
      for (int w = 0; w < W; ++w) live |= r[w] != kFull;
    }
    lo += __popc(__ballot_sync(kFull, live)) * s;
    hi = min(hi, lo + s - 1);
  }
  return lo;
}

// Output rows [from, to) to the sentinel key and NEG, this thread's
// words from `first` on at `stride`.
template <int W>
__device__ __forceinline__ void fill_rows(const MergeArgs& a, long long from,
                                          long long to, long long first,
                                          long long stride) {
  for (long long f = first; f < (to - from) * W; f += stride)
    a.out_keys[from * W + f] = kFull;
  for (long long r = first; r < to - from; r += stride)
    a.out_val[from + r] = VERSION_NEG;
}

// 4 bytes from device memory (L2) to shared memory, asynchronously
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// n words from src to dst by the block's threads
__device__ __forceinline__ void stage(uint32_t* dst, const void* src, int n) {
  const uint32_t* from = static_cast<const uint32_t*>(src);
  for (int f = threadIdx.x; f < n; f += kMergeThreads)
    copy4(dst + f, from + f);
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned epoch,
                                             unsigned long long state,
                                             int value) {
  __threadfence();
  atomicExch(p, (static_cast<unsigned long long>(epoch) << 32) | state |
                    static_cast<unsigned>(value));
}

// a status word of this call's epoch (a stale or unwritten one is not)
__device__ __forceinline__ bool current(unsigned long long s,
                                        unsigned epoch) {
  return static_cast<unsigned>(s >> 32) == epoch && (s & kStates) != 0;
}

// Tile t's exclusive prefix of kept rows, by one warp: lane 0 publishes
// the aggregate; then the lanes read the status words of 32 earlier tiles
// at once (lane l tile p - l, each waiting for its word of this call), add
// those up to the nearest inclusive prefix, or all 32 and step back 32
// tiles when none is inclusive; lane 0 publishes the inclusive prefix.
__device__ int look_back(const MergeArgs& a, int t, int total, int lane) {
  if (t == 0) {
    if (lane == 0) store_status(a.status, a.epoch, kInclusive, total);
    return 0;
  }
  if (lane == 0) store_status(a.status + t, a.epoch, kAggregate, total);
  int prefix = 0;
  for (int p = t - 1;; p -= 32) {
    const int q = p - lane;
    unsigned long long s = 0;
    if (q >= 0) {
      do {
        s = load_status(a.status + q);
      } while (!current(s, a.epoch));
    }
    // tile 0 is inclusive, so a window that reaches it stops there
    const unsigned incl = __ballot_sync(kFull, (s & kInclusive) != 0);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    prefix += __reduce_add_sync(
        kFull, lane <= stop ? static_cast<unsigned>(s & kValueMask) : 0u);
    if (incl) break;
  }
  if (lane == 0)
    store_status(a.status + t, a.epoch, kInclusive, prefix + total);
  return prefix;
}

// A thread's split in its tile's staged rows: how many of the tile's
// first k0 merged rows are A rows (of la A and lb B rows), the merge
// order's tie rule as split()'s.
template <int W>
__device__ __forceinline__ int thread_split(const List<W>& A,
                                            const List<W>& B, int k0, int la,
                                            int lb) {
  int lo = max(0, k0 - lb), hi = min(k0, la);
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (less_rr<W>(B.s + (k0 - 1 - m) * W, A.s + m * W)) hi = m;
    else lo = m + 1;
  }
  return lo;
}

// The value K16 gives a merged position after a tier rows and b run
// bounds, from the tier value in force there (av = A_val[a - 1]).
__device__ __forceinline__ int32_t row_value(const MergeArgs& a, int32_t av,
                                             int b) {
  return gc((b & 1) ? max(av, a.version) : av, a.floor);
}

// kRows false: the canonical map merge (mm_merge); true: K16's row-keeping
// merge (mm_merge_writes, no B values, the rows kept by row_value).
template <int W, bool kRows>
__global__ void __launch_bounds__(kMergeThreads) merge_kernel(MergeArgs a) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_keys = smem;                                     // [kSlots][W]
  int32_t* s_val = reinterpret_cast<int32_t*>(s_keys + kSlots * W);
  int32_t* s_out_val = s_val + kSlots;                         // [kTile]
  uint16_t* s_out_row = reinterpret_cast<uint16_t*>(s_out_val + kTile);
  __shared__ int s_tile[4];  // i0, i1, ticket, exclusive prefix
  __shared__ int s_real[2];  // each list's rows before its sentinel tail
  __shared__ int s_first[4];  // the first draw's splits: small, large tile
  __shared__ int s_sums[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = a.na + a.nb;

  const long long cap = a.cap;
  // the tiles cover the merged positions of the real rows, [0, R): every
  // row past them is a sentinel row, never kept. R, and with it the tile
  // size, is found on a block's first draw
  int tiles = 0, tile = kSmallTile;
  bool searched = false;
  for (;;) {
    if (tid == 0) s_tile[2] = static_cast<int>(atomicAdd(a.ticket, 1u));
    __syncthreads();
    const int t = s_tile[2];
    // -- 1. partition: the splits at t's ends, the second one's diagonal
    //    cut to n (and to R below). On the block's first draw the tile
    //    size is not known yet: warps 0, 1 split for a small tile and
    //    warps 4, 5 for a large one, while warps 2 and 3 find where each
    //    list's sentinel tail begins; later draws split with warps 0, 1
    if (!searched) {
      if (warp < 6 && warp != 2 && warp != 3) {
        const int size = warp < 2 ? kSmallTile : kTile;
        const int d = (t + (warp & 1)) * size;
        if (t * size < n) {
          const int i = split<W>(a, min(d, n), lane);
          if (lane == 0) s_first[warp < 2 ? warp : warp - 2] = i;
        }
      } else if (warp == 2 || warp == 3) {
        const int r = warp == 3 ? first_sentinel<W>(a.b_keys, a.nb, lane)
                                : first_sentinel<W>(a.a_keys, a.na, lane);
        if (lane == 0) s_real[warp - 2] = r;
      }
    } else if (t < tiles && warp < 2) {
      const int i = split<W>(a, min((t + warp) * tile, n), lane);
      if (lane == 0) s_tile[warp] = i;
    }
    __syncthreads();
    const int ra = s_real[0], rb = s_real[1];
    if (!searched) {
      const int small = (ra + rb + kSmallTile - 1) / kSmallTile;
      tile = small <= static_cast<int>(gridDim.x) ? kSmallTile : kTile;
      tiles = (ra + rb + tile - 1) / tile;
    }
    const bool first = !searched;
    searched = true;
    // count is at most R, so output rows from there on are tail: tickets
    // past the tiles fill them, kTile rows each
    const long long real = min(cap, static_cast<long long>(ra) + rb);
    const int chunks = static_cast<int>((cap - real + kTile - 1) / kTile);
    if (t >= tiles) {
      const long long c = real + static_cast<long long>(t - tiles) * kTile;
      if (c < cap) {
        fill_rows<W>(a, c, min(c + kTile, cap), threadIdx.x, kMergeThreads);
        continue;
      }
      // the launch's last draw: every block has drawn, so the ticket can
      // go back to 0 for the next call on the stream
      if (tid == 0 && t == tiles + chunks + static_cast<int>(gridDim.x) - 1)
        *a.ticket = 0;
      break;
    }
    const int items = tile / kMergeThreads;
    const int d0 = t * tile, d1 = min(d0 + tile, ra + rb);
    // the merge's first R rows are every real row of both lists
    const int* ends = first ? s_first + (tile == kSmallTile ? 0 : 2) : s_tile;
    const int i0 = ends[0], i1 = d1 == ra + rb ? ra : ends[1];
    const int j0 = d0 - i0, j1 = d1 - i1;
    const int la = i1 - i0, lb = j1 - j0;
    // -- 2. stage: A rows [i0 - 1, i1] from slot 0, then B rows [j0 - 1,
    //    j1]; slot 0 of a list is its halo row before
    const int kb = (la + 2) * W, vb = la + 2;
    const List<W> A{a.a_keys, a.a_val, max(i0 - 1, 0), min(i1 + 1, a.na),
                    i0, s_keys + W, s_val + 1};
    const List<W> B{a.b_keys, a.b_val, max(j0 - 1, 0), min(j1 + 1, a.nb),
                    j0, s_keys + kb + W, s_val + vb + 1};
    uint32_t* s_val_u = reinterpret_cast<uint32_t*>(s_val);
    stage(s_keys + (A.lo - i0 + 1) * W,
          a.a_keys + static_cast<size_t>(A.lo) * W, (A.hi - A.lo) * W);
    stage(s_keys + kb + (B.lo - j0 + 1) * W,
          a.b_keys + static_cast<size_t>(B.lo) * W, (B.hi - B.lo) * W);
    stage(s_val_u + A.lo - i0 + 1, a.a_val + A.lo, A.hi - A.lo);
    if constexpr (!kRows)  // the run bounds carry no values
      stage(s_val_u + vb + B.lo - j0 + 1, a.b_val + B.lo, B.hi - B.lo);
    if (tid == 0) {  // the value before a list's first row is NEG
      if (i0 == 0) s_val[0] = VERSION_NEG;
      if (!kRows && j0 == 0) s_val[vb] = VERSION_NEG;
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();

    // -- 3. merge this thread's positions [k0, k0 + items)
    const int k0 = tid * items, nloc = d1 - d0;
    const int32_t* sav = A.sv;  // A's values, row i0 at 0
    const int32_t* sbv = B.sv;
    unsigned keep = 0;
    uint16_t slot_of[kItems];  // a row's key, as a word offset in s_keys
    int32_t val_of[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      slot_of[q] = 0;
      val_of[q] = 0;
    }
    if constexpr (kRows) {
      if (k0 < nloc) {
        // K16: each position's value from its merge coordinates alone, the
        // value before the thread's first one from its own split
        int ia = thread_split<W>(A, B, k0, la, lb), jb = k0 - ia;
        const int nq = min(items, nloc - k0);
        uint32_t x[W], y[W];
        load_row<W>(x, A.s + ia * W);
        load_row<W>(y, B.s + jb * W);
        int32_t before = row_value(a, sav[ia - 1], j0 + jb);
#pragma unroll
        for (int q = 0; q < kItems; ++q) {
          if (q < nq) {
            const bool take_a = ia < la && (jb >= lb || !lex_less<W>(y, x));
            const bool real = (take_a ? x[W - 1] : y[W - 1]) != kFull;
            slot_of[q] = static_cast<uint16_t>(take_a ? W + ia * W
                                                      : kb + W + jb * W);
            if (take_a) load_row<W>(x, A.s + ++ia * W);
            else load_row<W>(y, B.s + ++jb * W);
            const int32_t v = row_value(a, sav[ia - 1], j0 + jb);
            if (real && v != before) {
              keep |= 1u << q;
              val_of[q] = v;
            }
            before = v;
          }
        }
      }
    } else if (k0 < nloc) {
      // tile-local merge coordinates
      int ia = thread_split<W>(A, B, k0, la, lb), jb = k0 - ia;
      const int nq = min(items, nloc - k0);
      // the next row of each list (past its end: a slot not read)
      uint32_t x[W], y[W], k[W];
      load_row<W>(x, A.s + ia * W);
      load_row<W>(y, B.s + jb * W);
      int32_t run_before = 0;  // in force before the current run's key
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        if (q < nq) {
          const bool take_a = ia < la && (jb >= lb || !lex_less<W>(y, x));
          const int slot = take_a ? W + ia * W : kb + W + jb * W;
          const int32_t v = gc(max(sav[ia - 1], sbv[jb - 1]), a.floor);
          if (q == 0) {
            const int gi = i0 + ia, gj = j0 + jb;
#pragma unroll
            for (int w = 0; w < W; ++w) k[w] = take_a ? x[w] : y[w];
            if (k[W - 1] != kFull &&
                ((gi > 0 && eq_row<W>(k, A.s + (ia - 1) * W)) ||
                 (gj > 0 && eq_row<W>(k, B.s + (jb - 1) * W))))
              // the run began before this thread's rows
              run_before = gc(max(A.val(run_begin<W>(A, gi, k) - 1),
                                  B.val(run_begin<W>(B, gj, k) - 1)),
                              a.floor);
            else
              run_before = v;
          } else {
            bool same = true;
#pragma unroll
            for (int w = 0; w < W; ++w) same &= (take_a ? x[w] : y[w]) == k[w];
            if (!same) {
              // row q starts a run, so the run of row q - 1 ends there
              if (k[W - 1] != kFull && v != run_before) {
                keep |= 1u << (q - 1);
                val_of[q - 1] = v;
              }
              run_before = v;
#pragma unroll
              for (int w = 0; w < W; ++w) k[w] = take_a ? x[w] : y[w];
            }
          }
          slot_of[q] = static_cast<uint16_t>(slot);
          if (take_a) load_row<W>(x, A.s + ++ia * W);
          else load_row<W>(y, B.s + ++jb * W);
          if (q == nq - 1 && k[W - 1] != kFull) {
            // the last row's run ends here iff neither list's next row
            // holds its key (both are >= it)
            const bool a_more = i0 + ia < a.na && eq_row<W>(k, x);
            const bool b_more = j0 + jb < a.nb && eq_row<W>(k, y);
            const int32_t after = gc(max(sav[ia - 1], sbv[jb - 1]), a.floor);
            if (!a_more && !b_more && after != run_before) {
              keep |= 1u << q;
              val_of[q] = after;
            }
          }
        }
      }
    }

    // -- 4. offsets: in the tile by a block scan, across tiles by the
    //    look-back
    const int c = __popc(keep);
    int total;
    const int off = block_inclusive_scan(c, s_sums, &total) - c;
    if (warp == 0) {
      const int prefix = look_back(a, t, total, lane);
      if (lane == 0) s_tile[3] = prefix;
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      if (keep >> q & 1u) {
        const int r = off + __popc(keep & ((1u << q) - 1u));
        s_out_row[r] = slot_of[q];
        s_out_val[r] = val_of[q];
      }
    }
    __syncthreads();

    // -- 5. the kept rows, coalesced, at dest < cap
    const int prefix = s_tile[3];
    const int rows = min(total, a.cap - prefix);
    uint32_t* out = a.out_keys + static_cast<size_t>(prefix) * W;
    for (int f = tid; f < rows * W; f += kMergeThreads) {
      const int r = f / W;
      out[f] = s_keys[s_out_row[r] + (f - r * W)];
    }
    for (int r = tid; r < rows; r += kMergeThreads)
      a.out_val[prefix + r] = s_out_val[r];
    if (tid == 0 && t == tiles - 1) {
      *a.count = prefix + total;
      if constexpr (kRows)
        *a.overflow_out = *a.overflow_in | (prefix + total > a.cap);
    }
    // -- 6. the tile's share of the tail [count, real rows): each real row
    //    that is not kept frees one, counted down from the real rows' end,
    //    so the shares need no count: tile t takes the D_t + 1-th .. the
    //    D_t + d_t-th rows below it, D_t the real rows dropped before the
    //    tile (real rows before it less its prefix), d_t its own
    {
      const int before = min(i0, ra) + min(j0, rb);
      const int in_tile = min(i1, ra) - min(i0, ra) + min(j1, rb) -
                          min(j0, rb);
      const long long hi = static_cast<long long>(ra) + rb - (before - prefix);
      fill_rows<W>(a, hi - (in_tile - total), min(hi, cap), tid,
                   kMergeThreads);
    }
    __syncthreads();  // shared memory is the next tile's
  }
  if (tiles == 0 && blockIdx.x == 0 && tid == 0) {
    *a.count = 0;
    if constexpr (kRows) *a.overflow_out = *a.overflow_in;
  }
}

struct Plan {
  int blocks;  // the co-resident block count
  int err;     // a CUDA error from asking, 0 if none
};

// The kernel's grid, asked once per key width and mode (C++ statics).
template <int W, bool kRows>
const Plan& plan() {
  static const Plan p = [] {
    Plan r{0, 0};
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(
        merge_kernel<W, kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        merge_smem_bytes<W>());
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, merge_kernel<W, kRows>, kMergeThreads,
          merge_smem_bytes<W>());
    r.err = static_cast<int>(e);
    r.blocks = sms * per_sm;
    if (r.err == 0 && r.blocks <= 0)
      r.err = static_cast<int>(cudaErrorInvalidConfiguration);
    return r;
  }();
  return p;
}

template <int W, bool kRows>
int launch_merge(const MergeArgs& a, cudaStream_t stream) {
  const Plan& p = plan<W, kRows>();
  if (p.err) return p.err;
  merge_kernel<W, kRows>
      <<<p.blocks, kMergeThreads, merge_smem_bytes<W>(), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// int64 words of scratch mm_merge needs for na + nb rows: the ticket and
// one status word per tile; -1 past the kernel's row limit.
int mm_scratch_words(int na, int nb) {
  const long long n = static_cast<long long>(na) + nb;
  if (na < 0 || nb < 0 || n >= kMaxRows) return -1;
  return static_cast<int>(1 + (n + kSmallTile - 1) / kSmallTile);
}

// The whole merge in one launch: out_keys [cap, w], out_val [cap], count
// (int64) written; scratch is mm_scratch_words(na, nb) int64 words, zero
// when first allocated and reused across calls with a new epoch each
// (1 .. 2^31 - 1; the wrapper zeroes it when the epoch wraps).
int mm_merge(const void* a_keys, const void* a_val, int na,
             const void* b_keys, const void* b_val, int nb, int w, int floor,
             int cap, void* out_keys, void* out_val, void* count,
             void* scratch, int epoch, void* stream) {
  if (na < 0 || nb < 0 || cap < 0 || epoch <= 0 ||
      static_cast<long long>(na) + nb >= kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  MergeArgs a{};
  a.a_keys = static_cast<const uint32_t*>(a_keys);
  a.a_val = static_cast<const int32_t*>(a_val);
  a.na = na;
  a.b_keys = static_cast<const uint32_t*>(b_keys);
  a.b_val = static_cast<const int32_t*>(b_val);
  a.nb = nb;
  a.floor = floor;
  a.cap = cap;
  a.out_keys = static_cast<uint32_t*>(out_keys);
  a.out_val = static_cast<int32_t*>(out_val);
  a.count = static_cast<long long*>(count);
  a.ticket = static_cast<unsigned*>(scratch);
  a.status = static_cast<unsigned long long*>(scratch) + 1;
  a.epoch = static_cast<unsigned>(epoch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  FDB_DISPATCH_W(w, (rc = launch_merge<W, false>(a, s)));
  return rc;
}

// K16 in one launch: the tier (a_keys, a_val: na rows) with the run bounds
// (b_keys: nb rows, sorted, begin / end alternating, sentinel tail)
// overwritten with `version` inside the runs, GC'd at `floor`, the rows
// kept as the JAX program keeps them, into out_keys [cap, w] and out_val
// [cap] with a sentinel / NEG tail; count (int64) and overflow_out = the
// byte overflow_in | (count > cap) written. Scratch and epoch as mm_merge's
// (the same scratch serves both).
int mm_merge_writes(const void* a_keys, const void* a_val, int na,
                    const void* b_keys, int nb, int w, int version,
                    int floor, int cap, void* out_keys, void* out_val,
                    void* count, const void* overflow_in, void* overflow_out,
                    void* scratch, int epoch, void* stream) {
  if (na < 0 || nb < 0 || cap < 0 || epoch <= 0 ||
      static_cast<long long>(na) + nb >= kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  MergeArgs a{};
  a.a_keys = static_cast<const uint32_t*>(a_keys);
  a.a_val = static_cast<const int32_t*>(a_val);
  a.na = na;
  a.b_keys = static_cast<const uint32_t*>(b_keys);
  a.nb = nb;
  a.floor = floor;
  a.cap = cap;
  a.out_keys = static_cast<uint32_t*>(out_keys);
  a.out_val = static_cast<int32_t*>(out_val);
  a.count = static_cast<long long*>(count);
  a.ticket = static_cast<unsigned*>(scratch);
  a.status = static_cast<unsigned long long*>(scratch) + 1;
  a.epoch = static_cast<unsigned>(epoch);
  a.version = version;
  a.overflow_in = static_cast<const uint8_t*>(overflow_in);
  a.overflow_out = static_cast<uint8_t*>(overflow_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  FDB_DISPATCH_W(w, (rc = launch_merge<W, true>(a, s)));
  return rc;
}

}  // extern "C"
