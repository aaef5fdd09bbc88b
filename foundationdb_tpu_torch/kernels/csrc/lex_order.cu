// Kernel N: lex_order — a stable lexicographic sort of packed-key rows.
//
// Replaces the lexicographic lax.sort of the JAX programs that order packed
// keys: K17 foundationdb_tpu/ops/keys.py:103 (sort_ranks: the [P, W] points
// and their iota), K12 ops/delta.py:146 (the read-dedup rows, begin words
// then end words, [NR, 2W]) and the port's coverage sort of a batch's
// committed write ends (ops/group._coverage; JAX folds it into the co-sort
// of ops/group.py:253). Rows are Wr = 1..16 uint32 words (an int32 bit
// pattern on the Python side, read here as uint32, so 0x80000000 sorts
// after 0x7FFFFFFF); the order is word 0 first, each word unsigned.
// Output: the sorted rows [P, Wr] and the permutation [P] int32 (sorted row
// i is input row perm[i]; equal rows keep their input order).
//
// Design: an LSD radix sort on 8-bit digits, stable by construction, in ONE
// persistent cooperative launch (its grid is the co-resident block count,
// asked once per width; the phases are separated by grid syncs; blocks walk
// their tiles in a loop, so P is not bounded by the grid):
//   0  zero the [4 Wr, 256] histogram table;
//   1  each block counts the live rows of its contiguous run of tiles (a
//      live row is any row but the all-ones sentinel) and builds all 4 Wr
//      digit histograms of them in shared memory (a warp whose live lanes
//      share a digit adds once), one global atomic per non-empty bin per
//      block; then every block lists, from the histograms, the digits with
//      more than one non-empty bin, least significant first. A trivial
//      digit is never passed over, and the choice stays on the card;
//   2  a stable partition: live rows to [0, L) in input order, sentinel rows
//      to [L, P) in input order, each carrying its input index. Taking the
//      sentinels out first is what lets digits be skipped: one all-ones row
//      would give every digit two non-empty bins;
//   then for each listed digit, over the live rows only:
//      a  each block counts the digit over its run of rows;
//      b  the [256 bins, blocks] counts are scanned per bin (bins spread
//         over the blocks), from the bin's base in the histogram;
//      c  each block walks its tiles in order: a warp ranks its rows among
//         equal digits with eight ballots (lanes in order), the tile's warps
//         are offset per bin and the bins per tile by scans in shared
//         memory, the tile is staged there in digit order, and its rows
//         (words and index) go to the other buffer in runs of consecutive
//         rows. Written straight from the registers (one 4-byte write per
//         word, each lane to another place) this phase took 18.2 us a pass
//         at 262,144 x 3 words on an H100, staged 7.3 (kernels/phase_trace
//         .py, its --direct-scatter). Counting the next digit there instead
//         of in (a), by warp-aggregated global atomics, cost as much as (a)
//         and its sync.
// The buffers ping-pong between the outputs and the scratch; phase 2 puts
// the live rows where the last pass's parity needs them and the sentinel
// tail straight into the outputs. Every buffer written during the launch is
// read back with __ldcg (L2), never through a stale L1 line.
//
// Bound on this card: bytes. The function reads the [P, Wr] rows once and
// writes the sorted rows and the permutation once: P (2 Wr 4 + 4) bytes,
// 6.3 MB at 262,144 x 3 words, ~1.9 us at 3.35 TB/s. The design reads the
// rows twice before the passes, reads the live rows twice per listed digit
// (count and scatter) and writes them once, and pays three grid syncs
// (~1-2 us each on an H100) per digit; at the port's sizes the per-tile
// latency chain of each phase and the syncs, not the bytes, set its time.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

using namespace fdb;
namespace cg = cooperative_groups;

constexpr int kSortThreads = 512;  // one row a thread: a tile of 512 rows
constexpr int kWarps = kSortThreads / 32;
constexpr int kBins = 256;         // 8-bit digits
constexpr int kMaxRowWords = 16;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Args {
  const uint32_t* in;
  int n;
  uint32_t* out_rows;
  int32_t* out_perm;
  uint32_t* tmp_rows;
  int32_t* tmp_perm;
  uint32_t* hist;    // [4 Wr][256] digit histograms of the live rows
  uint32_t* counts;  // [256][grid]: a pass's per-block counts, then offsets
  int32_t* live;     // [grid] live rows per block
};

// Dynamic shared memory: phase 1's histograms, or a pass's per-warp counts
// and offsets, four [256] bin arrays, and the staged tile (digit, index and
// W words of each of its rows).
template <int W>
constexpr int pass_words() {
  return 2 * kWarps * kBins + 4 * kBins + (2 + W) * kSortThreads;
}
template <int W>
constexpr int smem_words() {
  return 4 * W * kBins > pass_words<W>() ? 4 * W * kBins : pass_words<W>();
}

// Rows [*b, *e) of block k: n rows cut into tiles of kSortThreads, the tiles
// into g contiguous runs.
__device__ __forceinline__ void run_of(int n, int k, int g, int* b, int* e) {
  long long tiles = (n + kSortThreads - 1LL) / kSortThreads;
  long long run = (tiles + g - 1) / g * kSortThreads;
  long long lo = k * run;
  long long hi = lo + run;
  *b = static_cast<int>(lo < n ? lo : n);
  *e = static_cast<int>(hi < n ? hi : n);
}

template <int W, bool INPUT>
__device__ __forceinline__ void load_row(uint32_t (&r)[W], const uint32_t* p) {
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = INPUT ? __ldg(p + j) : __ldcg(p + j);
}

template <int W>
__device__ __forceinline__ void store_row(uint32_t* p, const uint32_t (&r)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) p[j] = r[j];
}

template <int W>
__device__ __forceinline__ bool all_ones(const uint32_t (&r)[W]) {
  bool s = true;
#pragma unroll
  for (int j = 0; j < W; ++j) s &= r[j] == kFull;
  return s;
}

// Digit q of a row: q = 0 is the last word's low byte, 4W - 1 word 0's high
// byte (the word is selected without indexing the register array at run
// time).
template <int W>
__device__ __forceinline__ uint32_t digit(const uint32_t (&r)[W], int q) {
  const int word = W - 1 - (q >> 2);
  uint32_t x = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) x = j == word ? r[j] : x;
  return (x >> (8 * (q & 3))) & 0xFFu;
}

template <int W>
__global__ void __launch_bounds__(kSortThreads) lex_kernel(Args a) {
  extern __shared__ uint32_t smem[];
  __shared__ int warp_sums[32];
  __shared__ int s_act[4 * kMaxRowWords];  // listed digits, least first
  __shared__ int s_nact;
  constexpr int kD = 4 * W;
  cg::grid_group grid = cg::this_grid();
  const int g = gridDim.x;
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = a.n;
  const int stride = g * kSortThreads;

  // -- 0: zero the histogram table
  for (int i = k * kSortThreads + tid; i < kD * kBins; i += stride)
    a.hist[i] = 0;
  for (int i = tid; i < kD * kBins; i += kSortThreads) smem[i] = 0;
  grid.sync();

  // -- 1: live rows per block, all digit histograms of the live rows
  int b0, e0;
  run_of(n, k, g, &b0, &e0);
  int n_live = 0;
  for (int base = b0; base < e0; base += kSortThreads) {
    int i = base + tid;
    uint32_t r[W];
#pragma unroll
    for (int j = 0; j < W; ++j) r[j] = kFull;
    if (i < e0) load_row<W, true>(r, a.in + static_cast<size_t>(i) * W);
    bool live = !all_ones<W>(r);
    n_live += live;
    unsigned m = __ballot_sync(kFull, live);
    if (m == 0) continue;  // the whole warp is sentinel or past the run
    int first = __ffs(m) - 1;
#pragma unroll
    for (int q = 0; q < kD; ++q) {
      uint32_t d = digit<W>(r, q);
      uint32_t d0 = __shfl_sync(kFull, d, first);
      if (__all_sync(kFull, !live || d == d0)) {
        if (lane == first)
          atomicAdd(&smem[q * kBins + d0], static_cast<uint32_t>(__popc(m)));
      } else if (live) {
        atomicAdd(&smem[q * kBins + d], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kD * kBins; i += kSortThreads) {
    uint32_t c = smem[i];
    if (c) atomicAdd(&a.hist[i], c);
  }
  int block_live;
  block_inclusive_scan(n_live, warp_sums, &block_live);
  if (tid == 0) a.live[k] = block_live;
  grid.sync();

  // -- every block: the listed digits, from the histograms
  int* busy = reinterpret_cast<int*>(smem);  // [kD] more than one bin
  for (int q = warp; q < kD; q += kWarps) {  // a warp per digit, 8 bins a lane
    int nonempty = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      nonempty += __ldcg(&a.hist[q * kBins + lane * 8 + j]) != 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      nonempty += __shfl_xor_sync(kFull, nonempty, o);
    if (lane == 0) busy[q] = nonempty > 1;
  }
  __syncthreads();
  if (tid < kD && busy[tid]) {
    int before_q = 0;
    for (int q = 0; q < tid; ++q) before_q += busy[q];
    s_act[before_q] = tid;
  }
  if (tid == 0) {
    int listed = 0;
    for (int q = 0; q < kD; ++q) listed += busy[q];
    s_nact = listed;
  }
  __syncthreads();
  const int n_act = s_nact;

  // -- 2: live rows to [0, L), the sentinel rows to [L, n), both stable
  int pre = 0, tot = 0;
  for (int j = tid; j < g; j += kSortThreads) {
    int v = __ldcg(&a.live[j]);
    tot += v;
    if (j < k) pre += v;
  }
  int n_all, before;
  block_inclusive_scan(tot, warp_sums, &n_all);   // L, the live rows
  block_inclusive_scan(pre, warp_sums, &before);  // live rows before b0
  // pass p reads the outputs when n_act - p is even, so the last lands there
  uint32_t* live_rows = (n_act & 1) ? a.tmp_rows : a.out_rows;
  int32_t* live_perm = (n_act & 1) ? a.tmp_perm : a.out_perm;
  for (int base = b0; base < e0; base += kSortThreads) {
    int i = base + tid;
    uint32_t r[W];
#pragma unroll
    for (int j = 0; j < W; ++j) r[j] = kFull;
    if (i < e0) load_row<W, true>(r, a.in + static_cast<size_t>(i) * W);
    bool live = !all_ones<W>(r);
    int tile_live;
    int incl = block_inclusive_scan(live ? 1 : 0, warp_sums, &tile_live);
    int lb = before + incl - (live ? 1 : 0);  // live rows before row i
    if (live) {
      store_row<W>(live_rows + static_cast<size_t>(lb) * W, r);
      live_perm[lb] = i;
    } else if (i < e0) {
      int pos = n_all + (i - lb);
      store_row<W>(a.out_rows + static_cast<size_t>(pos) * W, r);
      a.out_perm[pos] = i;
    }
    before += tile_live;
  }

  // -- the passes, over the live rows
  int b1, e1;
  run_of(n_all, k, g, &b1, &e1);
  uint32_t* wc = smem;                   // [kWarps][256] warp counts
  uint32_t* wo = wc + kWarps * kBins;    // [kWarps][256] warp offsets in bin
  uint32_t* run = wo + kWarps * kBins;   // [256] running global bin offsets
  uint32_t* cnt = run + kBins;           // [256] the block's counts
  uint32_t* tbs = cnt + kBins;           // [256] the tile's bin starts
  int32_t* gbase = reinterpret_cast<int32_t*>(tbs + kBins);  // [256]
  uint32_t* sdig = reinterpret_cast<uint32_t*>(gbase + kBins);
  int32_t* sidx = reinterpret_cast<int32_t*>(sdig + kSortThreads);
  uint32_t* srow = reinterpret_cast<uint32_t*>(sidx + kSortThreads);
  for (int i = tid; i < kWarps * kBins; i += kSortThreads) wc[i] = 0;
  const unsigned lower_lanes = (1u << lane) - 1u;
  for (int p = 0; p < n_act; ++p) {
    grid.sync();  // the previous phase's rows are all in place
    const int q = s_act[p];
    const int word = W - 1 - (q >> 2);
    const int shift = 8 * (q & 3);
    const bool from_out = ((n_act - p) & 1) == 0;
    const uint32_t* src_rows = from_out ? a.out_rows : a.tmp_rows;
    const int32_t* src_perm = from_out ? a.out_perm : a.tmp_perm;
    uint32_t* dst_rows = from_out ? a.tmp_rows : a.out_rows;
    int32_t* dst_perm = from_out ? a.tmp_perm : a.out_perm;

    // a: the block's digit counts
    if (tid < kBins) cnt[tid] = 0;
    __syncthreads();
    for (int i = b1 + tid; i < e1; i += kSortThreads) {
      uint32_t x = __ldcg(src_rows + static_cast<size_t>(i) * W + word);
      atomicAdd(&cnt[(x >> shift) & 0xFFu], 1u);
    }
    __syncthreads();
    if (tid < kBins) a.counts[tid * g + k] = cnt[tid];
    grid.sync();

    // b: per bin, the blocks' exclusive offsets, from the bin's base
    for (int bin = k; bin < kBins; bin += g) {
      int h = tid < bin ? static_cast<int>(__ldcg(&a.hist[q * kBins + tid]))
                        : 0;
      int carry;
      block_inclusive_scan(h, warp_sums, &carry);
      for (int c0 = 0; c0 < g; c0 += kSortThreads) {
        int j = c0 + tid;
        int v = j < g ? static_cast<int>(__ldcg(&a.counts[bin * g + j])) : 0;
        int total;
        int incl = block_inclusive_scan(v, warp_sums, &total);
        if (j < g) a.counts[bin * g + j] = carry + incl - v;
        carry += total;
      }
    }
    grid.sync();

    // c: rank each tile stably, stage it in shared memory in digit order,
    //    and write it out in runs of consecutive rows (coalesced)
    if (tid < kBins) run[tid] = __ldcg(&a.counts[tid * g + k]);
    __syncthreads();
    for (int base = b1; base < e1; base += kSortThreads) {
      const int i = base + tid;
      const bool act = i < e1;
      const int n_tile = min(e1 - base, kSortThreads);
      uint32_t r[W];
      int32_t idx = 0;
      uint32_t d = 0;
      if (act) {
        load_row<W, false>(r, src_rows + static_cast<size_t>(i) * W);
        idx = __ldcg(src_perm + i);
        d = digit<W>(r, q);
      }
      unsigned peers = __ballot_sync(kFull, act);
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) {
        bool set = (d >> bit) & 1u;
        unsigned votes = __ballot_sync(kFull, set);
        peers &= set ? votes : ~votes;
      }
      unsigned lower = peers & lower_lanes;
      if (act && lower == 0) wc[warp * kBins + d] = __popc(peers);
      __syncthreads();
      uint32_t in_bin = 0;  // warp offsets within each bin; wc left zero
      if (tid < kBins) {
        for (int w2 = 0; w2 < kWarps; ++w2) {
          uint32_t c = wc[w2 * kBins + tid];
          wo[w2 * kBins + tid] = in_bin;
          wc[w2 * kBins + tid] = 0;
          in_bin += c;
        }
      }
      int tile_rows;
      int incl = block_inclusive_scan(static_cast<int>(in_bin), warp_sums,
                                      &tile_rows);
      if (tid < kBins) {
        int start = incl - static_cast<int>(in_bin);
        tbs[tid] = start;
        gbase[tid] = static_cast<int>(run[tid]) - start;
        run[tid] += in_bin;
      }
      __syncthreads();
      if (act) {
        int t = tbs[d] + wo[warp * kBins + d] + __popc(lower);
        store_row<W>(srow + t * W, r);
        sidx[t] = idx;
        sdig[t] = d;
      }
      __syncthreads();
      for (int j = tid; j < n_tile * W; j += kSortThreads) {
        int t = j / W;
        size_t at = static_cast<size_t>(gbase[sdig[t]] + t) * W + (j - t * W);
        dst_rows[at] = srow[j];
      }
      if (tid < n_tile) dst_perm[gbase[sdig[tid]] + tid] = sidx[tid];
    }
  }
}

struct Plan {
  int blocks;  // co-resident blocks on the card
  int err;     // a CUDA error from asking, 0 if none
};

// The kernel's co-resident grid at width W, asked once (C++ statics).
template <int W>
const Plan& plan() {
  static const Plan p = [] {
    Plan r{0, 0};
    const int smem = smem_words<W>() * 4;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(
        lex_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lex_kernel<W>, kSortThreads, smem);
    r.err = static_cast<int>(e);
    r.blocks = per_sm * sms;
    if (r.err == 0 && r.blocks <= 0)
      r.err = static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    return r;
  }();
  return p;
}

template <int W>
int grid_for(int n) {
  long long tiles = (n + kSortThreads - 1LL) / kSortThreads;
  long long g = tiles < plan<W>().blocks ? tiles : plan<W>().blocks;
  return static_cast<int>(g > 0 ? g : 1);
}

template <int W>
long long scratch_words(int n) {
  long long g = grid_for<W>(n);
  return static_cast<long long>(n) * W + n + 4LL * W * kBins + kBins * g + g;
}

template <int W>
int launch(const uint32_t* in, int n, uint32_t* out_rows, int32_t* out_perm,
           int32_t* scratch, cudaStream_t stream) {
  if (plan<W>().err) return plan<W>().err;
  const int g = grid_for<W>(n);
  Args a;
  a.in = in;
  a.n = n;
  a.out_rows = out_rows;
  a.out_perm = out_perm;
  int32_t* s = scratch;
  a.tmp_rows = reinterpret_cast<uint32_t*>(s);
  s += static_cast<size_t>(n) * W;
  a.tmp_perm = s;
  s += n;
  a.hist = reinterpret_cast<uint32_t*>(s);
  s += 4 * W * kBins;
  a.counts = reinterpret_cast<uint32_t*>(s);
  s += static_cast<size_t>(kBins) * g;
  a.live = s;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lex_kernel<W>), dim3(g),
      dim3(kSortThreads), args, smem_words<W>() * 4, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// int32 words of scratch lo_sort needs for n rows of w words (-1 on a bad
// width or when the card could not be asked for the grid).
int lo_scratch_words(int n, int w) {
  if (n < 0 || w < 1 || w > kMaxRowWords) return -1;
  long long words = -1;
  FDB_DISPATCH_ROW_W(w, {
    if (plan<W>().err == 0) words = scratch_words<W>(n);
  });
  return words < 0 || words > 0x7FFFFFFFLL ? -1 : static_cast<int>(words);
}

int lo_sort(const void* rows, int n, int w, void* out_rows, void* out_perm,
            void* scratch, void* stream) {
  if (n <= 0) return kNoLaunch;
  auto in = static_cast<const uint32_t*>(rows);
  auto o = static_cast<uint32_t*>(out_rows);
  auto p = static_cast<int32_t*>(out_perm);
  auto s = static_cast<int32_t*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FDB_DISPATCH_ROW_W(w, return launch<W>(in, n, o, p, s, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
