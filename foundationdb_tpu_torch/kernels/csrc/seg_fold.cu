// Kernel H: seg_fold — paint one batch's committed writes into the group's
// running map of committed-write versions, in one launch.
//
// Replaces K14's fold, foundationdb_tpu/ops/group.py:588-597:
//   dd      = zeros(n + 1).at[where(cw, rank_wb, n)].add(1)
//                         .at[where(cw, rank_we, n)].add(-1)[:n]
//   covered = cumsum(dd) > 0
//   seg_ver = where(covered, version, seg_ver)
// over the group-wide ranks of the batch's write ends (clamped to [0, n];
// rank n is the dropped slot). It is a `where`, not a max: the two agree
// only because versions ascend through a group, and the JAX program
// writes `where`. seg_ver is painted IN PLACE: it is the caller's
// per-group running map, so no copy of it is made.
//
// Bound on this card: bytes. What the function needs is the writes' two
// ranks and flag (9 B per write) and a write of every rank they cover
// (4 B per covered rank): 0.31 us at bench shape (65,536 writes, most of
// them one rank, over a group of 8's 2,097,152 ranks). The first design
// (three launches: atomics into a difference array, a scan of its block
// sums, a pass over all n ranks) read the whole 8 MB difference array
// whatever the writes covered.
//
// Design: ONE cooperative launch whose work follows the covered ranks.
// Every committed row of one fold paints the same version, so writes that
// overlap store the same word and need no order; each write can paint its
// own [wb, we) directly. That equals the JAX count exactly unless some
// committed row is inverted (clamp(wb) > clamp(we): it adds -1 over
// [we, wb) and cancels the other writes' coverage there). So:
//   survey  a thread per write: any committed inverted row sets a flag;
//           the painted ranks are summed; a write wider than kGridSpan
//           goes on a short list in the scratch; then one grid sync;
//   paint   no inverted row, at most kMaxWide wide writes and at most
//           2n painted ranks: each write of up to kThreadSpan ranks is
//           painted by its thread, a longer one by its warp (the lanes
//           take its ranks in turn, coalesced), and each wide one by
//           the whole grid (a write over the whole space is 2,097,152
//           ranks: no one warp serialises the launch);
//   count   otherwise, the JAX semantics over every rank, in the same
//           launch: atomics into the difference array and its tiles'
//           sums, a grid sync, each tile's offset summed from the tile
//           sums before it, a block scan of the tile, and seg_ver
//           painted where the running count is > 0.
// The scratch (sf_scratch_words(n) int32 words: a header, the wide list,
// the tile sums, the difference array) is zero on entry and zero again on
// exit: the count zeroes each difference entry it reads, and the last
// block out (a counter in the header) zeroes the header, the wide list and
// the tile sums, after every block has read them. The caller zeroes it once and reuses it
// for every fold of a group; the paint never touches its tail.
// On an H100 at bench shape (kernels/phase_trace.py --kernel seg_fold) the
// survey takes ~0.9 us, the grid sync ~1.0, the paint ~1.1 and the last
// block's reset ~0.8: 6.1 us of device time against the three launches'
// 13.4. The count, which no resolver path's ranks reach (they are never
// inverted), takes ~37 us there.

#include <cooperative_groups.h>

#include "common.cuh"

#ifndef FDB_MARK
#define FDB_MARK(k)  // phase_trace.py's %globaltimer marks; none here
#endif

namespace {

using namespace fdb;
namespace cg = cooperative_groups;

constexpr int kFoldThreads = 512;
constexpr int kItems = 8;
constexpr int kTile = kFoldThreads * kItems;  // ranks a block counts at once
constexpr int kThreadSpan = 16;   // a thread paints a write up to this wide
constexpr int kGridSpan = 1 << 15;  // wider: the whole grid paints it
constexpr int kMaxWide = 128;     // wide writes the paint takes
// header words: painted ranks (uint64, words 0-1), inverted flag, wide
// count, blocks done
constexpr int kPainted = 0, kInverted = 2, kWide = 3, kDone = 4;
constexpr int kHeader = 8;

__host__ __device__ inline long long tiles(int n) {
  return (n + (kTile - 1LL)) / kTile;
}

__device__ __forceinline__ int clamp_rank(int r, int n) {
  return min(max(r, 0), n);
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kFoldThreads)
    fold_kernel(const int32_t* __restrict__ wb, const int32_t* __restrict__ we,
                const uint8_t* __restrict__ cw, int nw, int n,
                int32_t version, int32_t* __restrict__ seg_ver,
                int32_t* __restrict__ scratch) {
  cg::grid_group grid = cg::this_grid();
  __shared__ long long warp_part[kFoldThreads / 32];
  __shared__ int warp_sums[32];
  __shared__ int flag;
  auto* painted = reinterpret_cast<unsigned long long*>(scratch + kPainted);
  int* wide = scratch + kHeader;
  int* tile_sum = wide + kMaxWide;
  int* diff = tile_sum + tiles(n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long gtid = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
  const long long gthreads = static_cast<long long>(gridDim.x) * blockDim.x;

  // -- 1. survey --------------------------------------------------------
  FDB_MARK(0)
  long long span = 0;
  int inverted = 0;
  int b0 = 0, e0 = 0;  // this thread's first write (empty: none, or not
                       // committed), kept for the paint
  for (long long j = gtid; j < nw; j += gthreads) {
    if (!cw[j]) continue;
    int b = clamp_rank(wb[j], n), e = clamp_rank(we[j], n);
    if (j == gtid) b0 = b, e0 = e;
    if (b > e) inverted = 1;
    if (e > b) {
      span += e - b;
      if (e - b > kGridSpan) {
        int k = atomicAdd(scratch + kWide, 1);
        if (k < kMaxWide) wide[k] = static_cast<int>(j);
      }
    }
  }
  span = warp_sum(span);
  if (lane == 0) warp_part[warp] = span;
  inverted = __syncthreads_or(inverted);
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int i = 0; i < kFoldThreads / 32; ++i) s += warp_part[i];
    if (s) atomicAdd(painted, static_cast<unsigned long long>(s));
    if (inverted) atomicExch(scratch + kInverted, 1);
  }
  FDB_MARK(1)
  grid.sync();
  FDB_MARK(2)
  const int n_wide = __ldcg(scratch + kWide);
  const bool direct = __ldcg(scratch + kInverted) == 0 &&
                      n_wide <= kMaxWide &&
                      __ldcg(painted) <= 2ull * static_cast<unsigned>(n);

  if (direct) {
    // -- 2. paint: a thread, a warp or the grid per write ---------------
    const long long step = gthreads;
    for (long long j0 = gtid - lane; j0 < nw; j0 += step) {
      long long j = j0 + lane;
      int b = b0, e = e0;  // the survey's, on the first pass
      if (j != gtid) {
        b = e = 0;
        if (j < nw && cw[j]) {
          b = clamp_rank(wb[j], n);
          e = clamp_rank(we[j], n);
        }
      }
      int len = e - b;
      if (len > 0 && len <= kThreadSpan)
        for (int r = b; r < e; ++r) seg_ver[r] = version;
      unsigned mid = __ballot_sync(0xffffffffu,
                                   len > kThreadSpan && len <= kGridSpan);
      while (mid) {
        int src = __ffs(mid) - 1;
        int bb = __shfl_sync(0xffffffffu, b, src);
        int ee = __shfl_sync(0xffffffffu, e, src);
        for (int r = bb + lane; r < ee; r += 32) seg_ver[r] = version;
        mid &= mid - 1;
      }
    }
    FDB_MARK(3)
    for (int k = 0; k < n_wide; ++k) {
      int j = __ldcg(wide + k);
      int b = clamp_rank(wb[j], n), e = clamp_rank(we[j], n);
      for (long long r = b + gtid; r < e; r += gthreads)
        seg_ver[r] = version;
    }
    FDB_MARK(4)
  } else {
    // -- 3. count: the difference array, exactly as the JAX fold --------
    for (long long j = gtid; j < nw; j += gthreads) {
      if (!cw[j]) continue;
      int b = clamp_rank(wb[j], n), e = clamp_rank(we[j], n);
      if (b == e) continue;
      if (b < n) {
        atomicAdd(diff + b, 1);
        atomicAdd(tile_sum + b / kTile, 1);
      }
      if (e < n) {
        atomicAdd(diff + e, -1);
        atomicAdd(tile_sum + e / kTile, -1);
      }
    }
    grid.sync();
    const long long nt = tiles(n);
    for (long long t = blockIdx.x; t < nt; t += gridDim.x) {
      int before = 0;  // the tile's offset: the sums of the tiles before
      for (long long u = threadIdx.x; u < t; u += blockDim.x)
        before += __ldcg(tile_sum + u);
      int offset;
      block_inclusive_scan(before, warp_sums, &offset);
      const long long base = t * kTile + static_cast<long long>(threadIdx.x) *
                                             kItems;
      int d[kItems], sum = 0;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        long long g = base + k;
        d[k] = g < n ? __ldcg(diff + g) : 0;
        sum += d[k];
      }
      int total;
      int running = offset + block_inclusive_scan(sum, warp_sums, &total) -
                    sum;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        long long g = base + k;
        running += d[k];
        if (g < n) {
          if (running > 0) seg_ver[g] = version;
          if (d[k]) diff[g] = 0;  // leave the scratch zero
        }
      }
    }
    FDB_MARK(4)
  }

  // -- 4. the last block out zeroes the header, wide list and tile sums --
  // (every read of the scratch a block makes has returned before its
  // count goes up: the block used what it read)
  __syncthreads();
  if (threadIdx.x == 0)
    flag = atomicAdd(scratch + kDone, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (flag) {
    if (!direct)
      for (long long u = threadIdx.x; u < tiles(n); u += blockDim.x)
        tile_sum[u] = 0;
    if (threadIdx.x < min(n_wide, kMaxWide)) wide[threadIdx.x] = 0;
    if (threadIdx.x < kHeader) scratch[threadIdx.x] = 0;
  }
  FDB_MARK(5)
}

struct Plan {
  int blocks;  // at most one block per SM
  int err;     // a CUDA error from asking, 0 if none
};

// The grid's ceiling, asked once (a C++ static): one block per SM, the
// co-resident grid a cooperative launch needs, and as few blocks as the
// grid sync waits on.
const Plan& plan() {
  static const Plan p = [] {
    Plan r{0, 0};
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fold_kernel, kFoldThreads, 0);
    r.err = static_cast<int>(e);
    r.blocks = per_sm > 0 ? sms : 0;
    if (r.err == 0 && r.blocks <= 0)
      r.err = static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    return r;
  }();
  return p;
}

}  // namespace

extern "C" {

// Words of scratch a fold over n ranks needs: the header, the wide list,
// one sum per tile of kTile ranks, the difference array.
int sf_scratch_words(int n) {
  if (n <= 0) return 0;
  long long words = kHeader + kMaxWide + tiles(n) + n;
  return words > 2147483647LL ? -1 : static_cast<int>(words);
}

int sf_fold(const void* wb, const void* we, const void* cw, int nw, int n,
            int version, void* seg_ver, void* scratch, void* stream) {
  if (nw <= 0 || n <= 0) return kNoLaunch;
  if (plan().err) return plan().err;
  long long want = (nw + kFoldThreads - 1LL) / kFoldThreads;
  if (tiles(n) > want) want = tiles(n);
  int g = static_cast<int>(want < plan().blocks ? want : plan().blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {&wb, &we, &cw, &nw, &n, &version, &seg_ver, &scratch};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fold_kernel), dim3(g), dim3(kFoldThreads),
      args, 0, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
