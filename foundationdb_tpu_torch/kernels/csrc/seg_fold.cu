// Kernel H: seg_fold — paint one batch's committed writes into the group's
// running map of committed-write versions.
//
// Replaces K14's fold, foundationdb_tpu/ops/group.py:588-597:
//   dd      = zeros(n + 1).at[where(cw, rank_wb, n)].add(1)
//                         .at[where(cw, rank_we, n)].add(-1)[:n]
//   covered = cumsum(dd) > 0
//   seg_ver = where(covered, version, seg_ver)
// over the group-wide ranks of the batch's write ends. It is a `where`,
// not a max: the two agree only because versions ascend through a group,
// and the JAX program writes `where`. Three launches around one int32
// scratch buffer of sf_scratch_words(n) words (the difference array, n,
// then COPIES rows of one partial block sum per tile of TILE ranks). The
// buffer is zero on entry and each launch zeroes what it consumed, so it
// is zero again on exit: the caller zeroes it once and reuses it for every
// fold of a group.
//
//   sf_scatter   one thread per write: for a committed live write,
//                atomicAdd +1 at rank_wb and -1 at rank_we into the
//                difference array, and the same into the block sums of
//                the tiles that hold those ranks (rank n, past the map, is
//                the dropped slot of the JAX scatter, and is skipped). Each
//                tile keeps COPIES partial sums and lane j of a warp adds
//                into copy j: a batch's 131,072 block-sum atomics land on
//                512 tiles at bench shape, and on one counter per tile they
//                queued 256 deep (39.5 us of the first version's 49.9 us on
//                an H100, chip_smoke.py phase 2); over 32 copies, 8 deep;
//   sf_scan_sums one block: each tile's copies summed (row by row, so the
//                block's loads are coalesced; rows 1.. zeroed where they
//                were not) and the tile sums turned into exclusive prefixes
//                (written over row 0), a chunk of 1024 tiles at a time with
//                a carry (the second pass over the block sums);
//   sf_paint     one block per tile: the tile's difference entries loaded
//                coalesced into shared memory (and zeroed where they were
//                not), a block scan written out by hand (16 consecutive
//                items per thread, then warp shuffles, then the eight warp
//                totals), offset by the tile's prefix (then zeroed); where
//                the running count is > 0 the kernel writes `version` into
//                seg_ver IN PLACE (coalesced, from the shared flags):
//                seg_ver is the caller's per-group running map, so no copy
//                of it is made.
//
// The counts are exact int32 sums for any write width, including one write
// covering the whole group space (a count is at most the batch's write
// count, 65,536 at bench shape, far inside int32).
//
// Bound on this card: bytes. What the function needs is the writes' two
// ranks and flag (9 B per write) and a write of every rank they cover
// (4 B per covered rank). The design moves more: it reads the whole
// difference array (4 B per rank of the map) and writes back the entries
// it found non-zero, so at bench shape, where most writes cover one rank,
// it is far from that bound. Design: atomics instead of the sorted
// scatter XLA needed on its platform; one pass of the difference array
// for the scan (the block sums come from the scatter's atomics, not from
// a reduction pass), shared memory padded one word in 32 so the per-thread
// runs read it without bank conflicts; no zeroing pass of its own.

#include "common.cuh"

namespace {

using namespace fdb;

constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 4096 ranks per block
constexpr int kScanThreads = 512;  // 128 registers a thread: 32 copies held
constexpr int kCopies = 32;  // partial block sums per tile

int tiles(int n) { return static_cast<int>((n + (kTile - 1LL)) / kTile); }

__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }

__global__ void scatter_kernel(const int32_t* __restrict__ wb,
                               const int32_t* __restrict__ we,
                               const uint8_t* __restrict__ cw, int nw, int n,
                               int nb, int32_t* __restrict__ diff,
                               int32_t* __restrict__ block_sums) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nw || !cw[j]) return;
  int b = min(max(wb[j], 0), n);
  int e = min(max(we[j], 0), n);
  int32_t* row = block_sums + static_cast<size_t>(j & (kCopies - 1)) * nb;
  if (b < n) {
    atomicAdd(diff + b, 1);
    atomicAdd(row + b / kTile, 1);
  }
  if (e < n) {
    atomicAdd(diff + e, -1);
    atomicAdd(row + e / kTile, -1);
  }
}

__global__ void __launch_bounds__(kScanThreads)
    scan_sums_kernel(int32_t* __restrict__ sums, int nb) {
  __shared__ int warp_sums[32];
  int carry = 0;
  for (int base = 0; base < nb; base += blockDim.x) {
    int i = base + threadIdx.x;
    int v = 0;
    if (i < nb) {
      // every load issued before any store, so the 32 are in flight at once
      int x[kCopies];
#pragma unroll
      for (int c = 0; c < kCopies; ++c)
        x[c] = sums[static_cast<size_t>(c) * nb + i];
#pragma unroll
      for (int c = 0; c < kCopies; ++c) v += x[c];
#pragma unroll
      for (int c = 1; c < kCopies; ++c)  // leave the scratch zero
        if (x[c]) sums[static_cast<size_t>(c) * nb + i] = 0;
    }
    int total;
    int incl = block_inclusive_scan(v, warp_sums, &total);
    if (i < nb) sums[i] = carry + incl - v;  // exclusive prefix, row 0
    carry += total;
  }
}

__global__ void __launch_bounds__(kThreads)
    paint_kernel(int32_t* __restrict__ diff, int32_t* __restrict__ prefix,
                 int n, int32_t version, int32_t* __restrict__ seg_ver) {
  __shared__ int tile[padded(kTile)];
  __shared__ int warp_sums[32];
  long long base = static_cast<long long>(blockIdx.x) * kTile;
  int t = threadIdx.x;
  int d[kItems];  // every load issued before any store
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    long long g = base + k * kThreads + t;
    d[k] = g < n ? diff[g] : 0;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    tile[padded(k * kThreads + t)] = d[k];
    if (d[k]) diff[base + k * kThreads + t] = 0;  // leave the scratch zero
  }
  __syncthreads();
  int local[kItems];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    local[j] = tile[padded(t * kItems + j)];
    sum += local[j];
  }
  int total;
  int incl = block_inclusive_scan(sum, warp_sums, &total);
  int running = prefix[blockIdx.x] + incl - sum;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    running += local[j];
    tile[padded(t * kItems + j)] = running > 0;
  }
  __syncthreads();  // every thread has read prefix[blockIdx.x]
  if (t == 0) prefix[blockIdx.x] = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    int i = k * kThreads + t;
    long long g = base + i;
    if (g < n && tile[padded(i)]) seg_ver[g] = version;
  }
}

}  // namespace

extern "C" {

// Words of scratch a fold over n ranks needs: the difference array and
// kCopies rows of one block sum per tile.
int sf_scratch_words(int n) {
  return n <= 0 ? 0 : n + kCopies * tiles(n);
}

int sf_scatter(const void* wb, const void* we, const void* cw, int nw, int n,
               void* scratch, void* stream) {
  if (nw <= 0 || n <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto diff = static_cast<int32_t*>(scratch);
  scatter_kernel<<<blocks_for(nw), kThreads, 0, s>>>(
      static_cast<const int32_t*>(wb), static_cast<const int32_t*>(we),
      static_cast<const uint8_t*>(cw), nw, n, tiles(n), diff, diff + n);
  return static_cast<int>(cudaGetLastError());
}

int sf_scan_sums(void* scratch, int n, void* stream) {
  if (n <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  scan_sums_kernel<<<1, kScanThreads, 0, s>>>(
      static_cast<int32_t*>(scratch) + n, tiles(n));
  return static_cast<int>(cudaGetLastError());
}

int sf_paint(void* scratch, int n, int version, void* seg_ver,
             void* stream) {
  if (n <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto diff = static_cast<int32_t*>(scratch);
  paint_kernel<<<tiles(n), kThreads, 0, s>>>(
      diff, diff + n, n, version, static_cast<int32_t*>(seg_ver));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
