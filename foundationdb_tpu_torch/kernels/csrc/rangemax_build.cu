// Kernel B: rangemax_build — the sparse doubling table, in one launch.
//
// Replaces K3's build, foundationdb_tpu/ops/rangemax.py:30:
//   t[0]    = values
//   t[k][i] = op(t[k-1][i], t[k-1][min(i + half, m - 1)]),
//   half    = min(2^(k-1), m - 1),
// i.e. op over values[i : i + 2^k] clamped at the array end, for k in
// 1 .. L-1 with L = bit_length(m-1) + 1; op is max (history versions) or
// min (the fixpoint's writer cover). The table is [L, m] int32, the layout
// kernel A's query and probe read.
//
// Bound on this card: bytes. The function reads the values once and writes
// the table once: (1 + L) x 4 B x m, 66 MB at 786,432 rows (L = 21), 20.7 us
// at 3.35 TB/s; 21 MB at the fixpoint's 2^18 leaves (L = 19).
//
// Design: ONE persistent cooperative launch of one 1,024-thread block per
// SM (blocks walk their tiles in a loop), where the first design launched
// once per level and moved each level three times:
//   1  no sync: each block takes a tile of kTile rows and the kTile rows to
//      its right (rows past m take the op's identity, which for an
//      idempotent op equals the clamp at m - 1), eight rows a thread in
//      registers, and builds the levels 0 .. log2(kTile) there, writing
//      each level's kTile rows once, coalesced, from the registers. A
//      level's partner row is another thread's for 2^k < 1,024, exchanged
//      through two alternating shared-memory buffers (one __syncthreads a
//      level), and the thread's own beyond that. Those levels never read
//      device memory;
//   2  the levels above a tile, two per grid sync: level k and k + 1 come
//      from level k - 1 alone (t[k+1][i] is op of t[k-1] at i, i + h,
//      i + 2h, i + 3h, h = 2^(k-1)), read back from L2 (__ldcg: the rows
//      were written in this launch), two rows a thread an iteration with
//      their eight reads in flight together. A read at or past m takes the
//      identity in place of the clamp, so no level's row m - 1 is read by
//      every thread at once (that hot row cost one pass 2.5x).
// At 786,432 rows: 13 levels in shared memory, then 4 syncs for the 8
// above; at 2^18: 3 syncs for 6. It writes the table once, reads the
// values twice (tile and halo) and the levels above a tile twice more from
// L2. On an H100 (kernels/phase_trace.py --kernel rangemax_build) phase 1
// is about half the time at both sizes, each sync ~0.9 us.
// One block per SM, not the co-resident grid: the scheduler places a
// cooperative grid's first blocks several to an SM, so on a grid of three
// blocks an SM the 64 tiles at 2^18 crowded fewer SMs and phase 1 took
// 17.3 us in place of 6.6 (phase_trace, an earlier form of this kernel).

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

using namespace fdb;
namespace cg = cooperative_groups;

constexpr int kBuildThreads = 1024;
constexpr int kTileBits = 12;
constexpr int kTile = 1 << kTileBits;          // rows a block builds in smem
constexpr int kSpan = 2 * kTile;               // the tile and its halo
constexpr int kPer = kSpan / kBuildThreads;    // halo'd rows per thread
constexpr int kSmemBytes = 2 * kSpan * 4;      // two exchange buffers

template <bool MIN>
__device__ __forceinline__ int32_t op(int32_t a, int32_t b) {
  return MIN ? min(a, b) : max(a, b);
}

// v[r] = op(v[r], v[r + D]) where r + D is in the span: the partner row
// j + D x kBuildThreads is the same thread's (ascending r reads the old
// value)
template <bool MIN, int D>
__device__ __forceinline__ void fold_own(int32_t (&v)[kPer]) {
#pragma unroll
  for (int r = 0; r + D < kPer; ++r) v[r] = op<MIN>(v[r], v[r + D]);
}

template <bool MIN>
__global__ void __launch_bounds__(kBuildThreads)
build_kernel(const int32_t* __restrict__ values, int32_t* __restrict__ table,
             int m, int levels) {
  extern __shared__ int32_t xbuf[];  // [2][kSpan]
  constexpr int32_t kIdent = MIN ? INT32_POS : INT32_NEG;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int tiles = (m + kTile - 1) / kTile;
  const int in_tile = min(levels - 1, kTileBits);  // top level built here

  // -- 1: levels 0 .. in_tile of each tile; thread tid holds the rows
  //    j = tid + r kBuildThreads of the tile and its halo in v[r]
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int a = tile * kTile;
    int32_t v[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      int j = tid + r * kBuildThreads;
      v[r] = a + j < m ? __ldg(values + a + j) : kIdent;
    }
    for (int k = 0;; ++k) {
      int32_t* row = table + static_cast<size_t>(k) * m + a;
#pragma unroll
      for (int r = 0; r < kTile / kBuildThreads; ++r) {
        int j = tid + r * kBuildThreads;
        if (a + j < m) row[j] = v[r];
      }
      if (k == in_tile) break;
      // level k + 1 at j: op of level k at j and j + 2^k; rows whose
      // partner lies past the halo keep their value (no level reads them)
      const int h = 1 << k;
      if (h >= kBuildThreads) {  // the partner is the thread's own row
        if (h == kBuildThreads) fold_own<MIN, 1>(v);
        else fold_own<MIN, 2>(v);
      } else {
        // exchange through one of two buffers: the sync after the writes
        // also orders the reads of the level before against the next
        // writes to the other buffer
        int32_t* x = xbuf + (k & 1) * kSpan;
#pragma unroll
        for (int r = 0; r < kPer; ++r) x[tid + r * kBuildThreads] = v[r];
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          int j = tid + r * kBuildThreads + h;
          if (j < kSpan) v[r] = op<MIN>(v[r], x[j]);
        }
      }
    }
    __syncthreads();  // the last exchange's reads are done
  }

  // -- 2: the levels above a tile, two per grid sync: level k at i is op
  //    of level k - 1 at i and i + h, level k + 1 of the four at i + e h,
  //    h = 2^(k-1). A read past the end takes the identity: the window
  //    that reaches m is already clamped there (an idempotent op), and no
  //    thread reads row m - 1 of a level all at once. Two rows a thread an
  //    iteration, their eight reads issued first
  const int stride = gridDim.x * kBuildThreads;
  for (int k = in_tile + 1; k < levels; k += 2) {
    grid.sync();  // level k - 1 is whole
    const int h = 1 << (k - 1);
    const bool two = k + 1 < levels;
    const int32_t* prev = table + static_cast<size_t>(k - 1) * m;
    int32_t* out = table + static_cast<size_t>(k) * m;
    for (int i0 = blockIdx.x * kBuildThreads + tid; i0 < m;
         i0 += 2 * stride) {
      int32_t x[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + u * stride;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[u][e] = i < m && (e < 2 || two) &&
                            static_cast<long long>(e) * h < m - i
                        ? __ldcg(prev + i + e * h)
                        : kIdent;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + u * stride;
        if (i >= m) break;
        int32_t y = op<MIN>(x[u][0], x[u][1]);
        out[i] = y;
        if (two) out[m + i] = op<MIN>(y, op<MIN>(x[u][2], x[u][3]));
      }
    }
  }
}

struct Plan {
  int blocks;  // one block per SM
  int err;     // a CUDA error from asking, 0 if none
};

// The kernel's grid, asked once per op (C++ statics): one block per SM.
// A fuller grid is not faster: the scheduler places a cooperative grid's
// first blocks several to an SM, so the tiles would crowd a few SMs.
template <bool MIN>
const Plan& plan() {
  static const Plan p = [] {
    Plan r{0, 0};
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(
        build_kernel<MIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, build_kernel<MIN>, kBuildThreads, kSmemBytes);
    r.err = static_cast<int>(e);
    r.blocks = per_sm > 0 ? sms : 0;
    if (r.err == 0 && r.blocks <= 0)
      r.err = static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    return r;
  }();
  return p;
}

template <bool MIN>
int launch(const int32_t* values, int32_t* table, int m, int levels,
           cudaStream_t stream) {
  if (plan<MIN>().err) return plan<MIN>().err;
  // every tile a block in phase 1; every SM for the passes above it
  long long want = (m + kTile - 1LL) / kTile;
  if (levels - 1 > kTileBits) want = plan<MIN>().blocks;
  int g = static_cast<int>(want < plan<MIN>().blocks ? want
                                                     : plan<MIN>().blocks);
  void* args[] = {&values, &table, &m, &levels};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(build_kernel<MIN>), dim3(g),
      dim3(kBuildThreads), args, kSmemBytes, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The [levels, m] table of values[m] in one launch: at most
// bit_length(m - 1) + 1 levels (the wrapper's _num_levels); fewer build a
// truncated table that kernel A's query reads exactly.
int rm_build(const void* values, void* table, int m, int levels, int op_min,
             void* stream) {
  if (m <= 0) return kNoLaunch;
  if (levels < 1 || levels > 32) return static_cast<int>(cudaErrorInvalidValue);
  auto v = static_cast<const int32_t*>(values);
  auto t = static_cast<int32_t*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return op_min ? launch<true>(v, t, m, levels, s)
                : launch<false>(v, t, m, levels, s);
}

}  // extern "C"
