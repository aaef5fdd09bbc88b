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
//
// Kernel M's build (rm4_build) is the same kernel at radix 4 (RB = 2).
// It replaces K19's build4, foundationdb_tpu/ops/rangemax.py:190:
//   t[0]    = values
//   t[k][i] = op(t[k-1][min(i + sh_j, m - 1)], j = 0..3),
//   sh_j    = min(j * s, m - 1), s = min(4^(k-1), m - 1),
// i.e. op over values[i : i + 4^k] clamped at the array end, for every
// k >= 1 with 4^(k-1) < m, which with the identity past m (as above) is
// radix-2 level 2k. Phase 1 builds the radix-4 levels 0 .. 6 of a
// 2,048-row tile over a 4,096-row halo (4^6 rows the top window; 128
// tiles at 2^18 leaves, one an SM) one exchange a level, level k + 1 at j
// the op of level k at j + c 4^k, c = 0..3 (other threads' rows through
// shared memory below 4^k = 1,024, the thread's own at 1,024); phase 2
// makes two
// radix-4 levels a grid sync: level k from level k - 1 at i + e 4^(k-1),
// e = 0..3, and level k + 1 from the same level at e = 0..15, two rows a
// thread with their loads in flight together. At 2^18 leaves (10 levels):
// 2 syncs for levels 7 .. 9. Its bound: bytes, (1 + L4) x 4 B x m, 10.5
// MB at 2^18 (3.1 us), where the first design launched once per level.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

using namespace fdb;
namespace cg = cooperative_groups;

constexpr int kBuildThreads = 1024;

// A block's tile at radix 2^RB: its rows, the span it loads (the tile and
// the halo its top level reads), its top level (in radix-2 levels: 2^top
// rows a window) and its shared memory. Radix 2: a 4,096-row tile and a
// 4,096-row halo. Radix 4: a 2,048-row tile and a 4,096-row halo, so that
// the fixpoint's 2^18 leaves make 128 tiles, one an SM (4,096-row tiles
// left half the SMs idle in phase 1: 5.9 us there against 4.7,
// kernels/phase_trace.py --kernel rangemax4_build).
template <int RB>
struct Tile {
  static constexpr int rows = RB == 1 ? 4096 : 2048;
  static constexpr int span = rows + 4096;
  static constexpr int per = span / kBuildThreads;  // halo'd rows a thread
  static constexpr int top = 12;
  static constexpr int smem = 2 * span * 4;  // two exchange buffers
};

template <bool MIN>
__device__ __forceinline__ int32_t op(int32_t a, int32_t b) {
  return MIN ? min(a, b) : max(a, b);
}

// v[r] = op(v[r], v[r + D]) where r + D is in the span: the partner row
// j + D x kBuildThreads is the same thread's (ascending r reads the old
// value)
template <bool MIN, int D, int N>
__device__ __forceinline__ void fold_own(int32_t (&v)[N]) {
#pragma unroll
  for (int r = 0; r + D < N; ++r) v[r] = op<MIN>(v[r], v[r + D]);
}

// radix 4 at 4^k = kBuildThreads: v[r] = op(v[r], v[r + c]), c = 1..3,
// where r + c is in the span (the rows past it are never read)
template <bool MIN, int N>
__device__ __forceinline__ void fold_own4(int32_t (&v)[N]) {
#pragma unroll
  for (int r = 0; r + 1 < N; ++r) {
#pragma unroll
    for (int c = 1; c < 4; ++c)
      if (r + c < N) v[r] = op<MIN>(v[r], v[r + c]);
  }
}

// Radix 4 above the tile: out[i] = op of prev at i + e h, e < 4, and with
// E = 16 out[m + i] = op of prev at i + e h, e < 16 (the next level); two
// rows a thread, their E reads each issued first, the identity past m.
template <bool MIN, int E>
__device__ __forceinline__ void radix4_pass(const int32_t* prev,
                                            int32_t* out, int m, int h,
                                            int stride) {
  constexpr int32_t kIdent = MIN ? INT32_POS : INT32_NEG;
  for (int i0 = blockIdx.x * kBuildThreads + threadIdx.x; i0 < m;
       i0 += 2 * stride) {
    int32_t x[2][E];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * stride;
#pragma unroll
      for (int e = 0; e < E; ++e)
        x[u][e] = i < m && static_cast<long long>(e) * h < m - i
                      ? __ldcg(prev + i + e * h)
                      : kIdent;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * stride;
      if (i >= m) break;
      int32_t y = op<MIN>(op<MIN>(x[u][0], x[u][1]), op<MIN>(x[u][2], x[u][3]));
      out[i] = y;
      if (E == 16) {
#pragma unroll
        for (int e = 4; e < E; ++e) y = op<MIN>(y, x[u][e]);
        out[m + i] = y;
      }
    }
  }
}

// The top radix-2 level of a table of `levels` levels at radix 2^RB.
template <int RB>
__host__ __device__ __forceinline__ int top_bits(int levels) {
  return RB * (levels - 1);
}

// RB: log2 of the radix, 1 (kernel B, K3's build) or 2 (kernel M's build4,
// whose level k is radix-2 level 2k).
template <bool MIN, int RB>
__global__ void __launch_bounds__(kBuildThreads)
build_kernel(const int32_t* __restrict__ values, int32_t* __restrict__ table,
             int m, int levels) {
  constexpr int kTile = Tile<RB>::rows;
  constexpr int kSpan = Tile<RB>::span;
  constexpr int kPer = Tile<RB>::per;
  extern __shared__ int32_t xbuf[];  // [2][kSpan]
  constexpr int32_t kIdent = MIN ? INT32_POS : INT32_NEG;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int tiles = (m + kTile - 1) / kTile;
  // top radix-2 level built here
  const int in_tile = min(top_bits<RB>(levels), Tile<RB>::top);

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
    if constexpr (RB == 2) {
      // radix 4: level k + 1 at j is op of level k at j + c 4^k, c < 4
      for (int k = 0;; ++k) {
        int32_t* row = table + static_cast<size_t>(k) * m + a;
#pragma unroll
        for (int r = 0; r < kTile / kBuildThreads; ++r) {
          int j = tid + r * kBuildThreads;
          if (a + j < m) row[j] = v[r];
        }
        if (2 * k == in_tile) break;
        const int s = 1 << (2 * k);
        if (s >= kBuildThreads) {
          fold_own4<MIN>(v);
        } else {
          int32_t* x = xbuf + (k & 1) * kSpan;
#pragma unroll
          for (int r = 0; r < kPer; ++r) x[tid + r * kBuildThreads] = v[r];
          __syncthreads();
#pragma unroll
          for (int r = 0; r < kPer; ++r) {
            const int j = tid + r * kBuildThreads;
#pragma unroll
            for (int c = 1; c < 4; ++c)
              if (j + c * s < kSpan) v[r] = op<MIN>(v[r], x[j + c * s]);
          }
        }
      }
    } else {
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
  if constexpr (RB == 2) {
    // radix 4: level k at i is op of level k - 1 at i + e h, e = 0..3,
    // level k + 1 of the sixteen at e = 0..15, h = 4^(k-1), issued first
    for (int k = in_tile / 2 + 1; k < levels; k += 2) {
      grid.sync();  // level k - 1 is whole
      const int h = 1 << (2 * (k - 1));
      const bool two = k + 1 < levels;
      const int32_t* prev = table + static_cast<size_t>(k - 1) * m;
      int32_t* out = table + static_cast<size_t>(k) * m;
      if (two)
        radix4_pass<MIN, 16>(prev, out, m, h, stride);
      else
        radix4_pass<MIN, 4>(prev, out, m, h, stride);
    }
  } else {
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
}

struct Plan {
  int blocks;  // one block per SM
  int err;     // a CUDA error from asking, 0 if none
};

// The kernel's grid, asked once per op and radix (C++ statics): one block
// per SM. A fuller grid is not faster: the scheduler places a cooperative
// grid's first blocks several to an SM, so the tiles would crowd a few SMs.
template <bool MIN, int RB>
const Plan& plan() {
  static const Plan p = [] {
    Plan r{0, 0};
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(
        build_kernel<MIN, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<RB>::smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, build_kernel<MIN, RB>, kBuildThreads, Tile<RB>::smem);
    r.err = static_cast<int>(e);
    r.blocks = per_sm > 0 ? sms : 0;
    if (r.err == 0 && r.blocks <= 0)
      r.err = static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    return r;
  }();
  return p;
}

template <bool MIN, int RB>
int launch(const int32_t* values, int32_t* table, int m, int levels,
           cudaStream_t stream) {
  const Plan& p = plan<MIN, RB>();
  if (p.err) return p.err;
  // every tile a block in phase 1; every SM for the passes above it
  long long want = (m + Tile<RB>::rows - 1LL) / Tile<RB>::rows;
  if (top_bits<RB>(levels) > Tile<RB>::top) want = p.blocks;
  int g = static_cast<int>(want < p.blocks ? want : p.blocks);
  void* args[] = {&values, &table, &m, &levels};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(build_kernel<MIN, RB>), dim3(g),
      dim3(kBuildThreads), args, Tile<RB>::smem, stream);
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
  return op_min ? launch<true, 1>(v, t, m, levels, s)
                : launch<false, 1>(v, t, m, levels, s);
}

// Kernel M's radix-4 [levels, m] table of values[m] in one launch (build4,
// levels = 1 + #{k >= 1 : 4^(k-1) < m}, the wrapper's _num_levels4).
int rm4_build(const void* values, void* table, int m, int levels, int op_min,
              void* stream) {
  if (m <= 0) return kNoLaunch;
  if (levels < 1 || levels > 16) return static_cast<int>(cudaErrorInvalidValue);
  auto v = static_cast<const int32_t*>(values);
  auto t = static_cast<int32_t*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return op_min ? launch<true, 2>(v, t, m, levels, s)
                : launch<false, 2>(v, t, m, levels, s);
}

}  // extern "C"
