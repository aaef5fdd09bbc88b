// Kernel C: min_cover — for each leaf, the min of val[j] over the
// intervals [lo_j, hi_j) that cover it, in one launch.
//
// Replaces K5, foundationdb_tpu/ops/segtree.py:25 min_cover, with the same
// two-step cover over a [log + 1, leaves] table t:
//   scatter  each interval (clipped to [0, leaves]) with len = hi - lo > 0
//            min's its value into level k = floor(log2(len)) at lo and at
//            hi - 2^k; an interval with lo >= hi touches nothing;
//   sweep    for j = log .. 1:
//              t[j-1][i] = min(t[j-1][i], t[j][i], t[j][i - 2^(j-1)]),
//            the shifted operand +inf for i < 2^(j-1); t[0] is the answer,
//            INT32_POS where no interval covers the leaf.
//
// Bound on this card: bytes. The function reads lo, hi and val once and
// writes the leaves once: 4 (3n + leaves) B, 1.8 MB at 65,536 intervals and
// 2^18 leaves, 0.55 us at 3.35 TB/s. The scratch table is the design's, not
// the function's (its floor is below).
//
// Design: ONE persistent cooperative launch of one 1,024-thread block per
// SM (a fuller grid puts its first blocks several to an SM: see
// rangemax_build.cu), where the first design ran a torch.full, a scatter
// launch and one launch per sweep level:
//   0  fill the table with INT32_POS (16-byte stores); grid sync;
//   1  the scatter, grid-stride over the intervals, native 32-bit atomicMin
//      in L2; grid sync;
//   2  the levels above a tile, three per pass: from the whole level j,
//      t[j-3][i] takes the whole level j - 2 at i and i - 2^(j-3), each
//      from the whole level j - 1 at two leaves, each pushed down from
//      level j (fifteen reads a leaf from L2, two leaves a thread in
//      flight; levels j - 1 and j - 2 are never written); a grid sync
//      after each pass. At 2^18 leaves, 3 passes (18 -> 15 -> 12 -> 9);
//   3  no sync: each block sweeps its tile [a, a + kTile) down the levels
//      left (log2(kTile) and below) in shared memory, over the extended
//      range [a - kTile, a + kTile) (the left halo the shifted operand
//      reads). It first copies every level's rows that the tile's answer
//      needs ([a - 2^l + 1, a + kTile) of level l, rounded out to 16-byte
//      chunks) with cp.async, which holds no registers, so all the copies
//      are in flight at once (read through registers the phase took 11.1
//      us at 2^18 on an H100, with cp.async 7.2: phase_trace); then two
//      levels a step, one __syncthreads a step, and its tile of t[0] is
//      written once. Those levels never go back to device memory.
// The floor of this design is the fill (19 MB at 2^18, 5.6 us) plus the
// passes (3 x 4 MB read, 1 MB written each, L2-resident); the scatter's 2n
// atomics and 5 grid syncs (~0.9 us each on an H100, kernels/phase_trace.py
// --kernel min_cover) come on top.
//
// Kernel M's cover (mc_cover4) is the same kernel at radix 4 (RB = 2). It
// replaces K19's min_cover4, foundationdb_tpu/ops/segtree.py:79: a table of
// nlev = (log2(leaves) + 1) / 2 + 1 levels, level j of spans 4^j (for an
// odd log2 width the top level's span passes the leaves, as JAX builds
// it; no interval lands there); each interval lands at level k =
// min(floor(log2(len)) >> 1, nlev - 1) at the four positions min(lo +
// c 4^k, hi - 4^k), c = 0..3; then for j = nlev - 1 .. 1
//   t[j-1][i] = min(t[j-1][i], t[j][i - c 4^(j-1)], c = 0..3),
// the shifted operands +inf left of leaf 0. The phases are the ones above:
// 0 the fill of nlev levels (10 at 2^18: 10.5 MB, 3.1 us, where the radix-2
// table's 19 take 5.6); 1 the scatter, an atomicMin at each distinct one
// of the four positions (an interval shorter than 4^(k+1) repeats its
// last, and atomics in a row on one address wait on each other); 2 the
// levels above a tile, two per pass (21 reads a leaf: level j - 2 at i and
// the whole level j - 1 at i - c 4^(j-2), each from level j at four
// leaves; two leaves a thread, their reads in flight together), one when
// one is left; 3 each tile down the levels 5 .. 1 in shared memory (4^5
// - 1 < 2,048, the left halo), one level a step. At
// 2^18 leaves: 2 passes (9 -> 7 -> 5), 4 grid syncs, where the first
// design ran a torch.full, a scatter launch and 9 sweep launches.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

using namespace fdb;
namespace cg = cooperative_groups;

constexpr int kCoverThreads = 1024;
constexpr int kTileBits = 11;
constexpr int kTile = 1 << kTileBits;          // leaves a block sweeps in smem
constexpr int kSpan = 2 * kTile;               // the tile and its left halo
// Shared memory: two sweep buffers over the span, then the scattered rows
// of each level l below the tile's top that the tile reads, the leaves
// [a - halo(l), a + kTile) (halo(l) >= 2^l - 1, a multiple of 4 so that
// every copy is of whole 16-byte chunks), level l from word raw_off(l).
constexpr int kRawWords = kTileBits * kTile + kTile;
constexpr int kSmemBytes = (2 * kSpan + kRawWords) * 4;

// radix 4's top level swept in shared memory: 4^5 - 1 < kTile
constexpr int kTileLevels4 = kTileBits / 2;

struct Args {
  const int32_t* lo;
  const int32_t* hi;
  const int32_t* val;
  int n;
  int leaves;
  int log;     // log2(leaves)
  int levels;  // the table's levels: log + 1 at radix 2, nlev at radix 4
  int32_t* table;
};

// The rows [a - halo(l), a + kTile) of level l a tile reads (halo(l) >=
// span(l) - 1, a multiple of 4), RB the radix's log2.
template <int RB>
__device__ __forceinline__ int halo(int l) {
  if constexpr (RB == 1) return l == 0 ? 0 : l == 1 ? 4 : 1 << l;
  return l == 0 ? 0 : 1 << (2 * l);
}

// level l's scattered rows start at raw[raw_off(l)]: each level below
// takes kTile + halo words
template <int RB>
__device__ __forceinline__ int raw_off(int l) {
  if constexpr (RB == 1) return l * kTile + (l < 2 ? 0 : 1 << l);
  return l * kTile + (l < 2 ? 0 : ((1 << (2 * l)) - 4) / 3);
}

// span row p of level l's scattered rows is raw[raw_at(l) + p]
template <int RB>
__device__ __forceinline__ int raw_at(int l) {
  return raw_off<RB>(l) - (kTile - halo<RB>(l));
}

// 16 bytes from device memory (L2) to shared memory, asynchronously
__device__ __forceinline__ void copy16(int32_t* dst, const int32_t* src) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// t[j][x] of a level read in this launch; +inf left of the leaves
__device__ __forceinline__ int32_t at(const int32_t* row, int x) {
  return x >= 0 ? __ldcg(row + x) : INT32_POS;
}

// RB: log2 of the radix, 1 (kernel C, K5's min_cover) or 2 (kernel M's
// min_cover4).
template <int RB>
__global__ void __launch_bounds__(kCoverThreads) cover_kernel(Args a) {
  extern __shared__ int32_t smem[];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int leaves = a.leaves;
  const int first = blockIdx.x * kCoverThreads + tid;
  const int stride = gridDim.x * kCoverThreads;
  const size_t words = static_cast<size_t>(a.levels) * leaves;

  // -- 0: fill (16-byte stores over whole 4-word groups, then the tail)
  {
    int4 inf4 = make_int4(INT32_POS, INT32_POS, INT32_POS, INT32_POS);
    int4* t4 = reinterpret_cast<int4*>(a.table);
    const size_t quads = words / 4;
    for (size_t i = first; i < quads; i += stride) t4[i] = inf4;
    for (size_t i = quads * 4 + first; i < words; i += stride)
      a.table[i] = INT32_POS;
  }
  grid.sync();

  // -- 1: the scatter
  for (int j = first; j < a.n; j += stride) {
    int l = min(max(a.lo[j], 0), leaves);
    int h = min(max(a.hi[j], 0), leaves);
    if (h <= l) continue;
    int32_t v = a.val[j];
    if constexpr (RB == 1) {
      int k = floor_log2(h - l);
      int32_t* row = a.table + static_cast<size_t>(k) * leaves;
      atomicMin(row + l, v);
      atomicMin(row + (h - (1 << k)), v);
    } else {
      int k = min(floor_log2(h - l) >> 1, a.levels - 1);
      int s = 1 << (2 * k);
      int32_t* row = a.table + static_cast<size_t>(k) * leaves;
      // the positions are nondecreasing in c: an interval shorter than
      // 4 s repeats its last one, which takes one atomic, not several in
      // a row on one address
      int last = -1;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = min(l + c * s, h - s);
        if (p != last) atomicMin(row + p, v);
        last = p;
      }
    }
  }
  grid.sync();

  // -- 2: the levels above a tile, three per pass: level top - 3 at i,
  //    whole, from the whole level top and the scattered rows of the two
  //    levels between, each pushed down in the same pass (levels top - 1
  //    and top - 2 are never written): fifteen reads a leaf, +inf left of
  //    leaf 0
  int top = a.levels - 1;  // the highest level whose rows are whole
  if constexpr (RB == 2) {
    // radix 4: level top - 2 at i, whole, from its own row, the whole
    // level top - 1 at i - c 4^(top-2) and, for each of those, level top at
    // four leaves (level top - 1 is never written); one level when one is
    // left: twenty-one or five reads a leaf, +inf left of leaf 0
    while (top > kTileLevels4) {
      const bool two = top - 2 >= kTileLevels4;
      const int lo = two ? top - 2 : top - 1;  // the level this pass makes
      int32_t* out = a.table + static_cast<size_t>(lo) * leaves;
      const int32_t* r1 = a.table + static_cast<size_t>(top - 1) * leaves;
      const int32_t* tw = r1 + leaves;
      const int s1 = 1 << (2 * (top - 1)), s2 = s1 >> 2;
      // two leaves a thread an iteration, their reads issued first
      for (int i0 = first; i0 < leaves; i0 += 2 * stride) {
        int32_t v[2];
        if (two) {
          // level top at i - f s2, f = c + 4 e, and level top - 1 at
          // i - c s2: the whole level top - 1 at the four leaves
          int32_t w[2][4][5];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = i0 + u * stride;
            const bool ok = i < leaves;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int x = i - c * s2;
              w[u][c][0] = ok ? at(r1, x) : INT32_POS;
#pragma unroll
              for (int e = 0; e < 4; ++e)
                w[u][c][e + 1] = ok ? at(tw, x - e * s1) : INT32_POS;
            }
            v[u] = ok ? __ldcg(out + i) : INT32_POS;
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
              for (int e = 0; e < 5; ++e) v[u] = min(v[u], w[u][c][e]);
        } else {
          int32_t w[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = i0 + u * stride;
            const bool ok = i < leaves;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              w[u][e] = ok ? at(tw, i - e * s1) : INT32_POS;
            v[u] = ok ? __ldcg(out + i) : INT32_POS;
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
            v[u] = min(v[u], min(min(w[u][0], w[u][1]),
                                 min(w[u][2], w[u][3])));
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (i0 + u * stride < leaves) out[i0 + u * stride] = v[u];
      }
      top = lo;
      grid.sync();
    }
  } else {
    while (top > kTileBits) {
      int32_t* r3 = a.table + static_cast<size_t>(top - 3) * leaves;
      const int32_t* r2 = r3 + leaves;
      const int32_t* r1 = r2 + leaves;
      const int32_t* tw = r1 + leaves;
      const int h1 = 1 << (top - 1), h2 = h1 >> 1, h3 = h2 >> 1;
      // two leaves a thread an iteration, their thirty reads issued first
      for (int i0 = first; i0 < leaves; i0 += 2 * stride) {
        int32_t w1[2][4][3], r2a[2], r2b[2], own[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          // level top - 1 at the four leaves level top - 3 at i reaches
          const int i = i0 + u * stride;
          const bool ok = i < leaves;
          const int z[4] = {i, i - h2, i - h3, i - h3 - h2};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            w1[u][q][0] = ok ? at(r1, z[q]) : INT32_POS;
            w1[u][q][1] = ok ? at(tw, z[q]) : INT32_POS;
            w1[u][q][2] = ok ? at(tw, z[q] - h1) : INT32_POS;
          }
          r2a[u] = ok ? __ldcg(r2 + i) : INT32_POS;
          r2b[u] = ok ? at(r2, i - h3) : INT32_POS;
          own[u] = ok ? __ldcg(r3 + i) : INT32_POS;
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = i0 + u * stride;
          int32_t w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            w[q] = min(w1[u][q][0], min(w1[u][q][1], w1[u][q][2]));
          if (i < leaves)
            r3[i] = min(own[u], min(min(r2a[u], min(w[0], w[1])),
                                    min(r2b[u], min(w[2], w[3]))));
        }
      }
      top -= 3;
      grid.sync();
    }
  }

  // -- 3: each tile down the levels top .. 1 in shared memory: the rows
  //    it reads of every level at once (the top level whole into the sweep
  //    buffer, the ones below scattered), as asynchronous 16-byte copies
  //    that hold no registers, so all are in flight together; then the
  //    sweep
  int32_t* cur = smem;               // level j over the span
  int32_t* nxt = smem + kSpan;       // level j - 1
  int32_t* raw = smem + 2 * kSpan;   // the scattered rows of each level
  const int tiles = (leaves + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int base = tile * kTile - kTile;  // leaf of span row 0
    for (int l = 0; l <= top; ++l) {
      const int32_t* row = a.table + static_cast<size_t>(l) * leaves;
      const int from = base + kTile - halo<RB>(l);  // a multiple of 4
      int32_t* dst =
          l == top ? cur + (kTile - halo<RB>(l)) : raw + raw_off<RB>(l);
      for (int c = tid; c < (kTile + halo<RB>(l)) / 4; c += kCoverThreads) {
        const int x = from + 4 * c;
        if (x >= 0 && x + 4 <= leaves) {
          copy16(dst + 4 * c, row + x);
        } else {  // left of leaf 0 (the first tile) or past a small width
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dst[4 * c + e] = x + e >= 0 && x + e < leaves ? __ldcg(row + x + e)
                                                          : INT32_POS;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    if constexpr (RB == 2) {
      // radix 4, one level a step: level j - 1 at p from its own row and
      // level j at p - c 4^(j-1), c = 0..3 (level j's rows reach back
      // halo(j) >= halo(j - 1) + 3 4^(j-1) from the tile, so every operand
      // lies in the span rows level j holds)
      for (int j = top; j >= 1; --j) {
        const int s = 1 << (2 * (j - 1));
        const int o = raw_at<RB>(j - 1);
        for (int p = kTile - halo<RB>(j - 1) + tid; p < kSpan;
             p += kCoverThreads) {
          const int x = base + p;
          int32_t v = INT32_POS;
          if (x >= 0 && x < leaves)
            v = min(min(raw[o + p], cur[p]),
                    min(cur[p - s], min(cur[p - 2 * s], cur[p - 3 * s])));
          nxt[p] = v;
        }
        int32_t* t = cur;
        cur = nxt;
        nxt = t;
        __syncthreads();
      }
    } else {
      // two levels a step (the last one single when top is odd), as in
      // phase 2: level j - 2 at p from level j - 1 at p and p - 2^(j-2),
      // each pushed down from level j in the same step
      for (int j = top; j >= 1; j -= 2) {
        const bool two = j >= 2;
        const int h1 = 1 << (j - 1);
        const int lo = two ? j - 2 : j - 1;        // the level this step makes
        const int h = 1 << lo;
        const int o1 = raw_at<RB>(j - 1), o2 = raw_at<RB>(lo);
        auto whole1 = [&](int p) {  // level j - 1 at span row p, whole
          int x = base + p;
          return x >= 0 && x < leaves
                     ? min(raw[o1 + p], min(cur[p], cur[p - h1]))
                     : INT32_POS;
        };
        for (int p = kTile - h + 1 + tid; p < kSpan; p += kCoverThreads) {
          int x = base + p;
          int32_t v = INT32_POS;
          if (x >= 0 && x < leaves)
            v = two ? min(raw[o2 + p], min(whole1(p), whole1(p - h)))
                    : whole1(p);
          nxt[p] = v;
        }
        int32_t* t = cur;
        cur = nxt;
        nxt = t;
        __syncthreads();
      }
    }
    for (int p = kTile + tid; p < kSpan && base + p < leaves;
         p += kCoverThreads)
      a.table[base + p] = cur[p];
    __syncthreads();  // the tile's last reads of the buffers are done
  }
}

struct Plan {
  int blocks;  // one block per SM
  int err;     // a CUDA error from asking, 0 if none
};

// The kernel's grid, asked once per radix (C++ statics): one block per
// SM. A fuller grid is not faster: the scheduler places a cooperative
// grid's first blocks several to an SM, so the tiles would crowd a few SMs.
template <int RB>
const Plan& plan() {
  static const Plan p = [] {
    Plan r{0, 0};
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(
        cover_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cover_kernel<RB>, kCoverThreads, kSmemBytes);
    r.err = static_cast<int>(e);
    r.blocks = per_sm > 0 ? sms : 0;
    if (r.err == 0 && r.blocks <= 0)
      r.err = static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    return r;
  }();
  return p;
}

// One launch of the cover at radix 2^RB into a [levels, leaves] table.
template <int RB>
int launch(const void* lo, const void* hi, const void* val, int n,
           int leaves, void* table, cudaStream_t stream) {
  if (leaves <= 0 || (leaves & (leaves - 1)) || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan& p = plan<RB>();
  if (p.err) return p.err;
  Args a;
  a.lo = static_cast<const int32_t*>(lo);
  a.hi = static_cast<const int32_t*>(hi);
  a.val = static_cast<const int32_t*>(val);
  a.n = n;
  a.leaves = leaves;
  a.log = 31 - __builtin_clz(static_cast<unsigned>(leaves));
  a.levels = RB == 1 ? a.log + 1 : (a.log + 1) / 2 + 1;
  a.table = static_cast<int32_t*>(table);
  // enough blocks for the fill (16 words a thread) and every tile
  long long words = static_cast<long long>(a.levels) * leaves;
  long long want = (words + 16LL * kCoverThreads - 1) / (16LL * kCoverThreads);
  long long tiles = (leaves + kTile - 1LL) / kTile;
  if (tiles > want) want = tiles;
  int g = static_cast<int>(want < p.blocks ? want : p.blocks);
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(cover_kernel<RB>), dim3(g),
      dim3(kCoverThreads), args, kSmemBytes, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The per-leaf cover of n intervals into table[0]; table is the
// [log + 1, leaves] scratch (leaves a power of two), written whole here.
int mc_cover(const void* lo, const void* hi, const void* val, int n,
             int leaves, void* table, void* stream) {
  return launch<1>(lo, hi, val, n, leaves, table,
                   static_cast<cudaStream_t>(stream));
}

// Kernel M's radix-4 cover (min_cover4) into table[0]; table is the
// [(log + 1) / 2 + 1, leaves] scratch, written whole here.
int mc_cover4(const void* lo, const void* hi, const void* val, int n,
              int leaves, void* table, void* stream) {
  return launch<2>(lo, hi, val, n, leaves, table,
                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
