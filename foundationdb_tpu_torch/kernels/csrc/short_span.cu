// Kernel K: short_span — the group kernel's direct S-wide range ops, served
// when KernelConfig.short_span_limit = S > 0.
//
// Replaces K13, foundationdb_tpu/ops/group.py:350-378, 460-490, 511-523
// (the `short_span_limit` branches of resolve_group):
//   ss_range  direct_range_op (:353-363): per query, op (max or min) over
//             values[lo : hi] by at most S direct reads,
//               acc = identity
//               for d < S: pos = lo + d
//                          acc = op(acc, pos < hi ? values[clamp(pos, 0, n-1)]
//                                                 : identity)
//             one thread per query; the identity where hi <= lo. It stands
//             in for the tier's max table and probe (phase b) and the
//             cross phase's two-level table (G > 1);
//   ss_apply  one application of the fixpoint (:511-519, then :353-363 with
//             op min): the writers' cover — for every write j with
//             val_j != INT32_POS and each d < S with lo_j + d < hi_j inside
//             [0, leaves), min val_j into leaf lo_j + d of a buffer of
//             INT32_POS — and the reads' min over that cover, as ss_range.
// Both are exact when no live range spans more than S positions; the
// caller latches every span (overflow) as the JAX program does, so a wider
// range is refused, never answered from a truncated read.
//
// Bound on this card: bytes. ss_range reads lo, hi and writes out (12 B a
// query) plus the values it covers (4 B each, at most S a query); ss_apply
// reads each write's lo, hi, val and each read's lo, hi and writes its min
// (12 B a write, 12 B a read), and writes and reads back each covered leaf
// (the int32 min, 4 B, twice; this design moves 8 B a leaf). At the
// uniform fixpoint's shapes (65,536 point reads and writes, spans of one
// or two of 2^18 leaves) that is about 2 MB: a fraction of a microsecond.
// ss_range stays the simplest form that is right: one thread per query, a
// loop of at most S steps that stops at hi; its time is launch latency.
//
// ss_apply design: ONE cooperative launch per application, and no fill.
// The first form was three steps: a fill of a fresh 2^18-leaf buffer
// with INT32_POS, the cover's launch and the min query's launch. Here the
// buffer outlives the launch, so it must read as all INT32_POS at the
// next one without a pass over it. Each leaf is 64 bits,
// (stamp << 32) | (val ^ 0x80000000) — the low word orders as the signed
// val — and the word after the last leaf holds the current stamp s; the
// cover takes a native 64-bit atomicMin (no return: a `red.min` into L2),
// one grid sync, then the query, which reads a leaf whose high word is not
// s as INT32_POS. After the sync block 0 writes s - 1 for the next launch
// (every block read s at its entry), so a smaller stamp makes every older
// leaf larger than any new value, and stale. All ones, a fresh buffer's
// content, is stamp 0xFFFFFFFF and the low word of INT32_POS: it reads as
// INT32_POS under every stamp. The launch that holds stamp 0, one in 2^32,
// takes a second grid sync and sets every leaf and the stamp back to all
// ones. The stamp lives on the card: nothing comes from the host, so a
// CUDA graph replays the launch as it is. The buffer is one per (device,
// stream), so two streams at once each have their own; a graph's capture
// makes its own in the graph's memory, filled at each replay.
// It was chosen over 32-bit leaves set back to INT32_POS on exit (a
// second grid sync, then each committed write resets its leaves), which
// took ~1.8 us more a launch on an H100 (PERF.md). There, at the uniform
// fixpoint's shape (phase_trace.py --kernel short_span), the cover takes
// ~1.0 us, the grid sync ~1.3 and the query ~1.3: ~5.0 us of device time
// a launch against 5.7 for the fill, cover and query launches it
// replaced.

#include <cooperative_groups.h>

#include "common.cuh"

#ifndef FDB_MARK
#define FDB_MARK(k)  // phase_trace.py's %globaltimer marks; none here
#endif

namespace {

using namespace fdb;
namespace cg = cooperative_groups;

constexpr int kApplyThreads = 512;

template <bool MIN>
__global__ void range_kernel(const int32_t* __restrict__ values, int n,
                             const int32_t* __restrict__ lo,
                             const int32_t* __restrict__ hi, int q, int span,
                             int32_t* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  int l = lo[i];
  int h = hi[i];
  int32_t acc = MIN ? INT32_POS : INT32_NEG;
  for (int d = 0; d < span; ++d) {
    int pos = l + d;
    if (pos >= h) break;
    int32_t v = __ldg(values + min(max(pos, 0), n - 1));
    acc = MIN ? min(acc, v) : max(acc, v);
  }
  out[i] = acc;
}

__device__ __forceinline__ uint32_t order_bits(int32_t v) {
  return static_cast<uint32_t>(v) ^ 0x80000000u;
}

__device__ __forceinline__ int32_t from_order_bits(uint32_t u) {
  return static_cast<int32_t>(u ^ 0x80000000u);
}

// The positions a range [l, h) takes: at most `span`, none where h <= l.
__device__ __forceinline__ int steps(int l, int h, int span) {
  long long n = static_cast<long long>(h) - l;
  return static_cast<int>(n < span ? (n > 0 ? n : 0) : span);
}

__global__ void __launch_bounds__(kApplyThreads)
    apply_kernel(const int32_t* __restrict__ wlo,
                 const int32_t* __restrict__ whi,
                 const int32_t* __restrict__ val, int nw,
                 const int32_t* __restrict__ qlo,
                 const int32_t* __restrict__ qhi, int nr, int span,
                 int leaves, unsigned long long* __restrict__ flat, int cap,
                 int32_t* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  const long long gtid = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
  const long long gthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned long long* stamp_word = flat + cap;
  const uint32_t s = static_cast<uint32_t>(__ldcg(stamp_word));
  const unsigned long long stamp = static_cast<unsigned long long>(s) << 32;
  // this thread's first read, loaded now: its latency passes under the
  // cover and the grid sync
  int l0 = 0, h0 = 0;
  if (gtid < nr) l0 = qlo[gtid], h0 = qhi[gtid];

  // -- 1. cover: each committed write's leaves, min by a 64-bit atomic ---
  FDB_MARK(0)
  for (long long j = gtid; j < nw; j += gthreads) {
    int32_t v = val[j];
    if (v == INT32_POS) continue;
    const int l = wlo[j], n = steps(l, whi[j], span);
    for (int d = 0; d < n; ++d) {
      int pos = l + d;
      if (pos >= 0 && pos < leaves)
        atomicMin(flat + pos, stamp | order_bits(v));
    }
  }
  FDB_MARK(1)
  grid.sync();
  FDB_MARK(2)
  if (gtid == 0 && s != 0) *stamp_word = s - 1;

  // -- 2. query: each read's min over its leaves, stale ones INT32_POS ---
  for (long long i = gtid; i < nr; i += gthreads) {
    int l = l0, h = h0;
    if (i != gtid) l = qlo[i], h = qhi[i];
    const int n = steps(l, h, span);
    int32_t acc = INT32_POS;
#pragma unroll 4  // a read's leaf loads issue together
    for (int d = 0; d < n; ++d) {
      unsigned long long x = __ldcg(flat + min(max(l + d, 0), leaves - 1));
      if (static_cast<uint32_t>(x >> 32) == s)
        acc = min(acc, from_order_bits(static_cast<uint32_t>(x)));
    }
    out[i] = acc;
  }
  FDB_MARK(3)

  // -- 3. the last stamp: every leaf and the stamp back to all ones ------
  if (s == 0) {
    grid.sync();
    FDB_MARK(4)
    for (long long p = gtid; p <= cap; p += gthreads) flat[p] = ~0ull;
    FDB_MARK(5)
  }
}

struct Plan {
  int blocks;  // at most one block per SM
  int err;     // a CUDA error from asking, 0 if none
};

// The grid's ceiling, asked once (a C++ static): one block per SM, the
// co-resident grid a cooperative launch needs.
const Plan& plan() {
  static const Plan p = [] {
    Plan r{0, 0};
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, apply_kernel, kApplyThreads, 0);
    r.err = static_cast<int>(e);
    r.blocks = per_sm > 0 ? sms : 0;
    if (r.err == 0 && r.blocks <= 0)
      r.err = static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    return r;
  }();
  return p;
}

int apply_blocks(int nw, int nr) {
  long long want = (static_cast<long long>(nw > nr ? nw : nr) +
                    kApplyThreads - 1) / kApplyThreads;
  if (want < 1) want = 1;
  return static_cast<int>(want < plan().blocks ? want : plan().blocks);
}

}  // namespace

extern "C" {

int ss_range(const void* values, int n, const void* lo, const void* hi, int q,
             int span, int op_min, void* out, void* stream) {
  if (q <= 0) return kNoLaunch;
  if (n <= 0 || span < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const int32_t*>(values);
  auto l = static_cast<const int32_t*>(lo);
  auto h = static_cast<const int32_t*>(hi);
  auto o = static_cast<int32_t*>(out);
  if (op_min)
    range_kernel<true><<<blocks_for(q), kThreads, 0, s>>>(v, n, l, h, q, span,
                                                           o);
  else
    range_kernel<false><<<blocks_for(q), kThreads, 0, s>>>(v, n, l, h, q,
                                                            span, o);
  return static_cast<int>(cudaGetLastError());
}

// flat: cap + 1 int64 words, all ones when new (cap >= leaves); the
// kernel keeps it between launches on one stream.
int ss_apply(const void* wlo, const void* whi, const void* val, int nw,
             const void* qlo, const void* qhi, int nr, int span, int leaves,
             void* flat, int cap, void* out, void* stream) {
  if (nr <= 0) return kNoLaunch;
  if (nw < 0 || span < 0 || leaves <= 0 || cap < leaves)
    return static_cast<int>(cudaErrorInvalidValue);
  if (plan().err) return plan().err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {&wlo, &whi, &val, &nw, &qlo, &qhi, &nr, &span, &leaves,
                  &flat, &cap, &out};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(apply_kernel), dim3(apply_blocks(nw, nr)),
      dim3(kApplyThreads), args, 0, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
