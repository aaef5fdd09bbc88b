// Kernel E: sweep_ranks — the main-tier ranks of every read of a group,
// both ends, in one launch.
//
// Replaces (JAX/XLA programs of foundationdb_tpu):
//   K11 ops/delta.py:172 sweep_read_ranks (and :283 attach_sweep_ranks):
//       one co-sort of the main boundaries with every read endpoint of
//       the group, tie order re < main < rb, and a running main-row count
//       read back through an inverse sort. For a live read that gives
//       il = searchsorted_right(main, rb) - 1 and
//       ir = searchsorted_left(main, re) - 1 on the full key (data words
//       and length word). The co-sort existed because per-read searches
//       were dear on the TPU; here each thread finds both ends. Dead
//       reads get (-1, -1): an empty range in the probe's table query
//       (JAX leaves them arbitrary; every caller masks them).
//
// Bound on this card: the group's read ends (2 x G*NR rows of W words),
// the liveness bytes and the two int32 outputs stream once, beside the
// key rows that decide the reads' ends; the tier (786,432 x 3 words =
// 9.4 MB at bench shape) fits the 50 MB L2, so the searches' passes, not
// bytes, set the time. The first design (one thread a read, two full
// binary searches of ~20 steps, each step's W word loads one after
// another) took 40.1 us at a YCSB-E group's 524,288 reads (an H100,
// chip_smoke.py). Design: the probe's first half, tier_ends of
// tier_search.cuh, as one fenced kernel: the fence staged once a block
// by cp.async, a block of kFenceThreads threads per 512 reads up to two
// an SM striding over the rest, the begin's right search by the fence
// and its bucket, the end from the begin by a gallop and the window (a
// YCSB-E scan of 1-100 keys mostly ends in the window or its bucket).

#include "common.cuh"
#include "tier_search.cuh"

namespace {

using namespace fdb;

template <int W>
__global__ void __launch_bounds__(kFenceThreads)
    sweep_kernel(const uint32_t* __restrict__ keys, int m,
                 const uint32_t* __restrict__ rb,
                 const uint32_t* __restrict__ re,
                 const uint8_t* __restrict__ rvalid, int r,
                 int32_t* __restrict__ il, int32_t* __restrict__ ir,
                 int shift, int nf) {
  extern __shared__ uint32_t fence[];
  FDB_MARK(0)
  stage_fence<W>(fence, keys, shift, nf);
  FDB_MARK(1)
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < r;
       i += gridDim.x * blockDim.x) {
    if (!rvalid[i]) {
      il[i] = -1;
      ir[i] = -1;
      continue;
    }
    uint32_t kb[W], ke[W];
    ld_row<W>(kb, rb + static_cast<size_t>(i) * W);
    ld_row<W>(ke, re + static_cast<size_t>(i) * W);
    int first, p;
    tier_ends<W>(keys, m, fence, nf, shift, kb, ke, first, p);
    il[i] = first - 1;
    ir[i] = p - 1;
    FDB_MARK(5)
  }
}

}  // namespace

extern "C" {

int sw_ranks(const void* keys, int m, int w, const void* rb, const void* re,
             const void* rvalid, int r, void* il, void* ir, void* stream) {
  if (r <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto k = static_cast<const uint32_t*>(keys);
  auto b = static_cast<const uint32_t*>(rb);
  auto e = static_cast<const uint32_t*>(re);
  auto v = static_cast<const uint8_t*>(rvalid);
  auto l = static_cast<int32_t*>(il);
  auto h = static_cast<int32_t*>(ir);
  const Fence f = fence_of(m, w);
  FDB_DISPATCH_W(w, sweep_kernel<W><<<fence_blocks(r), kFenceThreads, f.smem,
                                      s>>>(k, m, b, e, v, r, l, h, f.shift,
                                           f.nf));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
