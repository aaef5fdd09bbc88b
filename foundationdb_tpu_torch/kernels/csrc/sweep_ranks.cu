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
//       were dear on the TPU; here each thread does the two searches.
//       Dead reads get (-1, -1): an empty range in the probe's table
//       query (JAX leaves them arbitrary; every caller masks them).
//
// Bound on this card: the group's read ends (2 x G*NR rows of W words),
// the liveness bytes and the two int32 outputs stream once; the searches
// read ~2*log2(M) rows each from a main tier that fits the 50 MB L2
// (786,432 x 3 words = 9.4 MB at bench shape), so the floor is the
// bytes in and out plus one pass over main, and the cost is the
// dependent-load latency of the searches. Design: one thread per read,
// keys in registers, the compare of common.cuh; G*NR threads hide the
// latency.

#include "common.cuh"

namespace {

using namespace fdb;

template <int W>
__global__ void sweep_kernel(const uint32_t* __restrict__ keys, int m,
                             const uint32_t* __restrict__ rb,
                             const uint32_t* __restrict__ re,
                             const uint8_t* __restrict__ rvalid, int r,
                             int32_t* __restrict__ il,
                             int32_t* __restrict__ ir) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;
  if (!rvalid[i]) {
    il[i] = -1;
    ir[i] = -1;
    return;
  }
  uint32_t k[W];
  load_key<W>(k, rb + static_cast<size_t>(i) * W);
  il[i] = search<W, true>(keys, m, k) - 1;
  load_key<W>(k, re + static_cast<size_t>(i) * W);
  ir[i] = search<W, false>(keys, m, k) - 1;
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
  FDB_DISPATCH_W(w, sweep_kernel<W><<<blocks_for(r), kThreads, 0, s>>>(
      k, m, b, e, v, r, l, h));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
