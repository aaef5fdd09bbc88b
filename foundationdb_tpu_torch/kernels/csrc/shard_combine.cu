// Kernel J: shard_combine — the S shards' results of a group combined
// into the group's verdicts, in one launch.
//
// Replaces (JAX/XLA programs of foundationdb_tpu):
//   K18 parallel/sharding.py:276 (_shard_resolve_group_tiered's combine),
//       :115 and :157 (the classic bodies' combine) and :449
//       (collective_probe_jit, the combine alone): on the TPU a round of
//       collectives over the resolver mesh axis —
//         verdict            pmin over shards (the reference's min(),
//                            CommitProxyServer.actor.cpp:1559-1565);
//         hist_conflict_read psum > 0 (an OR);
//         intra_first_range  pmin over the non-negative values, else -1;
//         overflow           pmax (any shard);
//         latch trip         pmax (any shard refuses the whole group);
//       and the three per-batch counts from the COMBINED verdict and
//       txn_valid (a shard's own count would count its phantom commits).
//       On one card the shard axis is the leading axis of the inputs
//       (the S shards' GroupVerdicts of ops/delta.py:310 or
//       ops/group.py:132, stacked), so the collectives become a reduction
//       over it.
//
// Bound on this card: bytes. The S shards' verdicts and first indices
// ([S, G, B] int32 each) and read hits ([S, G, NR] bytes) are read once,
// the combined [G, B] / [G, NR] written once: ~24 MB at a group of 8
// bench batches on 4 shards. Design: one thread per (batch, row), rows
// padded to a multiple of 32 so a warp never spans two batches; the S
// values of its row reduced in registers; the counts by a warp ballot,
// a sum over the block's warps in shared memory and one integer
// atomicAdd per block, batch and count into a buffer the launch zeroes
// first (integer sums: exact, whatever the order). The first version
// added one atomic per warp (2,048 on each of a group's 24 counters) and
// took 30.2 us at this shape on an H100 80GB HBM3 at 700 W; this one
// 9.2 us.

#include "common.cuh"

namespace {

using namespace fdb;

constexpr int32_t kConflict = 0;
constexpr int32_t kTooOld = 1;
constexpr int32_t kCommitted = 3;
constexpr int kWarps = kThreads / 32;

__global__ void combine_kernel(const int32_t* __restrict__ verdict,
                               const int32_t* __restrict__ first,
                               const uint8_t* __restrict__ hist,
                               const uint8_t* __restrict__ overflow,
                               const uint8_t* __restrict__ trip,
                               const uint8_t* __restrict__ txn_valid,
                               int n_shards, int gn, int b, int nr, int row,
                               int32_t* __restrict__ out_verdict,
                               int32_t* __restrict__ out_first,
                               uint8_t* __restrict__ out_hist,
                               uint8_t* __restrict__ out_overflow,
                               uint8_t* __restrict__ trip_any,
                               int32_t* __restrict__ counts) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long total = static_cast<long long>(gn) * row;
  bool in = i < total;
  int g = in ? static_cast<int>(i / row) : 0;
  int j = in ? static_cast<int>(i % row) : 0;
  bool committed = false, conflict = false, too_old = false;
  if (in && j < b) {
    long long at = static_cast<long long>(g) * b + j;
    long long stride = static_cast<long long>(gn) * b;
    int32_t v = INT32_POS, f = INT32_POS;
    for (int s = 0; s < n_shards; ++s) {
      int32_t vs = verdict[s * stride + at];
      int32_t fs = first[s * stride + at];
      v = min(v, vs);
      f = min(f, fs < 0 ? INT32_POS : fs);
    }
    out_verdict[at] = v;
    out_first[at] = f == INT32_POS ? -1 : f;
    bool valid = txn_valid[at] != 0;
    committed = valid && v == kCommitted;
    conflict = valid && v == kConflict;
    too_old = valid && v == kTooOld;
  }
  if (in && j < nr) {
    long long at = static_cast<long long>(g) * nr + j;
    long long stride = static_cast<long long>(gn) * nr;
    uint8_t h = 0;
    for (int s = 0; s < n_shards; ++s) h |= hist[s * stride + at];
    out_hist[at] = h ? 1 : 0;
  }
  if (in && j == 0) {
    uint8_t o = 0;
    for (int s = 0; s < n_shards; ++s) o |= overflow[s * gn + g];
    out_overflow[g] = o ? 1 : 0;
    if (g == 0) {
      uint8_t t = 0;
      for (int s = 0; s < n_shards; ++s) t |= trip[s];
      *trip_any = t ? 1 : 0;
    }
  }
  // every thread of the block reaches the ballots and the barrier (no
  // early return above); `row` is a multiple of 32, so a warp's rows
  // share one batch g
  __shared__ int warp_count[3][kWarps];
  __shared__ int warp_g[kWarps];
  int warp = threadIdx.x >> 5;
  unsigned c0 = __popc(__ballot_sync(0xffffffffu, committed));
  unsigned c1 = __popc(__ballot_sync(0xffffffffu, conflict));
  unsigned c2 = __popc(__ballot_sync(0xffffffffu, too_old));
  if ((threadIdx.x & 31) == 0) {
    warp_count[0][warp] = static_cast<int>(c0);
    warp_count[1][warp] = static_cast<int>(c1);
    warp_count[2][warp] = static_cast<int>(c2);
    warp_g[warp] = in ? g : -1;
  }
  __syncthreads();
  // one thread per count sums the block's warps batch by batch (a block
  // spans at most a few batches) and adds each sum with one atomic
  if (threadIdx.x < 3) {
    int k = threadIdx.x, sum = 0, at = warp_g[0];
    for (int w = 0; w < kWarps; ++w) {
      if (warp_g[w] != at) {
        if (at >= 0 && sum) atomicAdd(counts + k * gn + at, sum);
        at = warp_g[w];
        sum = 0;
      }
      sum += warp_count[k][w];
    }
    if (at >= 0 && sum) atomicAdd(counts + k * gn + at, sum);
  }
}

}  // namespace

extern "C" {

// verdict, first [S, G, B] int32; hist [S, G, NR], overflow [S, G],
// trip [S], txn_valid [G, B] bytes; outputs out_verdict, out_first [G, B]
// int32, out_hist [G, NR], out_overflow [G], trip_any [] bytes, counts
// [3, G] int32 (committed, conflict, too old).
int sc_combine(const void* verdict, const void* first, const void* hist,
               const void* overflow, const void* trip, const void* txn_valid,
               int n_shards, int gn, int b, int nr, void* out_verdict,
               void* out_first, void* out_hist, void* out_overflow,
               void* trip_any, void* counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_shards <= 0 || gn <= 0 || b <= 0 || nr <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * 3 * gn, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int row = ((b > nr ? b : nr) + 31) / 32 * 32;
  long long total = static_cast<long long>(gn) * row;
  combine_kernel<<<blocks_for(total), kThreads, 0, st>>>(
      static_cast<const int32_t*>(verdict), static_cast<const int32_t*>(first),
      static_cast<const uint8_t*>(hist), static_cast<const uint8_t*>(overflow),
      static_cast<const uint8_t*>(trip),
      static_cast<const uint8_t*>(txn_valid), n_shards, gn, b, nr, row,
      static_cast<int32_t*>(out_verdict), static_cast<int32_t*>(out_first),
      static_cast<uint8_t*>(out_hist), static_cast<uint8_t*>(out_overflow),
      static_cast<uint8_t*>(trip_any), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
