// Kernel I: shard_clip — every read and write range of a group clipped to
// all S shard partitions, in one launch.
//
// Replaces (JAX/XLA programs of foundationdb_tpu):
//   K18 parallel/sharding.py:82 clip_batch, vmapped over the G batches of
//       a group inside each shard's shard_map body (:276, :115, :157):
//       every range becomes [max(b, lo), min(e, hi)) under the key order
//       (lex_max / lex_min, :73, :78), valid only if it was valid and
//       b < e after the clip; rows keep their index (nothing compacts, so
//       read i is the same read on every shard); has_reads is recomputed
//       by a scatter-max of the surviving reads onto their txns, the dead
//       rows going to a trash slot. On the TPU each device clipped the
//       replicated batch to its own partition; on one card the shard axis
//       is the leading axis of the outputs, [S, G, N, W] keys and
//       [S, G, N] valid flags, [S, G, B] has_reads, and each shard then
//       runs its own tiered loop (ops/delta.py:310) or classic group
//       kernel (ops/group.py:132) on its contiguous [G, ...] slice.
//
// Bound on this card: bytes. Each range is read once (2 keys of W words,
// a valid byte, the read's txn) and written S times; at a group of 8
// bench batches (65,536 reads and writes each, W = 3) on 4 shards that
// is ~28 MB in and ~107 MB out. Design: one thread per (batch, row) of
// the reads and then the writes, its two keys in registers, the S
// partitions' bounds read through the read-only cache (they are S x 2W
// words); for each shard it writes its clipped copy, so consecutive
// threads write consecutive rows of every output. has_reads is zeroed
// by the launch and then set by byte stores of 1 from every surviving
// read of a txn: an OR whose stores all write the same value, so the
// result does not depend on their order and needs no atomics. Dead and
// padding reads (read_txn == B) never store.

#include "common.cuh"

namespace {

using namespace fdb;

// a < b, both in registers
template <int W>
__device__ __forceinline__ bool less_rr(const uint32_t (&a)[W],
                                        const uint32_t (&b)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if (a[i] != b[i]) return a[i] < b[i];
  }
  return false;
}

template <int W>
__device__ __forceinline__ void store_key(uint32_t* p,
                                          const uint32_t (&k)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) p[i] = k[i];
}

template <int W>
__global__ void clip_kernel(const uint32_t* __restrict__ lo,
                            const uint32_t* __restrict__ hi, int n_shards,
                            const uint32_t* __restrict__ rb,
                            const uint32_t* __restrict__ re,
                            const uint8_t* __restrict__ rv,
                            const int32_t* __restrict__ rtxn,
                            long long n_reads, int nr,
                            const uint32_t* __restrict__ wb,
                            const uint32_t* __restrict__ we,
                            const uint8_t* __restrict__ wv,
                            long long n_writes, int b, int gn,
                            uint32_t* __restrict__ orb,
                            uint32_t* __restrict__ ore,
                            uint8_t* __restrict__ orv,
                            uint32_t* __restrict__ owb,
                            uint32_t* __restrict__ owe,
                            uint8_t* __restrict__ owv,
                            uint8_t* __restrict__ has_reads) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool is_read = i < n_reads;
  long long row = is_read ? i : i - n_reads;
  long long n = is_read ? n_reads : n_writes;
  if (row >= n) return;
  const uint32_t* kb = is_read ? rb : wb;
  const uint32_t* ke = is_read ? re : we;
  uint32_t bk[W], ek[W], l[W], h[W], cb[W], ce[W];
  load_key<W>(bk, kb + row * W);
  load_key<W>(ek, ke + row * W);
  bool valid = (is_read ? rv : wv)[row] != 0;
  int txn = is_read ? rtxn[row] : -1;
  long long g = row / nr;
  uint32_t* ob = is_read ? orb : owb;
  uint32_t* oe = is_read ? ore : owe;
  uint8_t* ov = is_read ? orv : owv;
  for (int s = 0; s < n_shards; ++s) {
    load_key<W>(l, lo + static_cast<size_t>(s) * W);
    load_key<W>(h, hi + static_cast<size_t>(s) * W);
    // lex_max(b, lo) and lex_min(e, hi), as the JAX where()s pick them
    bool take_lo = less_rr<W>(bk, l);
    bool take_e = less_rr<W>(ek, h);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      cb[k] = take_lo ? l[k] : bk[k];
      ce[k] = take_e ? ek[k] : h[k];
    }
    bool v = valid && less_rr<W>(cb, ce);
    long long out = static_cast<long long>(s) * n + row;
    store_key<W>(ob + out * W, cb);
    store_key<W>(oe + out * W, ce);
    ov[out] = v ? 1 : 0;
    if (is_read && v && txn >= 0 && txn < b) {
      has_reads[(static_cast<long long>(s) * gn + g) * b + txn] = 1;
    }
  }
}

}  // namespace

extern "C" {

// lo, hi [S, W]; rb, re [G*NR, W], rv [G*NR], rtxn [G*NR]; wb, we
// [G*NW, W], wv [G*NW]; outputs orb, ore [S, G*NR, W], orv [S, G*NR],
// owb, owe [S, G*NW, W], owv [S, G*NW], has_reads [S, G, B].
int sc_clip(const void* lo, const void* hi, int n_shards, int w,
            const void* rb, const void* re, const void* rv, const void* rtxn,
            int gn, int nr, const void* wb, const void* we, const void* wv,
            int nw, int b, void* orb, void* ore, void* orv, void* owb,
            void* owe, void* owv, void* has_reads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_shards <= 0 || gn <= 0 || nr <= 0 || nw <= 0 || b <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long n_reads = static_cast<long long>(gn) * nr;
  long long n_writes = static_cast<long long>(gn) * nw;
  cudaError_t err = cudaMemsetAsync(
      has_reads, 0, static_cast<size_t>(n_shards) * gn * b, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto l = static_cast<const uint32_t*>(lo);
  auto h = static_cast<const uint32_t*>(hi);
  auto r0 = static_cast<const uint32_t*>(rb);
  auto r1 = static_cast<const uint32_t*>(re);
  auto r2 = static_cast<const uint8_t*>(rv);
  auto r3 = static_cast<const int32_t*>(rtxn);
  auto w0 = static_cast<const uint32_t*>(wb);
  auto w1 = static_cast<const uint32_t*>(we);
  auto w2 = static_cast<const uint8_t*>(wv);
  auto o0 = static_cast<uint32_t*>(orb);
  auto o1 = static_cast<uint32_t*>(ore);
  auto o2 = static_cast<uint8_t*>(orv);
  auto o3 = static_cast<uint32_t*>(owb);
  auto o4 = static_cast<uint32_t*>(owe);
  auto o5 = static_cast<uint8_t*>(owv);
  auto hr = static_cast<uint8_t*>(has_reads);
  FDB_DISPATCH_W(w, clip_kernel<W><<<blocks_for(n_reads + n_writes),
                                     kThreads, 0, st>>>(
      l, h, n_shards, r0, r1, r2, r3, n_reads, nr, w0, w1, w2, n_writes, b,
      gn, o0, o1, o2, o3, o4, o5, hr));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
