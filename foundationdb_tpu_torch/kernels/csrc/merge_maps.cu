// Kernel D: merge_maps — the pointwise max of two sorted piecewise-constant
// key -> version maps, with GC at a floor and canonical compaction.
//
// Replaces two JAX programs of foundationdb_tpu, which both fold one map
// into another:
//   K9     ops/delta.py:378 compact — main (+) delta at floor
//          max(main.oldest, delta.oldest);
//   K7(j)  ops/group.py:676-736, the merge phase of resolve_group — delta
//          (+) the batch's committed write coverage at its version.
//
// Map semantics: a map is rows (key, value) sorted by key (duplicate keys
// allowed; the last row of a key wins), the all-ones sentinel rows at the
// tail; the value in force at key k is the value of the last row with
// key <= k (search_right - 1), NEG before the first row. The result at k
// is max(A(k), B(k)), NEG where below the floor. A row survives iff it is
// the first row of its key in merge order (A rows before B rows at equal
// keys) and its value differs from the value in force just before its
// key. That is the canonical form both JAX programs produce, so the
// outputs match row for row.
//
// Two launches around a scan:
//   mm_mark     one thread per input row: its merge-path position (own
//               index + a search into the other list), its value and its
//               keep flag, keep_at[position] = keep;
//   (torch)     dest = exclusive cumsum of keep_at;
//   mm_scatter  one thread per input row: kept rows with dest < cap are
//               written to the output, in key order. Rows past cap are
//               dropped and the caller latches overflow (count > cap),
//               never a silent truncation.
//
// Bound on this card: four binary searches per row into two sorted lists
// that fit L2 (main + delta keys = 19 MB at bench shape), i.e. dependent
// load latency; the streams themselves are ~(na + nb) x (W + 4) x 4 B.

#include "common.cuh"

namespace {

using namespace fdb;

__device__ __forceinline__ int32_t gc(int32_t v, int32_t floor) {
  return v < floor ? VERSION_NEG : v;
}

template <int W>
__global__ void mark_kernel(const uint32_t* __restrict__ a_keys,
                            const int32_t* __restrict__ a_val, int na,
                            const uint32_t* __restrict__ b_keys,
                            const int32_t* __restrict__ b_val, int nb,
                            int32_t floor, int32_t* __restrict__ keep_at,
                            int32_t* __restrict__ row_pos,
                            int32_t* __restrict__ row_val) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= na + nb) return;
  bool own_a = r < na;
  int i = own_a ? r : r - na;
  uint32_t k[W];
  load_key<W>(k, (own_a ? a_keys : b_keys) + static_cast<size_t>(i) * W);
  int a_l = search<W, false>(a_keys, na, k);
  int a_r = search<W, true>(a_keys, na, k);
  int b_l = search<W, false>(b_keys, nb, k);
  int b_r = search<W, true>(b_keys, nb, k);
  int pos = own_a ? i + b_l : i + a_r;
  int32_t at = max(a_r > 0 ? __ldg(a_val + a_r - 1) : VERSION_NEG,
                   b_r > 0 ? __ldg(b_val + b_r - 1) : VERSION_NEG);
  int32_t before = max(a_l > 0 ? __ldg(a_val + a_l - 1) : VERSION_NEG,
                       b_l > 0 ? __ldg(b_val + b_l - 1) : VERSION_NEG);
  at = gc(at, floor);
  before = gc(before, floor);
  bool real = k[W - 1] != 0xFFFFFFFFu;
  bool first = own_a ? (i == a_l) : (i == b_l && a_l == a_r);
  keep_at[pos] = (real && first && at != before) ? 1 : 0;
  row_pos[r] = pos;
  row_val[r] = at;
}

template <int W>
__global__ void scatter_kernel(const uint32_t* __restrict__ a_keys,
                               const uint32_t* __restrict__ b_keys, int na,
                               int nb, const int32_t* __restrict__ row_pos,
                               const int32_t* __restrict__ row_val,
                               const int32_t* __restrict__ keep_at,
                               const int32_t* __restrict__ dest, int cap,
                               uint32_t* __restrict__ out_keys,
                               int32_t* __restrict__ out_val) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= na + nb) return;
  int pos = row_pos[r];
  if (!keep_at[pos]) return;
  int d = dest[pos];
  if (d >= cap) return;
  bool own_a = r < na;
  const uint32_t* src =
      (own_a ? a_keys : b_keys) + static_cast<size_t>(own_a ? r : r - na) * W;
  uint32_t* dst = out_keys + static_cast<size_t>(d) * W;
#pragma unroll
  for (int i = 0; i < W; ++i) dst[i] = src[i];
  out_val[d] = row_val[r];
}

}  // namespace

extern "C" {

int mm_mark(const void* a_keys, const void* a_val, int na, const void* b_keys,
            const void* b_val, int nb, int w, int floor, void* keep_at,
            void* row_pos, void* row_val, void* stream) {
  if (na + nb <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FDB_DISPATCH_W(w, mark_kernel<W><<<blocks_for(na + nb), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(a_keys), static_cast<const int32_t*>(a_val),
      na, static_cast<const uint32_t*>(b_keys),
      static_cast<const int32_t*>(b_val), nb, floor,
      static_cast<int32_t*>(keep_at), static_cast<int32_t*>(row_pos),
      static_cast<int32_t*>(row_val)));
  return static_cast<int>(cudaGetLastError());
}

int mm_scatter(const void* a_keys, const void* b_keys, int na, int nb, int w,
               const void* row_pos, const void* row_val, const void* keep_at,
               const void* dest, int cap, void* out_keys, void* out_val,
               void* stream) {
  if (na + nb <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FDB_DISPATCH_W(w, scatter_kernel<W><<<blocks_for(na + nb), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(a_keys),
      static_cast<const uint32_t*>(b_keys), na, nb,
      static_cast<const int32_t*>(row_pos),
      static_cast<const int32_t*>(row_val),
      static_cast<const int32_t*>(keep_at), static_cast<const int32_t*>(dest),
      cap, static_cast<uint32_t*>(out_keys), static_cast<int32_t*>(out_val)));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
