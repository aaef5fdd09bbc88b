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
// A third entry serves K16, foundationdb_tpu/ops/history.py:114
// merge_writes, which overwrites the union of sorted disjoint run
// intervals (b0, e0, b1, e1, ...) with the batch version. Its JAX program
// keeps rows, not keys: it sorts the tier's rows and the run bounds
// together (a tier row before a run bound at equal keys, each list in its
// own order), gives each row the tier value in force there (the last tier
// row at or before it), raised to max(value, version) where the row lies
// inside a run (a run bound of even ordinal, or a tier row after an odd
// number of bounds), NEG under the floor, and keeps a real row whose value
// differs from the row just before it in that order. A run begin equal to
// a tier key so keeps two rows of one key, which the canonical merge above
// would fold into one; so the rows are marked by these rules:
//   mm_mark_runs  one thread per row: its position (own index + a search
//               into the other list), its value, and the value of the row
//               just before it, found with one more search (the previous
//               row is the other list's last row before this one when a row
//               of that list lies between this row and its own list's
//               predecessor); keep_at[position] = keep;
// then the same scan and mm_scatter compact the kept rows.
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

// K16's row marks (see the header). a = the tier (na rows), b = the run
// bounds (nb rows, sorted, begin/end alternating, sentinel tail).
template <int W>
__global__ void mark_runs_kernel(const uint32_t* __restrict__ a_keys,
                                 const int32_t* __restrict__ a_val, int na,
                                 const uint32_t* __restrict__ b_keys, int nb,
                                 int32_t version, int32_t floor,
                                 int32_t* __restrict__ keep_at,
                                 int32_t* __restrict__ row_pos,
                                 int32_t* __restrict__ row_val) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= na + nb) return;
  bool own_a = r < na;
  int i = own_a ? r : r - na;
  uint32_t k[W];
  load_key<W>(k, (own_a ? a_keys : b_keys) + static_cast<size_t>(i) * W);
  // the value a tier row takes (inside a run: raised to the version)
  auto tier_val = [&](int row, bool covered) {
    int32_t v = __ldg(a_val + row);
    return gc(covered ? max(v, version) : v, floor);
  };
  // the value a run bound of ordinal j takes over the tier value `carry`
  auto run_val = [&](int j, int32_t carry) {
    return gc((j & 1) == 0 ? max(carry, version) : carry, floor);
  };
  int pos;
  int32_t val;
  int32_t prev = VERSION_NEG;
  uint32_t kp[W];
  if (own_a) {
    int bl = search<W, false>(b_keys, nb, k);  // bounds before this row
    pos = i + bl;
    val = tier_val(i, bl & 1);
    int bl_prev = 0;
    if (i > 0) {
      load_key<W>(kp, a_keys + static_cast<size_t>(i - 1) * W);
      bl_prev = search<W, false>(b_keys, nb, kp);
    }
    if (bl > bl_prev)  // bound bl - 1 lies between tier rows i-1 and i
      prev = run_val(bl - 1, i > 0 ? __ldg(a_val + i - 1) : VERSION_NEG);
    else if (i > 0)
      prev = tier_val(i - 1, bl & 1);
  } else {
    int ar = search<W, true>(a_keys, na, k);  // tier rows before this row
    pos = i + ar;
    int32_t carry = ar > 0 ? __ldg(a_val + ar - 1) : VERSION_NEG;
    val = run_val(i, carry);
    int ar_prev = 0;
    if (i > 0) {
      load_key<W>(kp, b_keys + static_cast<size_t>(i - 1) * W);
      ar_prev = search<W, true>(a_keys, na, kp);
    }
    if (ar > ar_prev)  // tier row ar - 1 lies between bounds i-1 and i,
      prev = tier_val(ar - 1, i & 1);  // after exactly i bounds
    else if (i > 0)
      prev = run_val(i - 1, carry);
  }
  bool real = k[W - 1] != 0xFFFFFFFFu;
  keep_at[pos] = (real && val != prev) ? 1 : 0;
  row_pos[r] = pos;
  row_val[r] = val;
}

}  // namespace

extern "C" {

int mm_mark(const void* a_keys, const void* a_val, int na, const void* b_keys,
            const void* b_val, int nb, int w, int floor, void* keep_at,
            void* row_pos, void* row_val, void* stream) {
  if (na + nb <= 0) return kNoLaunch;
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
  if (na + nb <= 0) return kNoLaunch;
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

int mm_mark_runs(const void* a_keys, const void* a_val, int na,
                 const void* b_keys, int nb, int w, int version, int floor,
                 void* keep_at, void* row_pos, void* row_val, void* stream) {
  if (na + nb <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FDB_DISPATCH_W(w, mark_runs_kernel<W><<<blocks_for(na + nb), kThreads, 0,
                                          s>>>(
      static_cast<const uint32_t*>(a_keys), static_cast<const int32_t*>(a_val),
      na, static_cast<const uint32_t*>(b_keys), nb, version, floor,
      static_cast<int32_t*>(keep_at), static_cast<int32_t*>(row_pos),
      static_cast<int32_t*>(row_val)));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
