// Kernel B: rangemax_build — one level of the sparse doubling table.
//
// Replaces K3's build, foundationdb_tpu/ops/rangemax.py:30:
//   t[0]    = values
//   t[k][i] = op(t[k-1][i], t[k-1][min(i + half, m - 1)]),
//   half    = min(2^(k-1), m - 1),
// i.e. op over values[i : i + 2^k] clamped at the array end, for k in
// 1 .. L-1 with L = bit_length(m-1) + 1; op is max (history versions) or
// min (the fixpoint's writer cover).
//
// Bound on this card: bytes. Each level reads one level (two coalesced
// streams of the same row, the second shifted) and writes the next:
// 2 x 4 B x m per level, about L x 8 B x m for the table (21 levels x
// 786,432 rows = 132 MB at bench shape). Design: one launch per level,
// one thread per element, fully coalesced; level k-1 is still hot in
// L2 when level k reads it.

#include "common.cuh"

namespace {

using namespace fdb;

template <bool MIN>
__global__ void level_kernel(const int32_t* __restrict__ values,
                             int32_t* __restrict__ table, int m, int level,
                             int half) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  if (level == 0) {
    table[i] = values[i];
    return;
  }
  const int32_t* prev = table + static_cast<size_t>(level - 1) * m;
  int32_t a = prev[i];
  int32_t b = prev[min(i + half, m - 1)];
  table[static_cast<size_t>(level) * m + i] = MIN ? min(a, b) : max(a, b);
}

}  // namespace

extern "C" {

int rm_build_level(const void* values, void* table, int m, int level,
                   int half, int op_min, void* stream) {
  if (m <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const int32_t*>(values);
  auto t = static_cast<int32_t*>(table);
  if (op_min)
    level_kernel<true><<<blocks_for(m), kThreads, 0, s>>>(v, t, m, level, half);
  else
    level_kernel<false><<<blocks_for(m), kThreads, 0, s>>>(v, t, m, level, half);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
