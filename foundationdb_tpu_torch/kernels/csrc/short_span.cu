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
//             in for the tier's max table and probe (phase b), the min
//             table and query of the fixpoint (phase e) and the cross
//             phase's two-level table (G > 1);
//   ss_cover  the fixpoint's writer cover (:511-519): for every write j and
//             each d < S with lo_j + d < hi_j, atomicMin(flat[lo_j + d],
//             val_j), over a buffer the caller filled with INT32_POS.
// Both are exact when no live range spans more than S positions; the
// caller latches every span (overflow) as the JAX program does, so a wider
// range is refused, never answered from a truncated read.
//
// Bound on this card: bytes. ss_range reads lo, hi and writes out (12 B a
// query) plus the values it covers (4 B each, at most S a query); ss_cover
// reads lo, hi, val (12 B a write) and updates each covered position once.
// At the uniform batch's shapes (65,536 point reads and writes, spans of
// one or two ranks) that is under 2 MB a launch: the floor is a fraction
// of a microsecond and the time is launch latency. Design: the simplest
// form that is right — one thread per query or write, a loop of at most S
// steps that stops at hi, native 32-bit atomicMin (an uncommitted writer,
// INT32_POS, skips its atomics: a min with +inf changes nothing).

#include "common.cuh"

namespace {

using namespace fdb;

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

__global__ void cover_kernel(const int32_t* __restrict__ lo,
                             const int32_t* __restrict__ hi,
                             const int32_t* __restrict__ val, int nw,
                             int span, int32_t* __restrict__ flat,
                             int n_flat) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nw) return;
  int32_t v = val[j];
  if (v == INT32_POS) return;
  int l = lo[j];
  int h = hi[j];
  for (int d = 0; d < span; ++d) {
    int pos = l + d;
    if (pos >= h) break;
    if (pos >= 0 && pos < n_flat) atomicMin(flat + pos, v);
  }
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

int ss_cover(const void* lo, const void* hi, const void* val, int nw,
             int span, void* flat, int n_flat, void* stream) {
  if (nw <= 0) return kNoLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cover_kernel<<<blocks_for(nw), kThreads, 0, s>>>(
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
      static_cast<const int32_t*>(val), nw, span,
      static_cast<int32_t*>(flat), n_flat);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
