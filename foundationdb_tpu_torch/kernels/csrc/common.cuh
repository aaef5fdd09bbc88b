// Shared device helpers of the conflict kernels.
//
// Packed keys are rows of W uint32 words: big-endian byte words, then one
// length word. Row-major comparison word by word, as unsigned, is FDB's key
// order (byte-lexicographic, shorter first at equal prefixes); the all-ones
// row is the +inf sentinel. This is K1 (foundationdb_tpu/ops/keys.py:31,46
// lex_less / lex_eq), inlined into every kernel that compares keys rather
// than launched on its own. PyTorch holds the words as int32 bit patterns;
// the kernels read them as uint32, so 0xFFFFFFFF compares greatest.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fdb {

constexpr int32_t VERSION_NEG = -2147483647;  // -(2**31) + 1
constexpr int32_t INT32_POS = 2147483647;
constexpr int32_t INT32_NEG = -2147483647;
constexpr int kThreads = 256;
// What a C entry returns when its sizes leave it nothing to do and it
// launched nothing; the wrapper then counts no launch. Any other return
// is cudaGetLastError()'s code.
constexpr int kNoLaunch = -1;

__host__ __device__ inline int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

// a < b for W-word keys, a in registers, b in memory.
template <int W>
__device__ __forceinline__ bool less_rm(const uint32_t (&a)[W],
                                        const uint32_t* b) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint32_t bi = __ldg(b + i);
    if (a[i] != bi) return a[i] < bi;
  }
  return false;
}

// b < a for W-word keys, b in memory, a in registers.
template <int W>
__device__ __forceinline__ bool less_mr(const uint32_t* b,
                                        const uint32_t (&a)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint32_t bi = __ldg(b + i);
    if (bi != a[i]) return bi < a[i];
  }
  return false;
}

template <int W>
__device__ __forceinline__ void load_key(uint32_t (&k)[W], const uint32_t* p) {
#pragma unroll
  for (int i = 0; i < W; ++i) k[i] = __ldg(p + i);
}

// numpy.searchsorted over sorted rows keys[0..m): the first index whose
// row is >= q (left) or > q (right).
template <int W, bool RIGHT>
__device__ __forceinline__ int search(const uint32_t* keys, int m,
                                      const uint32_t (&q)[W]) {
  int lo = 0, hi = m;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    const uint32_t* row = keys + static_cast<size_t>(mid) * W;
    bool go_right = RIGHT ? !less_rm<W>(q, row) : less_mr<W>(row, q);
    if (go_right) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int floor_log2(int n) {  // n >= 1
  return 31 - __clz(n);
}

// Inclusive scan of v over the block's threads; *total gets the block sum.
// blockDim.x must be a multiple of 32 and at most 1024.
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int up = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += up;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int up = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += up;
    }
    if (lane < n_warps) warp_sums[lane] = s;  // inclusive warp prefixes
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums may be reused by the caller
  return v;
}

}  // namespace fdb

// Run the statement(s) for the runtime key width w (1..8, kernels.MAX_WORDS
// on the Python side), with the compile-time constant W bound to it.
#define FDB_DISPATCH_W(w, ...)                               \
  switch (w) {                                               \
    case 1: { constexpr int W = 1; __VA_ARGS__; } break;     \
    case 2: { constexpr int W = 2; __VA_ARGS__; } break;     \
    case 3: { constexpr int W = 3; __VA_ARGS__; } break;     \
    case 4: { constexpr int W = 4; __VA_ARGS__; } break;     \
    case 5: { constexpr int W = 5; __VA_ARGS__; } break;     \
    case 6: { constexpr int W = 6; __VA_ARGS__; } break;     \
    case 7: { constexpr int W = 7; __VA_ARGS__; } break;     \
    case 8: { constexpr int W = 8; __VA_ARGS__; } break;     \
    default: return cudaErrorInvalidValue;                   \
  }

// The same for a row width w of 1..16 words (kernels.MAX_ROW_WORDS: the
// read-dedup rows are a begin key then an end key, 2 x MAX_WORDS).
#define FDB_DISPATCH_ROW_W(w, ...)                           \
  switch (w) {                                               \
    case 9: { constexpr int W = 9; __VA_ARGS__; } break;     \
    case 10: { constexpr int W = 10; __VA_ARGS__; } break;   \
    case 11: { constexpr int W = 11; __VA_ARGS__; } break;   \
    case 12: { constexpr int W = 12; __VA_ARGS__; } break;   \
    case 13: { constexpr int W = 13; __VA_ARGS__; } break;   \
    case 14: { constexpr int W = 14; __VA_ARGS__; } break;   \
    case 15: { constexpr int W = 15; __VA_ARGS__; } break;   \
    case 16: { constexpr int W = 16; __VA_ARGS__; } break;   \
    default: FDB_DISPATCH_W(w, __VA_ARGS__);                 \
  }
