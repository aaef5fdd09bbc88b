"""Per-phase times of the port's cooperative kernels on the card.

    python -m foundationdb_tpu_torch.kernels.phase_trace \
        [--kernel lex_order|rangemax_build|min_cover|merge_maps|
                  keysearch_probe|keysearch_search|keysearch_query|
                  sweep_ranks|rangemax2_build|rangemax2_query|seg_fold|
                  short_span|merge_writes|rangemax4_build|min_cover4|
                  rangemax4_query]
        [--direct-scatter] [--items N] [--threads N] [--fence-kb N]

Builds a copy of the kernel's source with a `%globaltimer` mark at every
grid sync (each block's arrival, the latest kept; block 0's departure),
runs it on seeded inputs at the port's shapes, holds its output to the
plain version, and prints per call: each phase's work (the latest arrival
less the previous departure) and each sync's cost (block 0's departure
less the latest arrival), in microseconds.

- lex_order (kernel N, the default): a uniform batch's 262,144 x 3
  endpoint rows, a zipf batch's 65,536 x 6 read-dedup rows, a classic
  group of 8's 2,097,152 x 3 rows, one row. `--direct-scatter` writes
  each row of a pass from the registers straight to its place instead of
  staging the tile in shared memory: the design the staged scatter
  replaced.
- rangemax_build (kernel B): a tier's 786,432 rows (max) and the
  fixpoint's 2^18 leaves (min).
- min_cover (kernel C): 65,536 intervals over 2^18 leaves, mostly short
  as a uniform batch's writes, and the same with intervals of every
  level.
- merge_maps (kernel D, no grid sync: its tiles go by ticket): a
  `%globaltimer` mark at each phase of every tile and at every block's
  end, printed as each phase's mean and largest time over the tiles
  (split, stage, merge, scan, look-back wait, write, tail share), the
  last ticket's and the last tile's time from the first ticket, and the
  kernel's end; at the compaction's 786,432 + 786,432 rows and the batch
  merge's 786,432 + 131,072. `--items` and `--threads` rebuild it with
  another tile shape (merged positions a thread, threads a block; the
  small tile is half the large one): the sweep that chose the shipped
  8 x 256, which PERF.md's kernel D findings cite.
- merge_writes (K16, kernel D's row-keeping mode `mm_merge_writes`):
  merge_maps's marks and print, at the reference's 655,360 live tier
  rows of 786,432 and 131,072 run bounds (an eighth on tier keys);
  `--items` / `--threads` as for merge_maps.
- rangemax4_build (kernel M's build, B's kernel at radix 4, `rm4_build`):
  262,144 leaves, max and min.
- min_cover4 (kernel M's cover, C's kernel at radix 4, `mc_cover4`):
  65,536 intervals of 1-63 leaves over 2^18 leaves (the reference
  script's shape), and the same with intervals of every level.
- rangemax4_query (kernel M's query, no grid sync): a mark by every
  warp's lane 0 (start, its queries' ends loaded, its gathers arrived),
  for 65,536 queries of 1-63 leaves over the radix-4 max table of 2^18
  leaves (the reference script's shape).
- keysearch_probe (kernel A's probe, no grid sync): a `%globaltimer` mark
  by every warp's lane 0 at each phase of its reads (the `FDB_MARK`
  hooks of keysearch.cu), printed as each phase's mean and largest time
  over the warps (fence stage, shared-memory levels, global levels,
  window and fall-back, table gather) and the kernel's span; at a
  786,432-row tier with 65,536 long reads (phase 2's) and 65,536 of the
  uniform stream's point reads. `--fence-kb` rebuilds it with another
  kFenceBytes fence (the fence sweep PERF.md cites).
- keysearch_search (kernel A's search, no grid sync): a mark by every
  warp's lane 0 at each phase of its last query (the `FDB_MARK` hooks
  of keysearch.cu and tier_search.cuh), printed as the probe's are
  (fence stage, shared-memory levels, global levels, for both sides the
  window and the search past it, the write); at a 786,432-row tier of
  1M keys, left, right and both sides of a group of 8's 524,288 point
  read begins, and both sides of 2,097,152 distinct point keys, half
  the sentinel (the short-span classic path's searches).
- sweep_ranks (kernel E, no grid sync): the same marks over its reads
  (fence stage, shared-memory levels and global levels of the begin's
  search, the end by the gallop and window or its bucket, the write),
  at a group of 8 YCSB-E-like scans (524,288 reads of 1-100 keys, a
  twentieth dead) over a 786,432-row tier of 1M keys.
- keysearch_query (kernel A's query, no grid sync): a mark by every
  warp's lane 0 (both ends loaded, the short path's two lookups, the
  warp's long queries), over the fixpoint's min table of 2^18 leaves at
  FIXPOINT_LEVELS and at every level, for 65,536 reads of a uniform
  batch's local spans (1-2), a YCSB-E batch's (1-101) and spans up to
  the whole leaf range (the long path).
- rangemax2_build (kernel G's build, no grid sync): thread 0's marks in
  every block (its superchunks, its fence and ticket) and in the last
  block (the read of level 0, the levels), over a classic group of 8's
  2,097,152 ranks.
- rangemax2_query (kernel G's query, no grid sync): a mark by every
  warp's lane 0 (both ends, a short range's own rows, the warp's wide
  queries by teams), at batch 1's reads of a classic group of 8 uniform
  batches at their own group ranks and at chip_smoke.py's synthetic mix.
- seg_fold (kernel H, one grid sync): a mark by every block at each phase
  (after the block's threads meet there), printed the same way (survey,
  grid sync, paint, wide writes' share, the count where it runs, the
  last block's reset); over a classic group of 8's 2,097,152 ranks with
  65,536 point writes, the same with one write over the whole space,
  and the same with one inverted committed write (the count).
- short_span (kernel K's ss_apply, one grid sync): a mark by every block
  at each phase, printed the same way (cover, grid sync, query, and at
  the last stamp the second grid sync and the reset of every leaf), for
  a launch at an ordinary stamp and one at the last stamp, on a uniform
  batch's fixpoint (65,536 writes and reads in local ranks over 2^18
  leaves, S = 4); `--threads` rebuilds it with another block size.

A measuring tool: nothing on the resolver path imports it.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from foundationdb_tpu_torch import kernels
from foundationdb_tpu_torch.ops import delta as D
from foundationdb_tpu_torch.ops import group as G
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.ops import keys as K
from foundationdb_tpu_torch.ops import rangemax as R
from foundationdb_tpu_torch.ops import segtree as S

_MARKS = r'''
__device__ unsigned long long g_arrive[64];
__device__ unsigned long long g_depart[64];
__device__ unsigned long long g_begin;
__device__ unsigned long long g_end;
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void arrive(int s) {
  __syncthreads();
  if (threadIdx.x == 0) atomicMax(&g_arrive[s], now_ns());
}
__device__ __forceinline__ void depart(int s) {
  if (blockIdx.x == 0 && threadIdx.x == 0) g_depart[s] = now_ns();
}
'''

_TILE_MARKS = r'''
constexpr int kMarkTiles = 4096;
constexpr int kMarkBlocks = 4096;
__device__ unsigned long long g_tile[kMarkTiles][8];
__device__ unsigned long long g_blk[kMarkBlocks][1];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TILE_MARK(k) if (threadIdx.x == 0 && t < kMarkTiles) g_tile[t][k] = now_ns();
#define BLOCK_MARK(k) if (threadIdx.x == 0 && blockIdx.x < kMarkBlocks) g_blk[blockIdx.x][k] = now_ns();
extern "C" int pt_reset() {
  void* p = nullptr;
  cudaGetSymbolAddress(&p, g_tile);
  cudaMemset(p, 0, sizeof(g_tile));
  cudaGetSymbolAddress(&p, g_blk);
  return static_cast<int>(cudaMemset(p, 0, sizeof(g_blk)));
}
extern "C" int pt_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_tile, sizeof(g_tile));
  return static_cast<int>(cudaMemcpyFromSymbol(
      out + kMarkTiles * 8, g_blk, sizeof(g_blk)));
}
'''
#: (stamps a tile, stamps a block) of the merge_maps marks
_TILE_SHAPE = (4096, 8)
_BLOCK_SHAPE = (4096, 1)

_ROW_MARKS = r'''
constexpr int kMarkRows = 8192;
__device__ unsigned long long g_mark[kMarkRows][8];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ int g_sink;
#define FDB_MARK(k) { SYNC long long r_ = ROW; \
  if (LEAD && r_ < kMarkRows) g_mark[r_][k] = now_ns(); }
#define FDB_MARK_AFTER(k, v) { if ((v) == 0x7EADBEEF) g_sink = 1; \
  FDB_MARK(k) }
extern "C" int pt_reset() {
  void* p = nullptr;
  cudaGetSymbolAddress(&p, g_mark);
  return static_cast<int>(cudaMemset(p, 0, sizeof(g_mark)));
}
extern "C" int pt_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_mark, sizeof(g_mark)));
}
'''
#: (rows, stamps a row) of the FDB_MARK marks
_ROW_SHAPE = (8192, 8)
#: each kernel's mark rows: a warp's lane 0 (the probe, A's and G's
#: queries) or a block's thread 0 after the block's threads meet (the fold)
_ROW_OF = {
    "keysearch_probe": ("", "(blockIdx.x * blockDim.x + threadIdx.x) >> 5",
                        "(threadIdx.x & 31) == 0"),
    "keysearch_search": ("", "(blockIdx.x * blockDim.x + threadIdx.x) >> 5",
                         "(threadIdx.x & 31) == 0"),
    "sweep_ranks": ("", "(blockIdx.x * blockDim.x + threadIdx.x) >> 5",
                    "(threadIdx.x & 31) == 0"),
    "keysearch_query": ("", "(blockIdx.x * blockDim.x + threadIdx.x) >> 5",
                        "(threadIdx.x & 31) == 0"),
    "rangemax2_query": ("", "(blockIdx.x * blockDim.x + threadIdx.x) >> 5",
                        "(threadIdx.x & 31) == 0"),
    "rangemax2_build": ("", "blockIdx.x", "threadIdx.x == 0"),
    "rangemax4_query": ("", "(blockIdx.x * blockDim.x + threadIdx.x) >> 5",
                        "(threadIdx.x & 31) == 0"),
    "seg_fold": ("__syncthreads();", "blockIdx.x", "threadIdx.x == 0"),
    "short_span": ("__syncthreads();", "blockIdx.x", "threadIdx.x == 0"),
}

#: the source each traced name edits, where the two differ
_SOURCE_OF = {"keysearch_probe": "keysearch", "keysearch_query": "keysearch",
              "keysearch_search": "keysearch",
              "rangemax2_query": "rangemax2", "rangemax2_build": "rangemax2",
              "merge_writes": "merge_maps", "rangemax4_query": "rangemax4",
              "rangemax4_build": "rangemax_build",
              "min_cover4": "min_cover"}

_READ = r'''
extern "C" int pt_reset() {
  unsigned long long z[64] = {0}, big = ~0ull, zero = 0;
  cudaMemcpyToSymbol(g_arrive, z, sizeof(z));
  cudaMemcpyToSymbol(g_depart, z, sizeof(z));
  cudaMemcpyToSymbol(g_begin, &big, sizeof(big));
  return static_cast<int>(cudaMemcpyToSymbol(g_end, &zero, sizeof(zero)));
}
extern "C" int pt_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_arrive, 64 * sizeof(unsigned long long));
  cudaMemcpyFromSymbol(out + 64, g_depart, 64 * sizeof(unsigned long long));
  cudaMemcpyFromSymbol(out + 128, g_begin, sizeof(unsigned long long));
  return static_cast<int>(
      cudaMemcpyFromSymbol(out + 129, g_end, sizeof(unsigned long long)));
}
'''

_STAGED = '''      if (act) {
        int t = tbs[d] + wo[warp * kBins + d] + __popc(lower);
        store_row<W>(srow + t * W, r);
        sidx[t] = idx;
        sdig[t] = d;
      }
      __syncthreads();
      for (int j = tid; j < n_tile * W; j += kSortThreads) {
        int t = j / W;
        size_t at = static_cast<size_t>(gbase[sdig[t]] + t) * W + (j - t * W);
        dst_rows[at] = srow[j];
      }
      if (tid < n_tile) dst_perm[gbase[sdig[tid]] + tid] = sidx[tid];
    }
  }
}'''

_DIRECT = '''      if (act) {
        int pos = gbase[d] + tbs[d] + wo[warp * kBins + d] + __popc(lower);
        store_row<W>(dst_rows + static_cast<size_t>(pos) * W, r);
        dst_perm[pos] = idx;
      }
    }
  }
}'''


def _edit(src: str, old: str, new: str, name: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"phase_trace: {name}.cu no longer holds "
                           f"{old[:60]!r} once")
    return src.replace(old, new)


def traced_merge_source(items: int = 0, threads: int = 0) -> str:
    """merge_maps.cu with a mark at each phase of every tile (thread 0,
    after the block's threads meet there) and at every block's end; with
    `items` / `threads` the tile's positions a thread and threads a
    block in place of the source's."""
    name = "merge_maps"
    src = (kernels.CSRC / f"{name}.cu").read_text()
    if items:
        src = _edit(src, "constexpr int kItems = 8;",
                    f"constexpr int kItems = {items};", name)
    if threads:
        src = _edit(src, "constexpr int kMergeThreads = 256;",
                    f"constexpr int kMergeThreads = {threads};", name)
    src = _edit(src, '#include "common.cuh"\n',
                '#include "common.cuh"\n' + _TILE_MARKS, name)
    for k, line in enumerate((
            "    // -- 1. partition", "    // -- 2. stage",
            "    // -- 3. merge this", "    // -- 4. offsets",
            "    if (warp == 0) {\n      const int prefix = look_back(",
            "    // -- 5. the kept rows")):
        sync = "    __syncthreads();\n" if k == 3 else ""
        src = _edit(src, line, f"{sync}    TILE_MARK({k})\n{line}", name)
    for k, line in ((6, "    // -- 6. the tile's share of the tail"),
                    (7, "    __syncthreads();  // shared memory is the next tile's\n")):
        src = _edit(src, line, f"    TILE_MARK({k})\n{line}", name)
    return _edit(src, "\n}\n\nstruct Plan {",
                 "\n  __syncthreads();\n  BLOCK_MARK(0)\n}\n\nstruct Plan {",
                 name)


_FENCE_OPT_IN = """    {
      cudaError_t a = cudaFuncSetAttribute(
          probe_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (a != cudaSuccess) return static_cast<int>(a);
    }
    probe_kernel<W><<<"""


def traced_row_source(name: str, fence_kb: int = 0,
                      threads: int = 0) -> str:
    """keysearch.cu, seg_fold.cu, short_span.cu or rangemax4.cu with its
    FDB_MARK hooks stamping a row of g_mark; for the probe, with
    `fence_kb` in place of its kFenceBytes; short_span.cu with `threads` a
    block in place of its kApplyThreads."""
    src_name = _SOURCE_OF.get(name, name)
    src = (kernels.CSRC / f"{src_name}.cu").read_text()
    if fence_kb:
        src = _edit(src, "constexpr int kFenceBytes = 12 * 1024;",
                    f"constexpr int kFenceBytes = {fence_kb} * 1024;",
                    src_name)
    if fence_kb > 48:  # a fence past the default needs the opt-in
        src = _edit(src, "    probe_kernel<W><<<", _FENCE_OPT_IN, src_name)
    sync, row, lead = _ROW_OF[name]
    marks = (_ROW_MARKS.replace("SYNC", sync).replace("ROW", row)
             .replace("LEAD", lead))
    if name == "short_span":
        src = _span_threads(src, threads)
    return _edit(src, '#include "common.cuh"\n',
                 '#include "common.cuh"\n' + marks, src_name)


def traced_source(name: str, direct_scatter: bool = False,
                  items: int = 0, threads: int = 0,
                  fence_kb: int = 0) -> str:
    if name in _ROW_OF:
        return traced_row_source(name, fence_kb, threads)
    if name in ("merge_maps", "merge_writes"):
        return traced_merge_source(items, threads)
    name = _SOURCE_OF.get(name, name)
    src = (kernels.CSRC / f"{name}.cu").read_text()
    src = _edit(src, '#include "common.cuh"\n',
                '#include "common.cuh"\n' + _MARKS, name)
    if "grid.sync();" not in src:
        raise RuntimeError(f"phase_trace: no grid sync in {name}.cu")
    src = src.replace("grid.sync();",
                      "arrive(slot_); grid.sync(); depart(slot_++);")
    grid = "  cg::grid_group grid = cg::this_grid();\n"
    src = _edit(src, grid, grid + "  int slot_ = 0;\n"
                "  if (threadIdx.x == 0) atomicMin(&g_begin, now_ns());\n",
                name)
    if direct_scatter:
        src = _edit(src, _STAGED, _DIRECT, name)
    # the kernel is the last function before its grid plan
    src = _edit(src, "\n}\n\nstruct Plan {",
                "\n  if (threadIdx.x == 0) atomicMax(&g_end, now_ns());\n}"
                "\n\nstruct Plan {", name)
    return src + _READ


_ARGTYPES = {
    "lo_scratch_words": [ctypes.c_int] * 2,
    "lo_sort": kernels._SIGNATURES["lo_sort"][1],
    "rm_build": kernels._SIGNATURES["rm_build"][1],
    "mc_cover": kernels._SIGNATURES["mc_cover"][1],
    "mm_scratch_words": kernels._SIGNATURES["mm_scratch_words"][1],
    "mm_merge": kernels._SIGNATURES["mm_merge"][1],
    "mm_merge_writes": kernels._SIGNATURES["mm_merge_writes"][1],
    "rm4_build": kernels._SIGNATURES["rm4_build"][1],
    "rm4_query": kernels._SIGNATURES["rm4_query"][1],
    "mc_cover4": kernels._SIGNATURES["mc_cover4"][1],
    "ks_probe": kernels._SIGNATURES["ks_probe"][1],
    "ks_search": kernels._SIGNATURES["ks_search"][1],
    "sw_ranks": kernels._SIGNATURES["sw_ranks"][1],
    "ks_query": kernels._SIGNATURES["ks_query"][1],
    "rm2_query": kernels._SIGNATURES["rm2_query"][1],
    "rm2_build": kernels._SIGNATURES["rm2_build"][1],
    "sf_scratch_words": kernels._SIGNATURES["sf_scratch_words"][1],
    "sf_fold": kernels._SIGNATURES["sf_fold"][1],
    "ss_apply": kernels._SIGNATURES["ss_apply"][1],
}


def build(name: str, direct_scatter: bool = False, items: int = 0,
          threads: int = 0, fence_kb: int = 0):
    kernels.BUILD.mkdir(parents=True, exist_ok=True)
    tag = name + ("_direct" if direct_scatter else "") + (
        f"_{items}x{threads}" if items or threads else "") + (
        f"_f{fence_kb}" if fence_kb else "")
    cu = kernels.BUILD / f"phase_trace_{tag}.cu"
    so = kernels.BUILD / f"libphase_trace_{tag}.so"
    cu.write_text(traced_source(name, direct_scatter, items, threads,
                                fence_kb))
    done = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
         "-o", str(so), str(cu)], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError("nvcc failed:\n" + done.stdout + done.stderr)
    lib = ctypes.CDLL(str(so))
    for entry, argtypes in _ARGTYPES.items():
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = argtypes
    lib.pt_read.argtypes = [ctypes.c_void_p]
    return lib


def trace(lib, call, reps: int = 4) -> dict:
    """The last of `reps` launches by call(stream): (total, work per
    phase, cost per sync) in microseconds."""
    marks = torch.zeros((130,), dtype=torch.int64)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(reps):
        torch.cuda.synchronize()
        lib.pt_reset()
        err = call(stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")
        torch.cuda.synchronize()
        lib.pt_read(ctypes.c_void_p(marks.data_ptr()))
    m = marks.tolist()
    arrive, depart, begin, end = m[:64], m[64:128], m[128], m[129]
    work, sync, prev = [], [], begin
    for s in range(sum(1 for t in arrive if t)):
        work.append((arrive[s] - prev) / 1e3)
        sync.append((depart[s] - arrive[s]) / 1e3)
        prev = depart[s]
    work.append((end - prev) / 1e3)
    return dict(total_us=(end - begin) / 1e3, work_us=work, sync_us=sync)


def run_lex_order(lib, rows):
    p, w = rows.shape
    perm = torch.empty((p,), dtype=torch.int32, device=rows.device)
    srt = torch.empty_like(rows)
    scratch = torch.empty((lib.lo_scratch_words(p, w),), dtype=torch.int32,
                          device=rows.device)
    r = trace(lib, lambda st: lib.lo_sort(
        rows.data_ptr(), p, w, srt.data_ptr(), perm.data_ptr(),
        scratch.data_ptr(), st))
    r["exact"] = torch.equal(perm, K.lex_sort_perm_plain(rows)[0])
    return r


def run_rangemax_build(lib, args):
    values, op = args
    m = values.shape[0]
    levels = R._num_levels(m)
    table = torch.empty((levels, m), dtype=torch.int32, device=values.device)
    r = trace(lib, lambda st: lib.rm_build(
        values.data_ptr(), table.data_ptr(), m, levels, int(op == "min"), st))
    r["exact"] = torch.equal(table, R.build_plain(values, op=op))
    return r


def run_min_cover(lib, args):
    leaves, lo, hi, val = args
    table = torch.empty((leaves.bit_length(), leaves), dtype=torch.int32,
                        device=val.device)
    r = trace(lib, lambda st: lib.mc_cover(
        lo.data_ptr(), hi.data_ptr(), val.data_ptr(), lo.shape[0], leaves,
        table.data_ptr(), st))
    r["exact"] = torch.equal(table[0], S.min_cover_plain(leaves, lo, hi, val))
    return r


def run_rangemax4_build(lib, args):
    values, op = args
    m = values.shape[0]
    levels = R._num_levels4(m)
    table = torch.empty((levels, m), dtype=torch.int32, device=values.device)
    r = trace(lib, lambda st: lib.rm4_build(
        values.data_ptr(), table.data_ptr(), m, levels, int(op == "min"), st))
    r["exact"] = torch.equal(table, R.build4_plain(values, op=op))
    return r


def run_min_cover4(lib, args):
    leaves, lo, hi, val = args
    table = torch.empty((S._cover4_levels(leaves), leaves), dtype=torch.int32,
                        device=val.device)
    r = trace(lib, lambda st: lib.mc_cover4(
        lo.data_ptr(), hi.data_ptr(), val.data_ptr(), lo.shape[0], leaves,
        table.data_ptr(), st))
    r["exact"] = torch.equal(table[0],
                             S.min_cover4_plain(leaves, lo, hi, val))
    return r


def run_merge_maps(lib, args, reps: int = 4, tile: int = 2048) -> dict:
    """mm_merge's per-tile phases (microseconds) in the last of `reps`
    launches, and its output held to merge_maps_plain."""
    a_keys, a_val, b_keys, b_val, floor, cap = args
    dev = a_keys.device
    na, nb, w = a_keys.shape[0], b_keys.shape[0], a_keys.shape[1]
    out_keys = torch.empty((cap, w), dtype=torch.int32, device=dev)
    out_val = torch.empty((cap,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    r = tile_trace(lib, na + nb, tile, reps, lambda scratch, epoch, st:
                   lib.mm_merge(
                       a_keys.data_ptr(), a_val.data_ptr(), na,
                       b_keys.data_ptr(), b_val.data_ptr(), nb, w, floor,
                       cap, out_keys.data_ptr(), out_val.data_ptr(),
                       count.data_ptr(), scratch.data_ptr(), epoch, st))
    want = H.merge_maps_plain(a_keys, a_val, b_keys, b_val, floor=floor,
                              capacity=cap)
    r["exact"] = all(torch.equal(g, x) for g, x in
                     zip((out_keys, out_val, count), want))
    return r


def run_merge_writes(lib, args, reps: int = 4, tile: int = 2048) -> dict:
    """mm_merge_writes's per-tile phases, as run_merge_maps gives
    mm_merge's, and its output held to merge_writes_plain."""
    state, runs, version, floor = args
    keys, ver = state.main_keys, state.main_ver
    dev = keys.device
    (m, w), nb = keys.shape, runs.shape[0]
    out_keys = torch.empty((m, w), dtype=torch.int32, device=dev)
    out_val = torch.empty((m,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    r = tile_trace(lib, m + nb, tile, reps, lambda scratch, epoch, st:
                   lib.mm_merge_writes(
                       keys.data_ptr(), ver.data_ptr(), m, runs.data_ptr(),
                       nb, w, version, floor, m, out_keys.data_ptr(),
                       out_val.data_ptr(), count.data_ptr(),
                       state.overflow.data_ptr(), overflow.data_ptr(),
                       scratch.data_ptr(), epoch, st))
    want = H.merge_writes_plain(state, runs, version, floor)
    r["exact"] = all(torch.equal(g, x) for g, x in zip(
        (out_keys, out_val, overflow),
        (want.main_keys, want.main_ver, want.overflow)))
    return r


def tile_trace(lib, n: int, tile: int, reps: int, launch) -> dict:
    """Kernel D's per-tile phases (microseconds) in the last of `reps`
    launches by launch(scratch, epoch, stream), over n merged positions."""
    # the kernel takes tiles of `tile` or `tile // 2` positions
    n_tiles = (n + tile // 2 - 1) // (tile // 2)
    if n_tiles > _TILE_SHAPE[0]:
        raise ValueError("phase_trace: more tiles than marks")
    scratch = torch.zeros((lib.mm_scratch_words(n, 0),), dtype=torch.int64,
                          device="cuda")
    n_tile = _TILE_SHAPE[0] * _TILE_SHAPE[1]
    marks = torch.zeros((n_tile + _BLOCK_SHAPE[0] * _BLOCK_SHAPE[1],),
                        dtype=torch.int64)
    stream = torch.cuda.current_stream().cuda_stream
    for epoch in range(1, reps + 1):
        torch.cuda.synchronize()
        lib.pt_reset()
        err = launch(scratch, epoch, stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")
        torch.cuda.synchronize()
        lib.pt_read(ctypes.c_void_p(marks.data_ptr()))
    tile = marks[:n_tile].view(*_TILE_SHAPE)[:n_tiles]
    tile = tile[tile[:, 7] > 0]   # the tiles of the real rows
    blk = marks[n_tile:].view(*_BLOCK_SHAPE)
    blk = blk[blk[:, 0] > 0]
    begin = int(tile[:, 0].min())
    steps = (tile[:, 1:] - tile[:, :-1]).double() / 1e3
    names = ("split", "stage", "merge", "scan", "look-back", "write",
             "tail share")
    return dict(
        total_us=(int(blk[:, 0].max()) - begin) / 1e3,
        tiles=int(tile.shape[0]), blocks=int(blk.shape[0]),
        tiles_end_us=(int(tile[:, 7].max()) - begin) / 1e3,
        last_ticket_us=(int(tile[:, 0].max()) - begin) / 1e3,
        mean_us={k: round(float(steps[:, i].mean()), 2)
                 for i, k in enumerate(names)},
        max_us={k: round(float(steps[:, i].max()), 2)
                for i, k in enumerate(names)})


def row_phases(marks: torch.Tensor, phases: tuple) -> dict:
    """Each phase's mean and largest microseconds over the rows that ran
    it (a phase (name, k, j) from a row's stamp k to its stamp j, both
    set), and the span from the first stamp to the last."""
    rows = marks.view(*_ROW_SHAPE)
    rows = rows[rows[:, 0] > 0]
    mean, most = {}, {}
    for name, k, j in phases:
        both = (rows[:, k] > 0) & (rows[:, j] > 0)
        if both.any():
            d = (rows[both, j] - rows[both, k]).double() / 1e3
            mean[name], most[name] = round(float(d.mean()), 2), round(
                float(d.max()), 2)
    return dict(rows=int(rows.shape[0]),
                span_us=(int(rows.max()) - int(rows[:, 0].min())) / 1e3,
                mean_us=mean, max_us=most)


def row_trace(lib, call, phases: tuple, reps: int = 4) -> dict:
    """The last of `reps` launches by call(stream): row_phases."""
    marks = torch.zeros((_ROW_SHAPE[0] * _ROW_SHAPE[1],), dtype=torch.int64)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(reps):
        torch.cuda.synchronize()
        lib.pt_reset()
        err = call(stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")
        torch.cuda.synchronize()
        lib.pt_read(ctypes.c_void_p(marks.data_ptr()))
    return row_phases(marks, phases)


def run_keysearch_probe(lib, args) -> dict:
    keys, ver, rb, re = args
    table = R.build_plain(ver, op="max")
    q = rb.shape[0]
    out = torch.empty((q,), dtype=torch.int32, device=rb.device)
    r = row_trace(lib, lambda st: lib.ks_probe(
        keys.data_ptr(), keys.shape[0], keys.shape[1], table.data_ptr(),
        table.shape[0], rb.data_ptr(), re.data_ptr(), q, out.data_ptr(), st),
        (("fence stage", 0, 1), ("shared levels", 1, 2),
         ("global levels", 2, 3), ("window and fall-back", 3, 4),
         ("table gather", 4, 5)))
    r["exact"] = torch.equal(out, H.query_reads_vmax_plain(keys, table, rb,
                                                           re))
    return r


def run_keysearch_search(lib, args) -> dict:
    """A's search's per-warp phases: the fence stage, shared-memory and
    global levels, for both sides the window and the search past it, the
    write; args (keys, queries, side)."""
    keys, q, side = args
    n = q.shape[0]
    both = side == "both"
    out = torch.empty(((2 if both else 1) * n,), dtype=torch.int32,
                      device=q.device)
    tail = (("window and past it", 3, 4), ("write", 4, 5)) if both else (
        ("write", 3, 5),)
    r = row_trace(lib, lambda st: lib.ks_search(
        keys.data_ptr(), keys.shape[0], keys.shape[1], q.data_ptr(), n,
        K.SIDES.index(side), out.data_ptr(), st),
        (("fence stage", 0, 1), ("shared levels", 1, 2),
         ("global levels", 2, 3), *tail))
    want = K.searchsorted_plain(keys, q, side=side)
    r["exact"] = (torch.equal(out[:n], want[0])
                  and torch.equal(out[n:], want[1])) if both else \
        torch.equal(out, want)
    return r


def run_sweep_ranks(lib, args) -> dict:
    """E's per-warp phases: the fence stage, the begin's shared-memory and
    global levels, the end (gallop, window or bucket), the write; args
    (keys, rb, re, live)."""
    keys, rb, re, live = args
    r_ = rb.shape[0]
    il = torch.empty((r_,), dtype=torch.int32, device=rb.device)
    ir = torch.empty_like(il)
    r = row_trace(lib, lambda st: lib.sw_ranks(
        keys.data_ptr(), keys.shape[0], keys.shape[1], rb.data_ptr(),
        re.data_ptr(), live.data_ptr(), r_, il.data_ptr(), ir.data_ptr(), st),
        (("fence stage", 0, 1), ("shared levels", 1, 2),
         ("global levels", 2, 3), ("end", 3, 4), ("write", 4, 5)))
    want = D.sweep_read_ranks_plain(keys, rb, re, live)
    r["exact"] = torch.equal(il, want[0]) and torch.equal(ir, want[1])
    return r


def run_keysearch_query(lib, args) -> dict:
    """A's query's per-warp phases: both ends, the short path's two
    lookups, the warp's long queries; args (table, lo, hi, op)."""
    table, lo, hi, op = args
    q = lo.shape[0]
    out = torch.empty((q,), dtype=torch.int32, device=lo.device)
    r = row_trace(lib, lambda st: lib.ks_query(
        table.data_ptr(), table.shape[0], table.shape[1], lo.data_ptr(),
        hi.data_ptr(), q, int(op == "min"), out.data_ptr(), st),
        (("ends", 0, 1), ("short lookups", 1, 2), ("long path", 2, 3)))
    r["exact"] = torch.equal(out, R.query_plain(table, lo, hi, op=op))
    return r


def run_rangemax4_query(lib, args) -> dict:
    """M's query's per-warp phases: the ends loaded, the gathers
    arrived; args (table, lo, hi, op)."""
    table, lo, hi, op = args
    q = lo.shape[0]
    out = torch.empty((q,), dtype=torch.int32, device=lo.device)
    r = row_trace(lib, lambda st: lib.rm4_query(
        table.data_ptr(), table.shape[0], table.shape[1], lo.data_ptr(),
        hi.data_ptr(), q, int(op == "min"), out.data_ptr(), st),
        (("ends", 0, 1), ("gathers", 1, 2)))
    r["exact"] = torch.equal(out, R.query4_plain(table, lo, hi, op=op))
    return r


def run_rangemax2_query(lib, args) -> dict:
    """G's query's per-warp phases over a structure the shipped build
    made: both ends, a short range's own rows, the warp's wide queries
    by teams of 8 lanes (and the whole warp); args (values, lo, hi)."""
    values, lo, hi = args
    built = R.build2(values, op="max")
    v, chunk, table = built
    q = lo.shape[0]
    out = torch.empty((q,), dtype=torch.int32, device=lo.device)
    r = row_trace(lib, lambda st: lib.rm2_query(
        v.data_ptr(), v.shape[0], chunk.data_ptr(), chunk.shape[0],
        table.data_ptr(), table.shape[1], lo.data_ptr(), hi.data_ptr(), q,
        0, out.data_ptr(), st),
        (("ends", 0, 1), ("short rows", 1, 2), ("wide queries", 2, 3),
         ("warp", 0, 3)))
    r["exact"] = torch.equal(out.cpu(), R.query2_plain(
        R.build2_plain(values.cpu(), op="max"), lo.cpu(), hi.cpu(),
        op="max"))
    return r


def run_rangemax2_build(lib, args) -> dict:
    """G's build's per-block phases (thread 0's marks): the block's chunk
    and superchunk maxima, the fence and its ticket; in the last block
    the read of level 0 and the levels above it; args (values,)."""
    (values,) = args
    m = values.shape[0]
    nc, ns = -(-m // R.CHUNK), -(-m // R.SUPER)
    levels = R._num_levels(ns)
    chunk = torch.empty((nc,), dtype=torch.int32, device=values.device)
    table = torch.empty((levels, ns), dtype=torch.int32, device=values.device)
    arrive = torch.zeros((1,), dtype=torch.int32, device=values.device)
    r = row_trace(lib, lambda st: lib.rm2_build(
        values.data_ptr(), m, chunk.data_ptr(), nc, table.data_ptr(), ns,
        levels, arrive.data_ptr(), 0, st),
        (("chunks", 0, 1), ("fence and ticket", 1, 2), ("block", 0, 2),
         ("level 0 read", 2, 3), ("levels", 3, 4)))
    plain = R.build2_plain(values, op="max")
    ns_pad = torch.full((ns * R.CHUNK,), R.INT32_NEG, dtype=torch.int32,
                        device=values.device)
    want_chunk = plain[0][R.CHUNK_BITS][::R.CHUNK]
    ns_pad[:nc] = want_chunk
    r["exact"] = (torch.equal(chunk, want_chunk) and torch.equal(
        table, R.build_plain(ns_pad.reshape(ns, R.CHUNK).amax(dim=1),
                             op="max")) and int(arrive) == 0)
    return r


def run_seg_fold(lib, args) -> dict:
    seg, wb, we, cw = args
    n = seg.shape[0]
    scratch = torch.zeros((lib.sf_scratch_words(n),), dtype=torch.int32,
                          device=seg.device)
    got = seg.clone()
    r = row_trace(lib, lambda st: lib.sf_fold(
        wb.data_ptr(), we.data_ptr(), cw.data_ptr(), wb.shape[0], n, 77,
        got.data_ptr(), scratch.data_ptr(), st),
        (("survey", 0, 1), ("grid sync", 1, 2), ("paint", 2, 3),
         ("wide writes", 3, 4), ("count", 2, 4), ("reset", 4, 5)))
    if "paint" in r["mean_us"]:   # the count's span is the paint's there
        del r["mean_us"]["count"], r["max_us"]["count"]
    r["path"] = "paint" if "paint" in r["mean_us"] else "count"
    r["exact"] = (torch.equal(got, G.seg_fold_plain(seg.clone(), wb, we, cw,
                                                    77))
                  and not bool(scratch.any()))
    return r


_SPAN_PHASES = (("cover", 0, 1), ("grid sync", 1, 2), ("query", 2, 3),
                ("second grid sync", 3, 4), ("reset", 4, 5))


def run_short_span(lib, args) -> dict:
    """The per-block phases of the last of 4 launches, exact and its cover
    as the launch leaves it, at an ordinary stamp and at the last stamp;
    args: (leaves, wlo, whi, val, qlo, qhi, S)."""
    leaves, wlo, whi, val, qlo, qhi, ss = args
    want = G.ss_apply_plain(leaves, wlo, whi, val, qlo, qhi, ss)
    out = torch.empty_like(qlo)
    res = {}
    for last in (False, True):
        flat = torch.full((leaves + 1,), -1, dtype=torch.int64,
                          device=val.device)

        def one(st):
            if last:
                flat[-1] = 0
            return lib.ss_apply(
                wlo.data_ptr(), whi.data_ptr(), val.data_ptr(), wlo.shape[0],
                qlo.data_ptr(), qhi.data_ptr(), qlo.shape[0], ss, leaves,
                flat.data_ptr(), leaves, out.data_ptr(), st)

        r = row_trace(lib, one, _SPAN_PHASES)
        r["exact"] = (torch.equal(out, want)
                      and (not last or bool((flat == -1).all())))
        res["at the last stamp" if last else "stamp"] = r
    return res


def _span_threads(src: str, threads: int) -> str:
    """short_span.cu with `threads` a block in place of its
    kApplyThreads (0: unchanged)."""
    if not threads:
        return src
    return _edit(src, "constexpr int kApplyThreads = 512;",
                 f"constexpr int kApplyThreads = {threads};", "short_span")


def shapes(name: str, device) -> dict:
    """Seeded inputs for one kernel. Rows for N: 8-byte keys below 1M or
    10M (word 0 zero, the length word 8), a tenth of the rows the
    all-ones sentinel where the path masks dead rows."""
    gen = torch.Generator(device=device).manual_seed(20261017)

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=device,
                             dtype=torch.int32)

    if name == "keysearch_probe":
        m, q = 786_432, 65_536

        def tier(keyspace):
            v = torch.unique(torch.randint(0, keyspace, (m,), generator=gen,
                                           device=device))[: 3 * m // 4]
            keys = K.sentinel_like(m, 3, device)
            keys[: v.shape[0]] = _int_keys(v)
            ver = ints(0, 3_000_000, m)
            ver[v.shape[0]:] = H.VERSION_NEG
            return keys, ver, v

        keys, ver, v = tier(1 << 40)
        begin = torch.randint(0, 1 << 40, (q,), generator=gen, device=device)
        end = begin + torch.randint(1, 1 << 30, (q,), generator=gen,
                                    device=device)
        pick = torch.randint(0, v.shape[0], (q // 4,), generator=gen,
                             device=device)
        begin[: q // 4] = v[pick]
        ukeys, uver, _ = tier(1_000_001)
        point = torch.randint(0, 1_000_000, (q,), generator=gen,
                              device=device)
        return {"786432 rows, 65536 long reads": (
                    keys, ver, _int_keys(begin), _int_keys(end)),
                "786432 rows of 1M keys, 65536 uniform point reads": (
                    ukeys, uver, _int_keys(point), _int_keys(point + 2))}
    if name in ("keysearch_search", "sweep_ranks"):
        # the short-span classic path's tier: 786,432 rows, 3/4 live, of
        # the uniform stream's 1M keys
        m, q = 786_432, 8 * 65_536
        v = torch.sort(torch.randperm(1_000_001, generator=gen,
                                      device=device)[: 3 * m // 4]).values
        keys = K.sentinel_like(m, 3, device)
        keys[: v.shape[0]] = _int_keys(v)
        begin = torch.randint(0, 1_000_000, (q,), generator=gen,
                              device=device)
        if name == "sweep_ranks":
            end = begin + torch.randint(1, 101, (q,), generator=gen,
                                        device=device)
            live = torch.rand((q,), generator=gen, device=device) >= 0.05
            return {"786432 rows of 1M keys, 524288 scans of 1-100 keys": (
                keys, _int_keys(begin), _int_keys(end), live)}
        u = torch.unique(torch.randint(0, 1_000_000, (4 * q,), generator=gen,
                                       device=device))
        ukeys = K.sentinel_like(4 * q, 3, device)
        ukeys[: u.shape[0]] = _int_keys(u)
        rb = _int_keys(begin)
        out = {f"786432 rows of 1M keys, 524288 point reads, {side}": (
            keys, rb, side) for side in K.SIDES}
        out[f"786432 rows of 1M keys, {4 * q} distinct point keys "
            f"({u.shape[0]} live), both"] = (keys, ukeys, "both")
        return out
    if name == "keysearch_query":
        # the fixpoint's min table over 2^18 leaves, at FIXPOINT_LEVELS and
        # at every level, and reads of a uniform batch's local spans (1-2),
        # a YCSB-E batch's (1-101) and spans up to the whole leaf range
        leaves, q = 262_144, 65_536
        mw = ints(0, q, leaves)
        lo = ints(0, leaves, q)
        cut = R.build(mw, op="min", levels=G.FIXPOINT_LEVELS)
        full = R.build(mw, op="min")
        out = {}
        for what, most in (("uniform spans 1-2", 2), ("YCSB-E spans 1-101",
                                                      101),
                           ("spans up to 2^18", leaves)):
            hi = (lo + ints(1, most + 1, q)).clamp(max=leaves)
            out[f"2^18 leaves, L = {G.FIXPOINT_LEVELS}, {what}"] = (
                cut, lo, hi, "min")
            if most == 2:
                out[f"2^18 leaves, L = {full.shape[0]}, {what}"] = (
                    full, lo, hi, "min")
        return out
    if name == "rangemax2_build":
        # G's build over a classic group of 8's 2,097,152 ranks (2,048
        # superchunks, 12 levels) of random versions
        return {"2097152 ranks": (ints(H.VERSION_NEG, R.INT32_POS,
                                       8 * 262_144),)}
    if name == "rangemax2_query":
        # G's cross query over a classic group of 8 uniform batches: random
        # versions over the group's 2,097,152 ranks; batch 1's reads at
        # their own ranks, and phase 2's synthetic mix of chip_smoke.py
        # (every 4th 33-200,000 ranks wide, every 16th empty)
        ranks, n_map = _uniform_group_ranks(device)
        seg = ints(H.VERSION_NEG, R.INT32_POS, n_map)
        rb, re = ranks[1][0], ranks[1][1]
        lo, hi = rb.clone(), re.clone()
        wide = torch.arange(0, lo.shape[0], 4, device=device)
        hi[wide] = (lo[wide] + ints(33, 200_000, wide.shape[0])).clamp(
            max=n_map)
        empty = torch.arange(1, lo.shape[0], 16, device=device)
        hi[empty] = lo[empty] - ints(0, 3, empty.shape[0])
        return {f"{n_map} ranks, batch 1's reads at the stream's ranks": (
                    seg, rb, re),
                f"{n_map} ranks, the synthetic mix": (seg, lo, hi)}
    if name == "seg_fold":
        n, nw = 8 * 262_144, 65_536
        seg = ints(-5, 50, n)
        wb = ints(0, n - 1, nw)
        we = wb + 1
        cw = torch.rand((nw,), generator=gen, device=device) < 0.97
        wide, inv = (wb.clone(), we.clone()), (wb.clone(), we.clone())
        wide[0][0], wide[1][0] = 0, n
        inv[0][0], inv[1][0] = 1_000, 10
        cw_one = cw.clone()
        cw_one[0] = True
        return {"2097152 ranks, 65536 point writes": (seg, wb, we, cw),
                "the same and one write over the whole space": (
                    seg, *wide, cw_one),
                "the same and one inverted committed write": (
                    seg, *inv, cw_one)}
    if name == "short_span":
        # a uniform batch's fixpoint: point reads and writes of 1M keys,
        # their dense ranks (dead rows, a tenth, at the sentinel's)
        nr = nw = 65_536
        v = torch.randint(0, 1_000_000, (2 * nr,), generator=gen,
                          device=device)
        pts = _int_keys(torch.cat([v[:nr], v[:nr] + 1, v[nr:], v[nr:] + 1]))
        pts[torch.rand((pts.shape[0],), generator=gen, device=device)
            < 0.1] = -1
        rank = K.dense_ranks(pts.contiguous())
        val = ints(0, nw, nw)
        val[torch.rand((nw,), generator=gen, device=device) < 0.05] = \
            R.INT32_POS
        return {"2^18 leaves, 65536 writes and reads, S = 4": (
            262_144, rank[2 * nr:3 * nr], rank[3 * nr:], val, rank[:nr],
            rank[nr:2 * nr], 4)}
    if name == "rangemax_build":
        return {"786432 rows, max": (ints(-5_000_000, 5_000_000, 786_432),
                                     "max"),
                "262144 leaves, min": (ints(0, 65_536, 262_144), "min")}
    if name == "merge_maps":
        m, b = 786_432, 65_536

        def tier(n_live, lo, hi):
            v = torch.unique(torch.randint(0, 1 << 40, (n_live * 11 // 10,),
                                           generator=gen, device=device))
            v = v[:n_live]
            keys = K.sentinel_like(m, 3, device)
            keys[: v.shape[0]] = _int_keys(v)
            val = ints(lo, hi, m)
            val[v.shape[0]:] = H.VERSION_NEG
            return keys, val

        main = tier(3 * m // 4, 0, 3_000_000)
        delta = tier(m // 3, 2_000_000, 4_000_000)
        begin = torch.randint(0, 1 << 40, (b,), generator=gen, device=device)
        end = begin + torch.randint(1, 1 << 30, (b,), generator=gen,
                                    device=device)
        cw = torch.rand((b,), generator=gen, device=device) < 0.97
        cov = G._coverage(_int_keys(begin), _int_keys(end), cw, 4_000_000)
        return {"786432 + 786432 (compaction)": (*main, *delta, 2_500_000,
                                                 m),
                "786432 + 131072 (batch merge)": (*delta, *cov, 2_500_000,
                                                  m)}
    if name == "merge_writes":
        m, n_runs = 786_432, 131_072
        v = torch.unique(torch.randint(0, 1 << 40, (m,), generator=gen,
                                       device=device))[: m - n_runs]
        keys = K.sentinel_like(m, 3, device)
        keys[: v.shape[0]] = _int_keys(v)
        ver = ints(0, 1_000_000, m)
        ver[v.shape[0]:] = H.VERSION_NEG
        b = torch.randint(0, 1 << 40, (n_runs,), generator=gen,
                          device=device)
        b[: n_runs // 8] = v[torch.randint(0, v.shape[0], (n_runs // 8,),
                                           generator=gen, device=device)]
        b = torch.unique(b)
        b = b[: b.shape[0] // 2 * 2]
        runs = K.sentinel_like(n_runs, 3, device)
        runs[: b.shape[0]] = _int_keys(b)
        state = H.VersionHistory(keys, ver, 0, torch.zeros(
            (), dtype=torch.bool, device=device))
        return {f"{v.shape[0]} + {b.shape[0]} real rows": (
            state, runs, 1_200_000, 200_000)}
    if name == "rangemax4_query":
        leaves, q = 262_144, 65_536
        table = R.build4_plain(ints(0, 1 << 30, leaves), op="max")
        lo = ints(0, leaves - 1, q)
        hi = (lo + ints(1, 64, q)).clamp(max=leaves)
        return {"2^18 leaves, 65536 queries of 1-63": (table, lo, hi,
                                                        "max")}
    if name == "rangemax4_build":
        return {"262144 leaves, max": (ints(0, 1 << 30, 262_144), "max"),
                "262144 leaves, min": (ints(0, 1 << 30, 262_144), "min")}
    if name == "min_cover4":
        leaves, n = 262_144, 65_536
        lo = ints(0, leaves - 64, n)
        spans = lo + (1 << ints(0, 19, n))
        return {"2^18 leaves, 65536 intervals of 1-63":
                (leaves, lo, lo + ints(1, 64, n), ints(0, n, n)),
                "2^18 leaves, 65536 of every level":
                (leaves, lo, spans, ints(0, n, n))}
    if name == "min_cover":
        leaves, n = 262_144, 65_536
        lo = ints(0, leaves, n)
        short = lo + ints(-1, 8, n)
        spans = lo + (1 << ints(0, 19, n))
        return {"2^18 leaves, 65536 short intervals":
                (leaves, lo, short, ints(0, n, n)),
                "2^18 leaves, 65536 of every level":
                (leaves, lo, spans, ints(0, n, n))}

    def keys(p, hi, dead):
        v = torch.randint(0, hi, (p,), generator=gen, device=device)
        r = torch.stack([torch.zeros_like(v), v, torch.full_like(v, 8)],
                        dim=1).to(torch.int32)
        r[torch.rand((p,), generator=gen, device=device) < dead] = -1
        return r.contiguous()

    return {
        "262144 x 3 (uniform endpoints)": keys(262_144, 1_000_000, 0.1),
        "65536 x 6 (zipf dedup rows)": torch.cat(
            [keys(65_536, 10_000_000, 0.0),
             keys(65_536, 10_000_000, 0.0)], dim=1).contiguous(),
        "2097152 x 3 (classic group of 8)": keys(2_097_152, 1_000_000, 0.1),
        "1 x 3": keys(1, 10, 0.0),
    }


def _uniform_group_ranks(device, gn: int = 8, b: int = 65_536):
    """A classic group of `gn` uniform bench batches (one point read and
    write a txn over 1M 8-byte keys): each batch's [rb, re, wb, we]
    group-wide ranks, as the group kernel computes them, and the map
    size 2 gn (NR + NW)."""
    from foundationdb_tpu_torch import interop
    from foundationdb_tpu_torch.config import KernelConfig
    from foundationdb_tpu_torch.testing.benchgen import skiplist_style_batch

    cfg = KernelConfig(max_key_bytes=8, max_txns=b, max_reads=b,
                       max_writes=b, history_capacity=12 * b,
                       delta_capacity=0)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(gn):
        a = interop.device_args_to_torch(skiplist_style_batch(
            rng, cfg, b, version=(i + 1) * 200_000, keyspace=1_000_000,
            snapshot_lag=400_000, key_bytes=8).device_args(), device)
        live = torch.cat([a["read_valid"], a["read_valid"],
                          a["write_valid"], a["write_valid"]])
        rows.append(torch.where(live[:, None], torch.cat([
            a["read_begin"], a["read_end"], a["write_begin"],
            a["write_end"]]), K.SENTINEL_WORD))
    pts = torch.cat(rows).contiguous()
    grank = G._group_ranks(pts, gn)[0].reshape(gn, -1)
    return ([[grank[i, j * b:(j + 1) * b].contiguous() for j in range(4)]
             for i in range(gn)], pts.shape[0])


def _int_keys(v):
    """int64 [N] (0 <= v < 2^63) -> [N, 3] packed 8-byte keys."""
    words = torch.stack([(v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF,
                         torch.full_like(v, 8)], dim=1)
    return torch.where(words >= 2**31, words - 2**32, words).to(
        torch.int32).contiguous()


RUNS = {"lex_order": run_lex_order, "rangemax_build": run_rangemax_build,
        "min_cover": run_min_cover, "merge_maps": run_merge_maps,
        "keysearch_probe": run_keysearch_probe,
        "keysearch_search": run_keysearch_search,
        "keysearch_query": run_keysearch_query,
        "sweep_ranks": run_sweep_ranks,
        "rangemax2_build": run_rangemax2_build,
        "rangemax2_query": run_rangemax2_query, "seg_fold": run_seg_fold,
        "short_span": run_short_span, "merge_writes": run_merge_writes,
        "rangemax4_build": run_rangemax4_build,
        "rangemax4_query": run_rangemax4_query,
        "min_cover4": run_min_cover4}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(RUNS), default="lex_order")
    ap.add_argument("--direct-scatter", action="store_true",
                    help="lex_order only: the unstaged scatter")
    ap.add_argument("--items", type=int, default=0,
                    help="merge_maps and merge_writes: merged positions a "
                    "thread")
    ap.add_argument("--threads", type=int, default=0,
                    help="merge_maps, merge_writes and short_span: threads "
                    "a block")
    ap.add_argument("--fence-kb", type=int, default=0,
                    help="keysearch_probe only: the fence's most KB")
    args = ap.parse_args(argv)
    merges = ("merge_maps", "merge_writes")
    if args.items and args.kernel not in merges:
        ap.error("--items is merge_maps's and merge_writes's")
    if args.threads and args.kernel not in (*merges, "short_span"):
        ap.error("--threads is merge_maps's, merge_writes's and "
                 "short_span's")
    if args.fence_kb and args.kernel != "keysearch_probe":
        ap.error("--fence-kb is keysearch_probe's")
    if args.direct_scatter and args.kernel != "lex_order":
        ap.error("--direct-scatter is lex_order's")
    if not torch.cuda.is_available():
        print("phase_trace: no CUDA device available", file=sys.stderr)
        return 2
    lib = build(args.kernel, args.direct_scatter, args.items, args.threads,
                args.fence_kb)
    print(f"{torch.cuda.get_device_name(0)}; {args.kernel}"
          + ("; direct scatter" if args.direct_scatter else "")
          + (f"; fence KB {args.fence_kb}" if args.fence_kb else ""))
    for name, inputs in shapes(args.kernel, torch.device("cuda")).items():
        if args.kernel == "short_span":
            r = run_short_span(lib, inputs)
            for when, d in r.items():
                print(f"{name}, {when}: {d}")
            if not all(d["exact"] for d in r.values()):
                return 1
            continue
        if args.kernel in _ROW_OF:
            r = RUNS[args.kernel](lib, inputs)
            print(f"{name}: {r}")
            if not r["exact"]:
                return 1
            continue
        if args.kernel in merges:
            r = RUNS[args.kernel](lib, inputs, tile=(args.items or 8)
                                  * (args.threads or 256))
            print(f"{name}: {r}")
            if not r["exact"]:
                return 1
            continue
        r = RUNS[args.kernel](lib, inputs)
        print(f"{name}: total {r['total_us']:.2f} us, exact {r['exact']}\n"
              f"  work {[round(x, 2) for x in r['work_us']]}\n"
              f"  sync {[round(x, 2) for x in r['sync_us']]}")
        if not r["exact"]:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
