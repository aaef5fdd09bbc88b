"""Per-phase times of the port's cooperative kernels on the card.

    python -m foundationdb_tpu_torch.kernels.phase_trace \
        [--kernel lex_order|rangemax_build|min_cover] [--direct-scatter]

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

A measuring tool: nothing on the resolver path imports it.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

from foundationdb_tpu_torch import kernels
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


def traced_source(name: str, direct_scatter: bool = False) -> str:
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
}


def build(name: str, direct_scatter: bool = False):
    kernels.BUILD.mkdir(parents=True, exist_ok=True)
    tag = name + ("_direct" if direct_scatter else "")
    cu = kernels.BUILD / f"phase_trace_{tag}.cu"
    so = kernels.BUILD / f"libphase_trace_{tag}.so"
    cu.write_text(traced_source(name, direct_scatter))
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


def shapes(name: str, device) -> dict:
    """Seeded inputs for one kernel. Rows for N: 8-byte keys below 1M or
    10M (word 0 zero, the length word 8), a tenth of the rows the
    all-ones sentinel where the path masks dead rows."""
    gen = torch.Generator(device=device).manual_seed(20261017)

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=device,
                             dtype=torch.int32)

    if name == "rangemax_build":
        return {"786432 rows, max": (ints(-5_000_000, 5_000_000, 786_432),
                                     "max"),
                "262144 leaves, min": (ints(0, 65_536, 262_144), "min")}
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


RUNS = {"lex_order": run_lex_order, "rangemax_build": run_rangemax_build,
        "min_cover": run_min_cover}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(RUNS), default="lex_order")
    ap.add_argument("--direct-scatter", action="store_true",
                    help="lex_order only: the unstaged scatter")
    args = ap.parse_args(argv)
    if args.direct_scatter and args.kernel != "lex_order":
        ap.error("--direct-scatter is lex_order's")
    if not torch.cuda.is_available():
        print("phase_trace: no CUDA device available", file=sys.stderr)
        return 2
    lib = build(args.kernel, args.direct_scatter)
    print(f"{torch.cuda.get_device_name(0)}; {args.kernel}"
          + ("; direct scatter" if args.direct_scatter else ""))
    for name, inputs in shapes(args.kernel, torch.device("cuda")).items():
        r = RUNS[args.kernel](lib, inputs)
        print(f"{name}: total {r['total_us']:.2f} us, exact {r['exact']}\n"
              f"  work {[round(x, 2) for x in r['work_us']]}\n"
              f"  sync {[round(x, 2) for x in r['sync_us']]}")
        if not r["exact"]:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
