"""Per-phase times of kernel N (csrc/lex_order.cu) on the card.

    python -m foundationdb_tpu_torch.kernels.phase_trace [--direct-scatter]

Builds a copy of lex_order.cu with a `%globaltimer` mark at every grid
sync (each block's arrival, the latest kept; block 0's departure), runs
it on seeded rows at the port's shapes (a uniform batch's 262,144 x 3
endpoint rows, a zipf batch's 65,536 x 6 read-dedup rows, a classic group
of 8's 2,097,152 x 3 rows, one row), holds its permutation to the plain
sort, and prints per call: each phase's work (the latest arrival less the
previous departure) and each sync's cost (block 0's departure less the
latest arrival), in microseconds. `--direct-scatter` writes each row of a
pass from the registers straight to its place instead of staging the tile
in shared memory: the design the staged scatter replaced.

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


def _edit(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise RuntimeError(f"phase_trace: lex_order.cu no longer holds "
                           f"{old[:60]!r} {count} time(s)")
    return src.replace(old, new)


def traced_source(direct_scatter: bool) -> str:
    src = (kernels.CSRC / "lex_order.cu").read_text()
    src = _edit(src, '#include "common.cuh"\n',
                '#include "common.cuh"\n' + _MARKS)
    n_sync = src.count("grid.sync();")
    src = src.replace("grid.sync();",
                      "arrive(slot_); grid.sync(); depart(slot_++);")
    if n_sync == 0:
        raise RuntimeError("phase_trace: no grid sync in lex_order.cu")
    src = _edit(src, "  const int n = a.n;\n",
                "  const int n = a.n;\n  int slot_ = 0;\n"
                "  if (threadIdx.x == 0) atomicMin(&g_begin, now_ns());\n")
    end = _DIRECT if direct_scatter else _STAGED
    if direct_scatter:
        src = _edit(src, _STAGED, _DIRECT)
    src = _edit(src, end, end[:-2] +
                "\n  if (threadIdx.x == 0) atomicMax(&g_end, now_ns());\n}")
    return src + _READ


def build(direct_scatter: bool):
    kernels.BUILD.mkdir(parents=True, exist_ok=True)
    tag = "direct" if direct_scatter else "staged"
    cu = kernels.BUILD / f"phase_trace_{tag}.cu"
    so = kernels.BUILD / f"libphase_trace_{tag}.so"
    cu.write_text(traced_source(direct_scatter))
    done = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
         "-o", str(so), str(cu)], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError("nvcc failed:\n" + done.stdout + done.stderr)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lo_scratch_words.argtypes = [i, i]
    lib.lo_sort.argtypes = [p, i, i, p, p, p, p]
    lib.pt_read.argtypes = [p]
    return lib


def trace(lib, rows: torch.Tensor, reps: int = 4) -> dict:
    """The last of `reps` calls: (total, work per phase, cost per sync)
    in microseconds, and whether the permutation is the plain one."""
    p, w = rows.shape
    perm = torch.empty((p,), dtype=torch.int32, device=rows.device)
    srt = torch.empty_like(rows)
    scratch = torch.empty((lib.lo_scratch_words(p, w),), dtype=torch.int32,
                          device=rows.device)
    marks = torch.zeros((130,), dtype=torch.int64)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    for _ in range(reps):
        torch.cuda.synchronize()
        lib.pt_reset()
        err = lib.lo_sort(rows.data_ptr(), p, w, srt.data_ptr(),
                          perm.data_ptr(), scratch.data_ptr(), stream)
        if err:
            raise RuntimeError(f"lo_sort: CUDA error {err}")
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
    exact = torch.equal(perm, K.lex_sort_perm_plain(rows)[0])
    return dict(total_us=(end - begin) / 1e3, work_us=work, sync_us=sync,
                exact=exact)


def shapes(device) -> dict:
    """Seeded rows: 8-byte keys below 1M or 10M (word 0 zero, the length
    word 8), a tenth of the rows the all-ones sentinel where the path
    masks dead rows."""
    gen = torch.Generator(device=device).manual_seed(20261017)

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--direct-scatter", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phase_trace: no CUDA device available", file=sys.stderr)
        return 2
    lib = build(args.direct_scatter)
    print(f"{torch.cuda.get_device_name(0)}; "
          f"{'direct' if args.direct_scatter else 'staged'} scatter")
    for name, rows in shapes(torch.device("cuda")).items():
        r = trace(lib, rows)
        print(f"{name}: total {r['total_us']:.2f} us, exact {r['exact']}\n"
              f"  work {[round(x, 2) for x in r['work_us']]}\n"
              f"  sync {[round(x, 2) for x in r['sync_us']]}")
        if not r["exact"]:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
