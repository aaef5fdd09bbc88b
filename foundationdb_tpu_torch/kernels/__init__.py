"""Build, load and count the hand-written Hopper kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface, at first CUDA use, and loaded
with `ctypes`. The sources are built in parallel (one `nvcc` each, all
started together) into `kernels/build/`, under a file name that carries
a hash of the sources, so an edited kernel is never served from a stale
library. Nothing is built or loaded when the module is imported: the
CPU paths never touch it.

Every C entry point takes device pointers and the CUDA stream as
`void*`, launches on that stream (PyTorch's current stream), does not
synchronise, allocates nothing, and returns `cudaGetLastError()`, or
`NO_LAUNCH` (-1, `kNoLaunch` in `common.cuh`) when its sizes leave it
nothing to do and it launched nothing; the wrapper raises on any other
non-zero code.

`COUNTS` holds one plain integer per kernel entry. A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels (`reset_counts` / `counts`).

`build_stats()` is the port's compile-cache view (the JAX package's
`utils/compile_cache.stats()`): libraries loaded from the build
directory as they were (hits), libraries built by `nvcc` in this
process (misses), and the seconds of the last build that compiled
anything. Like the JAX compiler's cache, it is process-wide.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
SOURCES = ("keysearch", "rangemax_build", "min_cover", "merge_maps",
           "sweep_ranks", "read_dedup", "rangemax2", "seg_fold",
           "shard_clip", "shard_combine", "short_span", "sort_ranks",
           "rangemax4", "lex_order")
#: widest packed key (uint32 words) the CUDA kernels are instantiated for
#: (max_key_bytes <= 28); the plain versions take any width
MAX_WORDS = 8
#: widest row kernels N and L sort and rank: a begin key then an end key
MAX_ROW_WORDS = 2 * MAX_WORDS

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: a C entry's return when it launched nothing (empty sizes)
NO_LAUNCH = -1

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures: entry point -> (library, argtypes)
_SIGNATURES = {
    # keys, m, w, queries, q, side (0 left, 1 right, 2 both), out, stream
    "ks_search": ("keysearch", [_P, _I, _I, _P, _I, _I, _P, _P]),
    # ids, n, n_seg, off, stream
    "ks_counts": ("keysearch", [_P, _I, _I, _P, _P]),
    # table, levels, m, lo, hi, q, op_min, out, stream
    "ks_query": ("keysearch", [_P, _I, _I, _P, _P, _I, _I, _P, _P]),
    # keys, m, w, table, levels, rb, re, q, out, stream
    "ks_probe": ("keysearch", [_P, _I, _I, _P, _I, _P, _P, _I, _P, _P]),
    # values, table, m, levels, op_min, stream
    "rm_build": ("rangemax_build", [_P, _P, _I, _I, _I, _P]),
    # lo, hi, val, n, leaves, table, stream
    "mc_cover": ("min_cover", [_P, _P, _P, _I, _I, _P, _P]),
    # na, nb -> scratch int64 words (no stream: a host query, see size())
    "mm_scratch_words": ("merge_maps", [_I, _I]),
    # a_keys, a_val, na, b_keys, b_val, nb, w, floor, cap, out_keys,
    # out_val, count, scratch, epoch, stream
    "mm_merge": ("merge_maps",
                 [_P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I,
                  _P]),
    # a_keys, a_val, na, b_keys, nb, w, version, floor, cap, out_keys,
    # out_val, count, overflow_in, overflow_out, scratch, epoch, stream
    "mm_merge_writes": ("merge_maps",
                        [_P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                         _P, _P, _I, _P]),
    # keys, m, w, rb, re, rvalid, r, il, ir, stream
    "sw_ranks": ("sweep_ranks", [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P]),
    # ukeys, nr, w, u, urb, ure, stream
    "dd_split": ("read_dedup", [_P, _I, _I, _I, _P, _P, _P]),
    # vmax_u, rank, n, u, vmax, stream
    "dd_gather": ("read_dedup", [_P, _P, _I, _I, _P, _P]),
    # values, m, chunk, nc, table, ns, levels, arrive, op_min, stream
    "rm2_build": ("rangemax2", [_P, _I, _P, _I, _P, _I, _I, _P, _I, _P]),
    # values, m, chunk, nc, table, ns, lo, hi, q, op_min, out, stream
    "rm2_query": ("rangemax2",
                  [_P, _I, _P, _I, _P, _I, _P, _P, _I, _I, _P, _P]),
    # n -> scratch words (no stream: a host query, see size())
    "sf_scratch_words": ("seg_fold", [_I]),
    # wb, we, cw, nw, n, version, seg_ver, scratch, stream
    "sf_fold": ("seg_fold", [_P, _P, _P, _I, _I, _I, _P, _P, _P]),
    # lo, hi, n_shards, w, rb, re, rv, rtxn, gn, nr, wb, we, wv, nw, b,
    # orb, ore, orv, owb, owe, owv, has_reads, stream
    "sc_clip": ("shard_clip",
                [_P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I,
                 _P, _P, _P, _P, _P, _P, _P, _P]),
    # verdict, first, hist, overflow, trip, txn_valid, n_shards, gn, b, nr,
    # out_verdict, out_first, out_hist, out_overflow, trip_any, counts,
    # stream
    "sc_combine": ("shard_combine",
                   [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                    _P, _P, _P]),
    # values, n, lo, hi, q, span, op_min, out, stream
    "ss_range": ("short_span", [_P, _I, _P, _P, _I, _I, _I, _P, _P]),
    # wlo, whi, val, nw, qlo, qhi, nr, span, leaves, flat, cap, out, stream
    "ss_apply": ("short_span",
                 [_P, _P, _P, _I, _P, _P, _I, _I, _I, _P, _I, _P, _P]),
    # n -> tile sums (no stream: a host query, see size())
    "sr_tiles": ("sort_ranks", [_I]),
    # srt, n, w, sums, stream
    "sr_heads": ("sort_ranks", [_P, _I, _I, _P, _P]),
    # srt, perm, n, w, sums, ranks, ukeys, count, stream
    "sr_write": ("sort_ranks", [_P, _P, _I, _I, _P, _P, _P, _P, _P]),
    # values, table, m, levels, op_min, stream
    "rm4_build": ("rangemax_build", [_P, _P, _I, _I, _I, _P]),
    # table, levels, m, lo, hi, q, op_min, out, stream
    "rm4_query": ("rangemax4", [_P, _I, _I, _P, _P, _I, _I, _P, _P]),
    # lo, hi, val, n, leaves, table, stream
    "mc_cover4": ("min_cover", [_P, _P, _P, _I, _I, _P, _P]),
    # n, w -> scratch words (no stream: a host query, see size())
    "lo_scratch_words": ("lex_order", [_I, _I]),
    # rows, n, w, out_rows, out_perm, scratch, stream
    "lo_sort": ("lex_order", [_P, _I, _I, _P, _P, _P, _P]),
}


@dataclasses.dataclass
class KernelInfo:
    """One kernel entry as the launch ledger reports it."""

    name: str
    source: str     # path in the repository
    replaces: str   # file:line of the JAX program it stands in for


#: every kernel entry of the port, in the order the ledger prints them
KERNELS = {
    k.name: k for k in (
        KernelInfo("keysearch.search",
                   "foundationdb_tpu_torch/kernels/csrc/keysearch.cu",
                   "foundationdb_tpu/ops/keys.py:50"),
        KernelInfo("keysearch.counts",
                   "foundationdb_tpu_torch/kernels/csrc/keysearch.cu",
                   "foundationdb_tpu/ops/group.py:105"),
        KernelInfo("keysearch.query",
                   "foundationdb_tpu_torch/kernels/csrc/keysearch.cu",
                   "foundationdb_tpu/ops/rangemax.py:71"),
        KernelInfo("keysearch.probe",
                   "foundationdb_tpu_torch/kernels/csrc/keysearch.cu",
                   "foundationdb_tpu/ops/history.py:77"),
        KernelInfo("rangemax_build",
                   "foundationdb_tpu_torch/kernels/csrc/rangemax_build.cu",
                   "foundationdb_tpu/ops/rangemax.py:30"),
        KernelInfo("min_cover",
                   "foundationdb_tpu_torch/kernels/csrc/min_cover.cu",
                   "foundationdb_tpu/ops/segtree.py:25"),
        KernelInfo("merge_maps",
                   "foundationdb_tpu_torch/kernels/csrc/merge_maps.cu",
                   "foundationdb_tpu/ops/delta.py:378"),
        KernelInfo("sweep_ranks",
                   "foundationdb_tpu_torch/kernels/csrc/sweep_ranks.cu",
                   "foundationdb_tpu/ops/delta.py:172"),
        KernelInfo("read_dedup",
                   "foundationdb_tpu_torch/kernels/csrc/read_dedup.cu",
                   "foundationdb_tpu/ops/delta.py:120"),
        KernelInfo("rangemax2.build",
                   "foundationdb_tpu_torch/kernels/csrc/rangemax2.cu",
                   "foundationdb_tpu/ops/rangemax.py:119"),
        KernelInfo("rangemax2.query",
                   "foundationdb_tpu_torch/kernels/csrc/rangemax2.cu",
                   "foundationdb_tpu/ops/rangemax.py:145"),
        KernelInfo("seg_fold",
                   "foundationdb_tpu_torch/kernels/csrc/seg_fold.cu",
                   "foundationdb_tpu/ops/group.py:588"),
        KernelInfo("shard_clip",
                   "foundationdb_tpu_torch/kernels/csrc/shard_clip.cu",
                   "foundationdb_tpu/parallel/sharding.py:82"),
        KernelInfo("shard_combine",
                   "foundationdb_tpu_torch/kernels/csrc/shard_combine.cu",
                   "foundationdb_tpu/parallel/sharding.py:276"),
        KernelInfo("short_span.range",
                   "foundationdb_tpu_torch/kernels/csrc/short_span.cu",
                   "foundationdb_tpu/ops/group.py:353"),
        KernelInfo("short_span.apply",
                   "foundationdb_tpu_torch/kernels/csrc/short_span.cu",
                   "foundationdb_tpu/ops/group.py:511"),
        KernelInfo("sort_ranks",
                   "foundationdb_tpu_torch/kernels/csrc/sort_ranks.cu",
                   "foundationdb_tpu/ops/keys.py:84"),
        KernelInfo("merge_writes",
                   "foundationdb_tpu_torch/kernels/csrc/merge_maps.cu",
                   "foundationdb_tpu/ops/history.py:114"),
        KernelInfo("rangemax4.build",
                   "foundationdb_tpu_torch/kernels/csrc/rangemax_build.cu",
                   "foundationdb_tpu/ops/rangemax.py:190"),
        KernelInfo("rangemax4.query",
                   "foundationdb_tpu_torch/kernels/csrc/rangemax4.cu",
                   "foundationdb_tpu/ops/rangemax.py:210"),
        KernelInfo("rangemax4.cover",
                   "foundationdb_tpu_torch/kernels/csrc/min_cover.cu",
                   "foundationdb_tpu/ops/segtree.py:79"),
        KernelInfo("lex_order",
                   "foundationdb_tpu_torch/kernels/csrc/lex_order.cu",
                   "foundationdb_tpu/ops/keys.py:103"),
    )
}

#: launches per kernel entry since the last reset_counts()
COUNTS = {name: 0 for name in KERNELS}

_LIBS: dict = {}
_FNS: dict = {}
_LOCK = threading.Lock()
#: the libraries this process built (a load of any other is a hit)
_BUILT: set = set()
_BUILD_STATS = {"cache_hits": 0, "cache_misses": 0,
                "last_compile_seconds": 0.0}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def counts() -> dict:
    return dict(COUNTS)


def build_stats() -> dict:
    """{cache_hits, cache_misses, last_compile_seconds} (see the module
    docstring)."""
    return dict(_BUILD_STATS)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}.{h.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Compile every missing library, one `nvcc` per source, all at once.

    Returns {source: compiler log} for what was built this call (the
    `-Xptxas -v` register and spill report). Raises with the compiler's
    output if any build fails.
    """
    BUILD.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        (BUILD / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
            _BUILT.add(name)
    _BUILD_STATS["cache_misses"] += len(todo) - len(failed)
    _BUILD_STATS["last_compile_seconds"] = time.perf_counter() - t0
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def _fn(entry: str):
    """The ctypes function for a C entry point, building on first use."""
    fn = _FNS.get(entry)
    if fn is not None:
        return fn
    with _LOCK:
        if entry not in _FNS:
            build_all()
            lib_name, argtypes = _SIGNATURES[entry]
            lib = _LIBS.get(lib_name)
            if lib is None:
                lib = _LIBS[lib_name] = ctypes.CDLL(str(_lib_path(lib_name)))
                if lib_name not in _BUILT:
                    _BUILD_STATS["cache_hits"] += 1
            f = getattr(lib, entry)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _FNS[entry] = f
    return _FNS[entry]


def load_all() -> None:
    """Build what is missing and load every library and entry point, so
    the first launch of any kernel costs no build and no dlopen."""
    for entry in _SIGNATURES:
        _fn(entry)


def launch(entry: str, count: str, *args) -> None:
    """Call a C entry point with tensors/ints on the current stream.

    Tensors pass as their data pointer; the stream is appended. `count`
    names the COUNTS slot this launch adds one to (none when the entry
    had nothing to launch).
    """
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    stream = torch.cuda.current_stream(dev).cuda_stream
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
              for a in args]
    with torch.cuda.device(dev):
        err = _fn(entry)(*c_args, stream)
    if err == NO_LAUNCH:
        return
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")
    COUNTS[count] += 1


def size(entry: str, *ints: int) -> int:
    """Call a C entry point that answers a size on the host (no launch,
    no stream, not counted): the kernel's own sizing of its scratch."""
    n = _fn(entry)(*(int(i) for i in ints))
    if n < 0:
        raise RuntimeError(f"{entry}{ints}: invalid size {n}")
    return n


def check_cuda(name: str, *tensors, dtype=torch.int32) -> torch.device:
    """The wrapper contract: every tensor on one CUDA device, contiguous,
    of the kernel's dtype. Returns that device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    return dev


def check_words(name: str, w: int, most: int = MAX_WORDS) -> None:
    if not 1 <= w <= most:
        raise ValueError(
            f"{name}: key width {w} words outside the kernel's 1..{most}"
        )
