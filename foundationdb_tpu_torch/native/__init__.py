"""ctypes bindings for the C++ CPU conflict sets (the port's own copy of
`build_shared`, `load`, `load_skiplist`, `NativeConflictSet` and
`NativeSkipListConflictSet` from foundationdb_tpu.native).

* `skiplist.cpp` is the skip-list baseline: the reference's own
  algorithm class (fdbserver/SkipList.cpp: per-level max-version
  pyramids, radix point sort, bitset intra-batch sweep). It is the wire
  ResolverRole's `"native"` backend and the CPU baseline the card's
  kernels are measured against.
* `conflict_set.cpp` is the ordered-map semantic model with the same
  verdict contract, an independent parity oracle.

Each library is built with `g++` through a plain C ABI at first use,
never at import, into `native/build/` (git-ignored) under a file name
that carries a hash of its source and flags, so an edited source is
never served from a stale library. Two processes building at once race
safely: each writes a per-pid temporary file and renames it into place. A failed
build raises NativeBuildError; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(_DIR, "build")
_SRC = os.path.join(_DIR, "conflict_set.cpp")
_SL_SRC = os.path.join(_DIR, "skiplist.cpp")
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_sl_lib = None


class NativeBuildError(RuntimeError):
    pass


def build_shared(src: str, stem: str) -> str:
    """Compile `src` into a hash-named shared library under BUILD and
    return its path (built once per source and flags)."""
    with open(src, "rb") as f:
        hasher = hashlib.sha256(f.read())
    hasher.update(" ".join(FLAGS).encode())
    out = os.path.join(BUILD, f"{stem}-{hasher.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD, exist_ok=True)
    tmp = out + f".tmp{os.getpid()}"
    try:
        proc = subprocess.run(["g++", *FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError(f"g++ could not run: {e}") from None
    if proc.returncode != 0:
        raise NativeBuildError(f"g++ failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


_RESOLVE_ARGS = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int32,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int32, ctypes.c_void_p,
]


def _bind(path: str, prefix: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    getattr(lib, f"{prefix}_create").restype = ctypes.c_void_p
    getattr(lib, f"{prefix}_create").argtypes = [ctypes.c_int64]
    getattr(lib, f"{prefix}_destroy").argtypes = [ctypes.c_void_p]
    getattr(lib, f"{prefix}_resolve").argtypes = _RESOLVE_ARGS
    getattr(lib, f"{prefix}_history_size").restype = ctypes.c_int64
    getattr(lib, f"{prefix}_history_size").argtypes = [ctypes.c_void_p]
    return lib


def load() -> ctypes.CDLL:
    """Build (if not yet built for this source hash) and load the
    ordered-map conflict set."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(build_shared(_SRC, "libconflict"), "cs")
        return _lib


def load_skiplist() -> ctypes.CDLL:
    """Build (if needed) and load the skip-list baseline."""
    global _sl_lib
    with _lock:
        if _sl_lib is None:
            _sl_lib = _bind(build_shared(_SL_SRC, "libskiplist"), "slcs")
        return _sl_lib


def _flatten(ranges_per_txn):
    """[(txn, begin, end)] -> (key blob, offsets[2n+1], txn ids[n])."""
    keys = bytearray()
    offsets = [0]
    txn_ids = []
    for t, b, e in ranges_per_txn:
        keys.extend(b)
        offsets.append(len(keys))
        keys.extend(e)
        offsets.append(len(keys))
        txn_ids.append(t)
    return (
        np.frombuffer(bytes(keys), np.uint8) if keys else np.zeros(0, np.uint8),
        np.asarray(offsets, np.int64),
        np.asarray(txn_ids, np.int32),
    )


class NativeConflictSet:
    """CPU conflict set with the ConflictBatch verdict contract (the
    ordered-map model)."""

    _PREFIX = "cs"

    def __init__(self, window: int = 5_000_000):
        self._lib = self._load()
        p = self._PREFIX
        self._create = getattr(self._lib, f"{p}_create")
        self._destroy = getattr(self._lib, f"{p}_destroy")
        self._resolve = getattr(self._lib, f"{p}_resolve")
        self._size = getattr(self._lib, f"{p}_history_size")
        self._cs = self._create(window)

    @staticmethod
    def _load() -> ctypes.CDLL:
        return load()

    def __del__(self):
        if getattr(self, "_cs", None):
            self._destroy(self._cs)
            self._cs = None

    def resolve(self, transactions, version: int) -> np.ndarray:
        """transactions: CommitTransaction-shaped objects. Returns [n]
        int32 verdicts (0 = conflict, 1 = too old, 3 = committed)."""
        n = len(transactions)
        snapshots = np.asarray(
            [t.read_snapshot for t in transactions], np.int64
        )
        reads = [
            (t, b, e)
            for t, tr in enumerate(transactions)
            for b, e in tr.read_conflict_ranges
        ]
        writes = [
            (t, b, e)
            for t, tr in enumerate(transactions)
            for b, e in tr.write_conflict_ranges
        ]
        rkeys, roff, rtxn = _flatten(reads)
        wkeys, woff, wtxn = _flatten(writes)
        return self.resolve_raw(version, snapshots, rkeys, roff, rtxn,
                                wkeys, woff, wtxn)

    def resolve_raw(
        self,
        version: int,
        snapshots: np.ndarray,   # [n] int64
        rkeys: np.ndarray,       # uint8 blob: begin_i/end_i interleaved
        roff: np.ndarray,        # [2*n_reads+1] int64 offsets into rkeys
        rtxn: np.ndarray,        # [n_reads] int32
        wkeys: np.ndarray,
        woff: np.ndarray,
        wtxn: np.ndarray,
    ) -> np.ndarray:
        """The path for batches already flattened (a bench's hot loop)."""
        n = snapshots.shape[0]
        verdict = np.zeros(n, np.int32)
        c = ctypes.c_void_p
        snap, rk, ro, rt, wk, wo, wt = (
            np.ascontiguousarray(a, dt) for a, dt in (
                (snapshots, np.int64), (rkeys, np.uint8), (roff, np.int64),
                (rtxn, np.int32), (wkeys, np.uint8), (woff, np.int64),
                (wtxn, np.int32)))
        self._resolve(
            self._cs, version, n,
            snap.ctypes.data_as(c),
            rk.ctypes.data_as(c), ro.ctypes.data_as(c),
            rt.ctypes.data_as(c), len(rt),
            wk.ctypes.data_as(c), wo.ctypes.data_as(c),
            wt.ctypes.data_as(c), len(wt),
            verdict.ctypes.data_as(c),
        )
        return verdict

    @property
    def history_size(self) -> int:
        return self._size(self._cs)


class NativeSkipListConflictSet(NativeConflictSet):
    """The skip-list CPU baseline (skiplist.cpp): the same contract and
    verdicts, the reference's algorithm class instead of the ordered-map
    model."""

    _PREFIX = "slcs"

    @staticmethod
    def _load() -> ctypes.CDLL:
        return load_skiplist()
