"""ctypes bindings for the C++ host libraries (the port's own copy of
`build_shared`, `load`, `load_skiplist`, `NativeConflictSet`,
`NativeSkipListConflictSet`, `load_diskqueue`, `DiskQueue`, `load_vlsm`,
`VlsmError` and `VersionedLsm` from foundationdb_tpu.native).

* `skiplist.cpp` is the skip-list baseline: the reference's own
  algorithm class (fdbserver/SkipList.cpp: per-level max-version
  pyramids, radix point sort, bitset intra-batch sweep). It is the wire
  ResolverRole's `"native"` backend and the CPU baseline the card's
  kernels are measured against.
* `conflict_set.cpp` is the ordered-map semantic model with the same
  verdict contract, an independent parity oracle.
* `diskqueue.cpp` is the durable append log (the role of
  fdbserver/DiskQueue.actor.cpp) behind the TLog role's disk and the
  Storage role's mutation log.
* `vlsm.cpp` is the versioned LSM storage engine behind the Storage
  role's `lsm` engine (data past RAM, MVCC reads at a version).

The sources are byte-identical copies of the JAX package's, so a data
dir one package writes the other opens. Each library is built with `g++`
through a plain C ABI at first use,
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


# ---------------------------------------------------------------------------
# DiskQueue (diskqueue.cpp): the durable append log of the TLog and the
# Storage role's mutation log.

_dq_lib = None


def load_diskqueue() -> ctypes.CDLL:
    """Build (if needed) and load the disk queue."""
    global _dq_lib
    with _lock:
        if _dq_lib is not None:
            return _dq_lib
        lib = ctypes.CDLL(
            build_shared(os.path.join(_DIR, "diskqueue.cpp"), "libdiskqueue")
        )
        lib.dq_open.restype = ctypes.c_void_p
        lib.dq_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_uint64]
        lib.dq_close.argtypes = [ctypes.c_void_p]
        lib.dq_push.restype = ctypes.c_uint64
        lib.dq_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_uint32]
        lib.dq_pop.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.dq_commit.restype = ctypes.c_uint64
        lib.dq_commit.argtypes = [ctypes.c_void_p]
        lib.dq_ok.restype = ctypes.c_int
        lib.dq_ok.argtypes = [ctypes.c_void_p]
        lib.dq_next_seq.restype = ctypes.c_uint64
        lib.dq_next_seq.argtypes = [ctypes.c_void_p]
        lib.dq_pop_floor.restype = ctypes.c_uint64
        lib.dq_pop_floor.argtypes = [ctypes.c_void_p]
        lib.dq_recovered_count.restype = ctypes.c_int64
        lib.dq_recovered_count.argtypes = [ctypes.c_void_p]
        lib.dq_recovered_get.restype = ctypes.c_int64
        lib.dq_recovered_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64),
        ]
        _dq_lib = lib
        return lib


class DiskQueue:
    """Durable append log over a file pair, with a recovery scan.

    The contract (DiskQueue.actor.cpp): push() buffers, commit() makes
    everything pushed durable (fsync), so callers ack only after commit;
    pop(seq) lets the queue discard the records below seq; after a
    crash, `recovered` holds exactly the committed, unpopped records in
    order. Damage inside the log that is not a torn tail refuses the
    open with NativeBuildError.
    """

    def __init__(self, path_prefix: str, *, rotate_bytes: int = 64 << 20):
        lib = load_diskqueue()
        self._lib = lib
        self._q = lib.dq_open(
            (path_prefix + "-0.dq").encode(), (path_prefix + "-1.dq").encode(),
            rotate_bytes,
        )
        if not self._q:
            raise NativeBuildError(f"dq_open failed for {path_prefix}")

    def close(self) -> None:
        if self._q:
            self._lib.dq_close(self._q)
            self._q = None

    def __del__(self):
        self.close()

    def push(self, data: bytes) -> int:
        return self._lib.dq_push(self._q, data, len(data))

    def pop(self, up_to_seq: int) -> None:
        self._lib.dq_pop(self._q, up_to_seq)

    def commit(self):
        """fsync everything pushed. Returns the last durable seq, or
        None if the disk write or fsync failed: callers must not ack."""
        r = self._lib.dq_commit(self._q)
        if not self._lib.dq_ok(self._q):
            return None
        return r

    @property
    def next_seq(self) -> int:
        return self._lib.dq_next_seq(self._q)

    @property
    def pop_floor(self) -> int:
        return self._lib.dq_pop_floor(self._q)

    @property
    def recovered(self) -> list[tuple[int, bytes]]:
        n = self._lib.dq_recovered_count(self._q)
        out = []
        seq = ctypes.c_uint64()
        for i in range(n):
            ln = self._lib.dq_recovered_get(self._q, i, None, 0,
                                            ctypes.byref(seq))
            buf = ctypes.create_string_buffer(max(ln, 1))
            self._lib.dq_recovered_get(self._q, i, buf, ln,
                                       ctypes.byref(seq))
            out.append((seq.value, buf.raw[:ln]))
        return out


# ---------------------------------------------------------------------------
# VersionedLsm (vlsm.cpp): the persistent engine behind the Storage role
# (the role of the reference's Redwood and sqlite engines: data past
# RAM, restart cost in proportion to the WAL tail, MVCC at-version reads).

_VLSM_SRC = os.path.join(_DIR, "vlsm.cpp")
_vlsm_lib = None


def load_vlsm() -> ctypes.CDLL:
    """Build (if needed) and load the versioned LSM."""
    global _vlsm_lib
    with _lock:
        if _vlsm_lib is not None:
            return _vlsm_lib
        lib = ctypes.CDLL(build_shared(_VLSM_SRC, "libvlsm"))
        lib.vlsm_open.restype = ctypes.c_void_p
        lib.vlsm_open.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
        lib.vlsm_ok.argtypes = [ctypes.c_void_p]
        lib.vlsm_close.argtypes = [ctypes.c_void_p]
        for name in ("vlsm_durable_version", "vlsm_applied_version",
                     "vlsm_mem_bytes", "vlsm_floor"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_longlong
            fn.argtypes = [ctypes.c_void_p]
        lib.vlsm_num_runs.argtypes = [ctypes.c_void_p]
        lib.vlsm_last_error.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.vlsm_apply.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_char_p,
            ctypes.c_longlong]
        lib.vlsm_get.restype = ctypes.c_longlong
        lib.vlsm_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
        lib.vlsm_flush.restype = ctypes.c_longlong
        lib.vlsm_flush.argtypes = [ctypes.c_void_p]
        lib.vlsm_compact.argtypes = [ctypes.c_void_p]
        lib.vlsm_set_floor.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        lib.vlsm_range.restype = ctypes.c_longlong
        lib.vlsm_range.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong)]
        _vlsm_lib = lib
        return lib


class VlsmError(RuntimeError):
    pass


class VersionedLsm:
    """Versioned LSM storage engine (vlsm.cpp).

    apply() buffers into the memtable (not durable by itself: pair it
    with a write-ahead log, as StorageRole does); flush() makes every
    applied version durable and returns the durable version; reads are
    at a version within the MVCC window above the GC floor.
    """

    MUT_SET = 0
    MUT_CLEAR_RANGE = 1

    def __init__(self, directory: str, window: int = 5_000_000):
        self._lib = load_vlsm()
        # vlsm.cpp takes no locks and ctypes calls release the GIL: this
        # lock serializes every native call, so the role may read from
        # executor threads while applies stay on the event loop
        self._tl = threading.Lock()
        self._h = self._lib.vlsm_open(
            directory.encode(), ctypes.c_longlong(window))
        if not self._lib.vlsm_ok(self._h):
            raise VlsmError(f"vlsm open failed: {self._error()}")

    def _error(self) -> str:
        buf = ctypes.create_string_buffer(1024)
        self._lib.vlsm_last_error(self._h, buf, 1024)
        return buf.value.decode(errors="replace")

    def close(self) -> None:
        with self._tl:
            if self._h:
                self._lib.vlsm_close(self._h)
                self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- writes ----------------------------------------------------------

    def apply(self, version: int, mutations) -> None:
        """mutations: [(op, key, value_or_end)] with op in
        {MUT_SET, MUT_CLEAR_RANGE}."""
        blob = bytearray(len(mutations).to_bytes(4, "little"))
        for op, key, second in mutations:
            blob.append(op)
            blob += len(key).to_bytes(4, "little")
            blob += key
            blob += len(second).to_bytes(4, "little")
            blob += second
        b = bytes(blob)
        with self._tl:
            rc = self._lib.vlsm_apply(
                self._h, ctypes.c_longlong(version), b, len(b)
            )
        if rc != 0:
            raise VlsmError("malformed mutation blob")

    def flush(self) -> int:
        """Flush the memtable into a durable run; returns the durable
        version (compacts on its own past the run-count trigger)."""
        with self._tl:
            v = self._lib.vlsm_flush(self._h)
        if v < 0:
            raise VlsmError(f"flush failed: {self._error()}")
        return v

    def compact(self) -> None:
        with self._tl:
            rc = self._lib.vlsm_compact(self._h)
        if rc != 0:
            raise VlsmError(f"compact failed: {self._error()}")

    def set_floor(self, floor: int) -> None:
        with self._tl:
            self._lib.vlsm_set_floor(self._h, ctypes.c_longlong(floor))

    # -- reads -----------------------------------------------------------

    def get(self, key: bytes, version: int) -> bytes | None:
        cap = 4096
        while True:
            buf = ctypes.create_string_buffer(cap)
            with self._tl:
                n = self._lib.vlsm_get(
                    self._h, key, len(key), ctypes.c_longlong(version),
                    buf, cap)
            if n == -1:
                return None
            if n < -1:
                cap = -(n + 2) + 1
                continue
            return buf.raw[:n]

    def range(
        self, begin: bytes, end: bytes, version: int,
        max_items: int = 1 << 62,
    ) -> list[tuple[bytes, bytes]]:
        """Merged scan of [begin, end) at `version`; end=b"" scans to
        the last key."""
        cap = 1 << 20
        while True:
            buf = ctypes.create_string_buffer(cap)
            nbytes = ctypes.c_longlong()
            with self._tl:
                n = self._lib.vlsm_range(
                    self._h, begin, len(begin), end, len(end),
                    ctypes.c_longlong(version), ctypes.c_longlong(max_items),
                    buf, cap, ctypes.byref(nbytes))
            if n == -1:
                cap = nbytes.value + 1
                continue
            out = []
            raw = memoryview(buf.raw)
            p = 0
            for _ in range(n):
                kl = int.from_bytes(raw[p:p + 4], "little")
                p += 4
                k = bytes(raw[p:p + kl])
                p += kl
                vl = int.from_bytes(raw[p:p + 4], "little")
                p += 4
                v = bytes(raw[p:p + vl])
                p += vl
                out.append((k, v))
            return out

    # -- introspection ---------------------------------------------------

    @property
    def durable_version(self) -> int:
        with self._tl:
            return self._lib.vlsm_durable_version(self._h)

    @property
    def mem_bytes(self) -> int:
        with self._tl:
            return self._lib.vlsm_mem_bytes(self._h)

    @property
    def num_runs(self) -> int:
        with self._tl:
            return self._lib.vlsm_num_runs(self._h)
