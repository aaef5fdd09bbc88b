"""Host-side batch packing: byte-string conflict ranges -> fixed-shape arrays.

The port's own numpy copy of the packer in foundationdb_tpu.utils.packing,
so both packages hand their kernels byte-identical inputs. Reads and
writes are packed flat (one row per conflict range, with a txn-id
column). Keys are `max_key_bytes/4` big-endian uint32 byte words plus
one length word; comparing rows word by word reproduces FDB's key order
(byte-lexicographic, shorter-before-longer — fdbserver/SkipList.cpp:
123-139). Versions are int32 offsets from a host-held base version.

LAYOUT CONTRACT (relied on by ops/group.resolve_group's per-txn read
windows): within a batch, read and write rows are grouped by txn in
nondecreasing txn order, and padding rows carry txn id == max_txns.

The columnar path (the wire resolver's hop from frame to kernel): a
proxy packs a batch once into flat columns (`pack_columnar`: per-txn
counts, snapshots and flags, and one blob of every key at full length,
in the dtypes of `COLUMNAR_LAYOUT`), and the resolver scatters them
straight into the kernel's arrays (`pack_batch_columnar`, byte-identical
to `pack_batch` on the same transactions) without making one Python
object per transaction. `columnar_to_transactions` rebuilds exact
transactions for the backends that take byte keys (the C++ skip list,
the host oracle).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from foundationdb_tpu_torch.config import KernelConfig

# Version offset used for "far in the past" (clamped stale snapshots).
VERSION_NEG = np.int32(-(2**31) + 1)


def pack_key(key: bytes, max_key_bytes: int, *, round_up: bool = False) -> np.ndarray:
    """bytes -> [W] uint32 (big-endian byte words + length word).

    Keys longer than max_key_bytes degrade conservatively: a truncated
    begin key keeps length == max (sorts at-or-before the original), a
    truncated end key gets length max+1 (sorts after every key with that
    prefix). Ranges only ever expand.
    """
    if len(key) > max_key_bytes:
        length = max_key_bytes + 1 if round_up else max_key_bytes
        key = key[:max_key_bytes]
    else:
        length = len(key)
    padded = key + b"\x00" * (max_key_bytes - len(key))
    words = np.frombuffer(padded, dtype=">u4").astype(np.uint32)
    return np.concatenate([words, np.array([length], np.uint32)])


def pack_keys(
    keys: list[bytes], max_key_bytes: int, *, round_up: bool = False
) -> np.ndarray:
    """[n, W] uint32; vectorized pack_key over a list of byte keys."""
    n = len(keys)
    w = max_key_bytes // 4 + 1
    if n == 0:
        return np.zeros((n, w), np.uint32)
    lens = np.fromiter((len(k) for k in keys), np.int64, count=n)
    cat = np.frombuffer(b"".join(keys), np.uint8)
    return pack_keys_from_blob(
        cat, np.cumsum(lens) - lens, lens, max_key_bytes, round_up=round_up
    )


def pack_keys_from_blob(
    cat: np.ndarray,
    starts: np.ndarray,
    lens: np.ndarray,
    max_key_bytes: int,
    *,
    round_up: bool = False,
) -> np.ndarray:
    """pack_keys over an already-joined key blob: key i occupies
    ``cat[starts[i] : starts[i] + lens[i]]``."""
    n = len(lens)
    w = max_key_bytes // 4 + 1
    out = np.zeros((n, w), np.uint32)
    if n == 0:
        return out
    lens = np.asarray(lens, np.int64)
    starts = np.asarray(starts, np.int64)
    over = lens > max_key_bytes
    kept = np.minimum(lens, max_key_bytes)
    out_lens = np.where(
        over, max_key_bytes + 1 if round_up else max_key_bytes, lens
    )
    buf = np.zeros((n, max_key_bytes), np.uint8)
    rows = np.repeat(np.arange(n), kept)
    offs = np.cumsum(kept) - kept
    cols = np.arange(int(kept.sum())) - np.repeat(offs, kept)
    buf[rows, cols] = cat[np.repeat(starts, kept) + cols]
    out[:, :-1] = buf.view(">u4").astype(np.uint32).reshape(n, w - 1)
    out[:, -1] = out_lens.astype(np.uint32)
    return out


def unpack_key(row: np.ndarray) -> bytes:
    """[W] uint32 -> bytes (inverse of pack_key)."""
    length = int(row[-1])
    raw = np.asarray(row[:-1], np.uint32).astype(">u4").tobytes()
    return raw[:length]


@dataclasses.dataclass
class PackedBatch:
    """One batch of transactions in kernel form (all numpy, host-side).

    Shapes are exactly the KernelConfig caps; `n_txns`/`n_reads`/`n_writes`
    give the live prefix sizes (rows past them are masked invalid).
    """

    version: np.int32
    new_oldest: np.int32
    n_txns: int
    n_reads: int
    n_writes: int
    txn_valid: np.ndarray      # [B] bool
    snapshot: np.ndarray       # [B] int32 version offsets
    has_reads: np.ndarray      # [B] bool — blind writes are never "too old"
    read_begin: np.ndarray     # [NR, W] uint32
    read_end: np.ndarray       # [NR, W] uint32
    read_txn: np.ndarray       # [NR] int32
    read_index: np.ndarray     # [NR] int32 — index of the range within its txn
    read_valid: np.ndarray     # [NR] bool
    write_begin: np.ndarray    # [NW, W] uint32
    write_end: np.ndarray      # [NW, W] uint32
    write_txn: np.ndarray      # [NW] int32
    write_valid: np.ndarray    # [NW] bool

    def device_args(self):
        """The kernel's input dict (drops the host-only counts)."""
        return {
            "version": np.int32(self.version),
            "new_oldest": np.int32(self.new_oldest),
            "txn_valid": self.txn_valid,
            "snapshot": self.snapshot,
            "has_reads": self.has_reads,
            "read_begin": self.read_begin,
            "read_end": self.read_end,
            "read_txn": self.read_txn,
            "read_index": self.read_index,
            "read_valid": self.read_valid,
            "write_begin": self.write_begin,
            "write_end": self.write_end,
            "write_txn": self.write_txn,
            "write_valid": self.write_valid,
        }


def _clamp_version(v: int, base: int) -> np.int32:
    off = v - base
    if off <= int(VERSION_NEG):
        return VERSION_NEG
    if off >= 2**31:
        raise OverflowError(f"version offset {off} overflows int32; rebase")
    return np.int32(off)


def pack_batch(
    transactions,
    version: int,
    base_version: int,
    config: KernelConfig,
) -> PackedBatch:
    """Pack a list of CommitTransaction into kernel arrays.

    `transactions` is any sequence with `.read_conflict_ranges`,
    `.write_conflict_ranges` (lists of (begin, end) byte pairs) and
    `.read_snapshot` (int).
    """
    cfg = config
    b, nr, nw, w = cfg.max_txns, cfg.max_reads, cfg.max_writes, cfg.key_words
    n = len(transactions)
    if n > b:
        raise ValueError(f"{n} txns > max_txns {b}")

    txn_valid = np.zeros((b,), bool)
    snapshot = np.full((b,), VERSION_NEG, np.int32)
    has_reads = np.zeros((b,), bool)
    r_lists = [tr.read_conflict_ranges for tr in transactions]
    w_lists = [tr.write_conflict_ranges for tr in transactions]
    if n:
        txn_valid[:n] = True
        off = np.fromiter(
            (tr.read_snapshot for tr in transactions), np.int64, count=n
        ) - base_version
        high = off >= 2**31
        if high.any():
            bad = int(off[high][0])
            raise OverflowError(f"version offset {bad} overflows int32; rebase")
        snapshot[:n] = np.where(
            off <= int(VERSION_NEG), int(VERSION_NEG), off
        ).astype(np.int32)
        r_counts = np.fromiter((len(x) for x in r_lists), np.int64, count=n)
        w_counts = np.fromiter((len(x) for x in w_lists), np.int64, count=n)
        has_reads[:n] = r_counts > 0
    else:
        r_counts = w_counts = np.zeros((0,), np.int64)

    nread = int(r_counts.sum())
    nwrite = int(w_counts.sum())
    if nread > nr:
        raise ValueError(f"{nread} read ranges > max_reads {nr}")
    if nwrite > nw:
        raise ValueError(f"{nwrite} write ranges > max_writes {nw}")

    r_flat = [rg for lst in r_lists for rg in lst]
    w_flat = [rg for lst in w_lists for rg in lst]
    ids = np.arange(n, dtype=np.int32)
    r_txn = np.repeat(ids, r_counts)
    w_txn = np.repeat(ids, w_counts)
    r_starts = np.concatenate([[0], np.cumsum(r_counts)[:-1]]) if n else r_counts
    r_idx = (np.arange(nread) - np.repeat(r_starts, r_counts)).astype(np.int32)

    def _flat_keys(pairs, cap):
        kb = np.zeros((cap, w), np.uint32)
        ke = np.zeros((cap, w), np.uint32)
        m = len(pairs)
        if m:
            kb[:m] = pack_keys([p[0] for p in pairs], cfg.max_key_bytes)
            ke[:m] = pack_keys(
                [p[1] for p in pairs], cfg.max_key_bytes, round_up=True
            )
        return kb, ke

    rb, re = _flat_keys(r_flat, nr)
    wb, we = _flat_keys(w_flat, nw)

    def _col(vals, cap, dtype=np.int32, fill=0):
        out = np.full((cap,), fill, dtype)
        out[: len(vals)] = vals
        return out

    return PackedBatch(
        version=_clamp_version(version, base_version),
        new_oldest=_clamp_version(version - cfg.window_versions, base_version),
        n_txns=len(transactions),
        n_reads=nread,
        n_writes=nwrite,
        txn_valid=txn_valid,
        snapshot=snapshot,
        has_reads=has_reads,
        read_begin=rb,
        read_end=re,
        read_txn=_col(r_txn, nr, fill=b),
        read_index=_col(r_idx, nr),
        read_valid=_col([True] * nread, nr, bool),
        write_begin=wb,
        write_end=we,
        write_txn=_col(w_txn, nw, fill=b),
        write_valid=_col([True] * nwrite, nw, bool),
    )


# ---------------------------------------------------------------------------
# The columnar resolve batch.

#: The columnar frame's arrays, one constant shared by the wire encoder
#: and decoder (wire/codec.py w_/r_resolve_columnar): every column is a
#: packed little-endian fixed-width vector with no padding, its length
#: from the frame header's (n_txns, n_reads, n_writes). The key blob
#: follows as one u32-length-prefixed slice.
COLUMNAR_LAYOUT = (
    ("snapshots", "<i8", "n_txns"),
    ("read_counts", "<u4", "n_txns"),
    ("write_counts", "<u4", "n_txns"),
    ("flags", "<u1", "n_txns"),
    ("key_lens", "<u4", "n_keys"),  # n_keys = 2*n_reads + 2*n_writes
)

#: flags bit 0: the txn asked for the conflicting-key-range report
COLUMNAR_FLAG_REPORT = 1

#: the key order inside key_lens / key_blob: every read begin key, then
#: the read ends, the write begins and the write ends, four runs, so
#: each kernel column packs with one scatter over its slice of the blob
_KEY_ORDER_DOC = ("read_begin", "read_end", "write_begin", "write_end")


@dataclasses.dataclass
class ColumnarBatch:
    """One resolve batch as flat columns (the host side of the columnar
    wire frame; COLUMNAR_LAYOUT gives the wire dtypes).

    Versions are absolute (the proxy does not know the resolver's
    rebase base). Keys are carried at full length in the blob: only the
    kernel packer truncates, so the object fallback sees exact bytes.
    """

    n_txns: int
    n_reads: int               # sum(read_counts), checked on decode
    n_writes: int              # sum(write_counts)
    snapshots: np.ndarray      # <i8 [n_txns] absolute read_snapshot
    read_counts: np.ndarray    # <u4 [n_txns]
    write_counts: np.ndarray   # <u4 [n_txns]
    flags: np.ndarray          # <u1 [n_txns] (COLUMNAR_FLAG_REPORT)
    key_lens: np.ndarray       # <u4 [2*n_reads + 2*n_writes], key order
    key_blob: Any              # bytes | memoryview, sum(key_lens) bytes

    def __eq__(self, other):
        if not isinstance(other, ColumnarBatch):
            return NotImplemented
        return (
            self.n_txns == other.n_txns
            and self.n_reads == other.n_reads
            and self.n_writes == other.n_writes
            and np.array_equal(self.snapshots, other.snapshots)
            and np.array_equal(self.read_counts, other.read_counts)
            and np.array_equal(self.write_counts, other.write_counts)
            and np.array_equal(self.flags, other.flags)
            and np.array_equal(self.key_lens, other.key_lens)
            and bytes(self.key_blob) == bytes(other.key_blob)
        )


def pack_columnar(transactions) -> ColumnarBatch:
    """The proxy's pack: CommitTransaction list -> flat columns, once a
    batch (one bytes join for the keys, bulk numpy for the rest)."""
    n = len(transactions)
    r_lists = [t.read_conflict_ranges for t in transactions]
    w_lists = [t.write_conflict_ranges for t in transactions]
    if n:
        read_counts = np.fromiter(
            (len(x) for x in r_lists), np.uint32, count=n
        )
        write_counts = np.fromiter(
            (len(x) for x in w_lists), np.uint32, count=n
        )
        snapshots = np.fromiter(
            (t.read_snapshot for t in transactions), np.int64, count=n
        )
        flags = np.fromiter(
            (
                COLUMNAR_FLAG_REPORT if t.report_conflicting_keys else 0
                for t in transactions
            ),
            np.uint8,
            count=n,
        )
    else:
        read_counts = write_counts = np.zeros((0,), np.uint32)
        snapshots = np.zeros((0,), np.int64)
        flags = np.zeros((0,), np.uint8)
    keys: list[bytes] = []
    for lists, side in ((r_lists, 0), (r_lists, 1), (w_lists, 0), (w_lists, 1)):
        keys.extend(rg[side] for lst in lists for rg in lst)
    nread, nwrite = int(read_counts.sum()), int(write_counts.sum())
    key_lens = (
        np.fromiter((len(k) for k in keys), np.uint32, count=len(keys))
        if keys
        else np.zeros((0,), np.uint32)
    )
    return ColumnarBatch(
        n_txns=n,
        n_reads=nread,
        n_writes=nwrite,
        snapshots=snapshots,
        read_counts=read_counts,
        write_counts=write_counts,
        flags=flags,
        key_lens=key_lens,
        key_blob=b"".join(keys),
    )


def pack_batch_columnar(
    cols: ColumnarBatch,
    version: int,
    base_version: int,
    config: KernelConfig,
) -> PackedBatch:
    """The columnar twin of pack_batch: flat columns -> kernel arrays.

    Byte-identical to ``pack_batch(txns, ...)`` whenever
    ``cols == pack_columnar(txns)``: the per-txn columns come from the
    same repeat/cumsum formulas and the key matrices from the same
    pack_keys_from_blob scatter. No per-transaction objects are made.
    """
    cfg = config
    b, nr, nw, w = cfg.max_txns, cfg.max_reads, cfg.max_writes, cfg.key_words
    n = cols.n_txns
    if n > b:
        raise ValueError(f"{n} txns > max_txns {b}")

    txn_valid = np.zeros((b,), bool)
    snapshot = np.full((b,), VERSION_NEG, np.int32)
    has_reads = np.zeros((b,), bool)
    if n:
        txn_valid[:n] = True
        off = cols.snapshots.astype(np.int64) - base_version
        high = off >= 2**31
        if high.any():
            bad = int(off[high][0])
            raise OverflowError(f"version offset {bad} overflows int32; rebase")
        snapshot[:n] = np.where(
            off <= int(VERSION_NEG), int(VERSION_NEG), off
        ).astype(np.int32)
        r_counts = cols.read_counts.astype(np.int64)
        w_counts = cols.write_counts.astype(np.int64)
        has_reads[:n] = r_counts > 0
    else:
        r_counts = w_counts = np.zeros((0,), np.int64)

    nread = int(r_counts.sum())
    nwrite = int(w_counts.sum())
    if nread > nr:
        raise ValueError(f"{nread} read ranges > max_reads {nr}")
    if nwrite > nw:
        raise ValueError(f"{nwrite} write ranges > max_writes {nw}")

    ids = np.arange(n, dtype=np.int32)
    r_txn = np.repeat(ids, r_counts)
    w_txn = np.repeat(ids, w_counts)
    r_starts = np.cumsum(r_counts) - r_counts if n else r_counts
    r_idx = (np.arange(nread) - np.repeat(r_starts, r_counts)).astype(np.int32)

    cat = np.frombuffer(cols.key_blob, np.uint8)
    lens = np.asarray(cols.key_lens, np.int64)
    starts = np.cumsum(lens) - lens

    def _col_keys(lo, m, cap, round_up):
        out = np.zeros((cap, w), np.uint32)
        if m:
            out[:m] = pack_keys_from_blob(
                cat, starts[lo : lo + m], lens[lo : lo + m],
                cfg.max_key_bytes, round_up=round_up,
            )
        return out

    rb = _col_keys(0, nread, nr, False)
    re = _col_keys(nread, nread, nr, True)
    wb = _col_keys(2 * nread, nwrite, nw, False)
    we = _col_keys(2 * nread + nwrite, nwrite, nw, True)

    def _col(vals, cap, dtype=np.int32, fill=0):
        out = np.full((cap,), fill, dtype)
        out[: len(vals)] = vals
        return out

    return PackedBatch(
        version=_clamp_version(version, base_version),
        new_oldest=_clamp_version(version - cfg.window_versions, base_version),
        n_txns=n,
        n_reads=nread,
        n_writes=nwrite,
        txn_valid=txn_valid,
        snapshot=snapshot,
        has_reads=has_reads,
        read_begin=rb,
        read_end=re,
        read_txn=_col(r_txn, nr, fill=b),
        read_index=_col(r_idx, nr),
        read_valid=_col([True] * nread, nr, bool),
        write_begin=wb,
        write_end=we,
        write_txn=_col(w_txn, nw, fill=b),
        write_valid=_col([True] * nwrite, nw, bool),
    )


def columnar_key(cols: ColumnarBatch, index: int) -> bytes:
    """Key `index` (in the blob's key order) sliced out of the blob: the
    conflicting-key report reads only the rows the kernel flagged."""
    lens = cols.key_lens
    start = int(np.asarray(lens[:index], np.int64).sum())
    return bytes(
        memoryview(cols.key_blob)[start : start + int(lens[index])]
    )


def columnar_to_transactions(cols: ColumnarBatch) -> list:
    """Columnar frame -> per-txn CommitTransaction objects: the object
    fallback for the backends that take byte keys (the C++ skip list,
    the host oracle). The keys are exact, so their decisions match the
    object wire path's."""
    from foundationdb_tpu_torch.models.types import CommitTransaction

    lens = np.asarray(cols.key_lens, np.int64)
    ends = np.cumsum(lens)
    starts = ends - lens
    view = memoryview(cols.key_blob)
    keys = [bytes(view[s:e]) for s, e in zip(starts, ends)]
    nread, nwrite = cols.n_reads, cols.n_writes
    rb, re_ = keys[:nread], keys[nread : 2 * nread]
    wb = keys[2 * nread : 2 * nread + nwrite]
    we = keys[2 * nread + nwrite :]
    out = []
    ri = wi = 0
    for t in range(cols.n_txns):
        rc = int(cols.read_counts[t])
        wc = int(cols.write_counts[t])
        out.append(
            CommitTransaction(
                read_conflict_ranges=list(
                    zip(rb[ri : ri + rc], re_[ri : ri + rc])
                ),
                write_conflict_ranges=list(
                    zip(wb[wi : wi + wc], we[wi : wi + wc])
                ),
                read_snapshot=int(cols.snapshots[t]),
                report_conflicting_keys=bool(
                    int(cols.flags[t]) & COLUMNAR_FLAG_REPORT
                ),
            )
        )
        ri += rc
        wi += wc
    return out


def group_args(batches) -> list:
    """The device_args of PackedBatches to be stacked into one group;
    raises ValueError unless their versions ascend."""
    args = [b.device_args() for b in batches]
    versions = [int(a["version"]) for a in args]
    if any(b <= a for a, b in zip(versions, versions[1:])):
        raise ValueError(f"stacked batch versions must ascend: {versions}")
    return args


def stack_device_args(batches) -> dict:
    """Stack PackedBatch device_args along a new leading axis (the input
    contract of the group entry points). Versions must ascend."""
    args = group_args(batches)
    return {k: np.stack([a[k] for a in args]) for k in args[0]}
