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
"""

from __future__ import annotations

import dataclasses

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
