"""Vectorized (numpy) PackedBatch generation for large benches (the port's
own copy of foundationdb_tpu.testing.benchgen's skiplist-style and YCSB
letter generators, array for array the same from the same seed).

The bench shapes mirror the reference's skipListTest generator
(fdbserver/SkipList.cpp:1082-1177): per transaction one read range and
one write range of consecutive int keys over a bounded keyspace (its
"4 keys/txn"), snapshots trailing the commit version. Building 64K
CommitTransaction objects through the Python packer would dominate the
measurement, so this generates the packed tensors directly.
"""

from __future__ import annotations

import numpy as np

from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.utils.packing import PackedBatch


def int_keys_packed(idx: np.ndarray, key_bytes: int, key_words: int) -> np.ndarray:
    """[N] int64 -> [N, W] packed big-endian keys of width key_bytes."""
    n = idx.shape[0]
    out = np.zeros((n, key_words), np.uint32)
    be = idx.astype(">u8").view(np.uint8).reshape(n, 8)[:, 8 - key_bytes:]
    pad = np.zeros((n, key_words * 4 - 4 - key_bytes), np.uint8)
    words = np.concatenate([be, pad], axis=1).view(">u4").astype(np.uint32)
    out[:, :-1] = words
    out[:, -1] = key_bytes
    return out


def zipf_draw(rng: np.random.Generator, n: int, zipf: float,
              keyspace: int) -> np.ndarray:
    """[n] int64 zipf-distributed keys < keyspace (rejection-sampled
    refill) — the one sampling helper both batch generators share."""
    k = rng.zipf(zipf, size=2 * n) - 1
    k = k[k < keyspace][:n]
    while k.shape[0] < n:
        extra = rng.zipf(zipf, size=n) - 1
        k = np.concatenate([k, extra[extra < keyspace]])[:n]
    return k.astype(np.int64)


def skiplist_style_batch(
    rng: np.random.Generator,
    config: KernelConfig,
    n_txns: int,
    *,
    version: int,
    keyspace: int = 1_000_000,
    range_len: int = 1,
    snapshot_lag: int = 50,
    key_bytes: int = 8,
    zipf: float = 0.0,
) -> PackedBatch:
    """One batch: n_txns transactions x (1 read range + 1 write range)."""
    b, nr, nw, w = (
        config.max_txns,
        config.max_reads,
        config.max_writes,
        config.key_words,
    )
    assert n_txns <= b and n_txns <= nr and n_txns <= nw

    def draw(n):
        if zipf:
            return zipf_draw(rng, n, zipf, keyspace)
        return rng.integers(0, keyspace, size=n, dtype=np.int64)

    rbeg = draw(n_txns)
    wbeg = draw(n_txns)
    rend = np.minimum(rbeg + range_len, keyspace) + 1
    wend = np.minimum(wbeg + range_len, keyspace) + 1

    def fill_keys(cap, begins, ends):
        kb = np.zeros((cap, w), np.uint32)
        ke = np.zeros((cap, w), np.uint32)
        kb[:n_txns] = int_keys_packed(begins, key_bytes, w)
        ke[:n_txns] = int_keys_packed(ends, key_bytes, w)
        return kb, ke

    read_begin, read_end = fill_keys(nr, rbeg, rend)
    write_begin, write_end = fill_keys(nw, wbeg, wend)

    txn_valid = np.zeros((b,), bool)
    txn_valid[:n_txns] = True
    snapshot = np.zeros((b,), np.int32)
    snapshot[:n_txns] = version - rng.integers(
        1, snapshot_lag + 1, size=n_txns, dtype=np.int64
    )
    has_reads = txn_valid.copy()

    # padding rows carry txn id == b: the kernel's per-txn cumsum
    # windows need the flat segment id monotone (packing.pack_batch's
    # layout contract)
    iota_r = np.full((nr,), b, np.int32)
    iota_r[:n_txns] = np.arange(n_txns, dtype=np.int32)
    iota_w = np.full((nw,), b, np.int32)
    iota_w[:n_txns] = np.arange(n_txns, dtype=np.int32)
    rvalid = np.zeros((nr,), bool)
    rvalid[:n_txns] = True
    wvalid = np.zeros((nw,), bool)
    wvalid[:n_txns] = True

    return PackedBatch(
        version=np.int32(version),
        new_oldest=np.int32(version - config.window_versions),
        n_txns=n_txns,
        n_reads=n_txns,
        n_writes=n_txns,
        txn_valid=txn_valid,
        snapshot=snapshot,
        has_reads=has_reads,
        read_begin=read_begin,
        read_end=read_end,
        read_txn=iota_r,
        read_index=np.zeros((nr,), np.int32),
        read_valid=rvalid,
        write_begin=write_begin,
        write_end=write_end,
        write_txn=iota_w,
        write_valid=wvalid,
    )


#: YCSB letter-suite op mixes (Cooper et al.; the reference's canonical
#: workload vocabulary). Mapped onto conflict-resolution shapes: a
#: "read" is a read conflict range, an "update"/"insert" a point write
#: range, a "scan" a multi-key read range. A is the existing zipf
#: config's shape (50/50 point read/update); B/C/D/E below widen the
#: ensemble — E is the range-scan-heavy profile (wide scans, fresh
#: inserts) that the endpoint sweep keeps on the device.
YCSB_MIXES = {
    # letter: (read_prob, scan_prob, write_prob per txn)
    "ycsb_b": (1.0, 0.0, 0.05),   # 95% read / 5% update, zipf points
    "ycsb_c": (1.0, 0.0, 0.0),    # read-only, zipf points
    "ycsb_d": (1.0, 0.0, 0.05),   # read-latest (insert frontier)
    "ycsb_e": (0.0, 0.95, 1.0),   # short scans + inserts
}


def ycsb_batch(
    rng: np.random.Generator,
    config: KernelConfig,
    n_txns: int,
    letter: str,
    *,
    version: int,
    keyspace: int = 1_000_000,
    zipf: float = 1.1,
    scan_max: int = 100,
    snapshot_lag: int = 50,
    key_bytes: int = 8,
    insert_frontier: int = 0,
) -> PackedBatch:
    """One YCSB-lettered batch: per-txn op drawn from YCSB_MIXES.

    Valid read/write rows pack CONTIGUOUSLY in txn order (the packing
    layout contract — rows grouped by txn, ids nondecreasing, padding
    rows carry txn id == B), so the batch drives the kernel, the native
    baselines (flatten_for_native) and the profile classifiers alike.
    ycsb_d draws read keys exponentially behind `insert_frontier` (the
    read-latest distribution); pass the running insert count across
    batches for the moving frontier.
    """
    if letter not in YCSB_MIXES:
        raise ValueError(f"unknown YCSB letter {letter!r}")
    read_p, scan_p, write_p = YCSB_MIXES[letter]
    b, nr, nw, w = (
        config.max_txns, config.max_reads, config.max_writes,
        config.key_words,
    )
    assert n_txns <= b and n_txns <= nr and n_txns <= nw

    def zdraw(n):
        return zipf_draw(rng, n, zipf, keyspace)

    if letter == "ycsb_d":
        # read-latest: exponential offsets behind the insert frontier
        frontier = max(1, insert_frontier or keyspace // 2)
        off = rng.exponential(scale=frontier / 50.0, size=n_txns)
        rbeg = np.maximum(0, frontier - 1 - off.astype(np.int64))
    else:
        rbeg = zdraw(n_txns)

    scans = rng.random(n_txns) < scan_p
    has_read = scans | (rng.random(n_txns) < read_p)
    writes = rng.random(n_txns) < write_p
    # contiguous valid rows in txn order
    r_rows = np.flatnonzero(has_read)
    w_rows = np.flatnonzero(writes)
    # every txn does SOMETHING: a no-op row degrades to a blind no-range
    # txn the kernel trivially commits — keep it, YCSB target counts ops
    scan_len = np.where(
        scans, rng.integers(1, scan_max + 1, size=n_txns), 1
    ).astype(np.int64)
    rend = np.minimum(rbeg + scan_len, keyspace) + 1
    wbeg = np.zeros(n_txns, np.int64)
    if letter == "ycsb_d":
        # inserts are CONSECUTIVE fresh keys: the k-th WRITING txn of
        # this batch inserts frontier+k, so the caller's
        # `frontier += n_writes` advances over exactly the inserted
        # keys and the read-latest draw targets keys that truly exist
        # (assigning frontier+txn_index left ~(1-write_p) gaps that
        # were never inserted, and overlapping windows across batches)
        wbeg[w_rows] = insert_frontier + np.arange(len(w_rows))
    elif letter == "ycsb_e":
        # E's writes are INSERTS of fresh records (uniform new keys),
        # not zipf updates — a zipf write pool would classify the
        # stream hot_key before the scan spans are even considered
        wbeg = rng.integers(0, keyspace, size=n_txns, dtype=np.int64)
    else:
        wbeg = zdraw(n_txns)
    wend = np.minimum(wbeg + 1, keyspace) + 1
    read_begin = np.zeros((nr, w), np.uint32)
    read_end = np.zeros((nr, w), np.uint32)
    write_begin = np.zeros((nw, w), np.uint32)
    write_end = np.zeros((nw, w), np.uint32)
    read_begin[: len(r_rows)] = int_keys_packed(rbeg[r_rows], key_bytes, w)
    read_end[: len(r_rows)] = int_keys_packed(rend[r_rows], key_bytes, w)
    write_begin[: len(w_rows)] = int_keys_packed(wbeg[w_rows], key_bytes, w)
    write_end[: len(w_rows)] = int_keys_packed(wend[w_rows], key_bytes, w)

    txn_valid = np.zeros((b,), bool)
    txn_valid[:n_txns] = True
    snapshot = np.zeros((b,), np.int32)
    snapshot[:n_txns] = version - rng.integers(
        1, snapshot_lag + 1, size=n_txns, dtype=np.int64
    )
    has_reads = np.zeros((b,), bool)
    has_reads[:n_txns] = has_read

    iota_r = np.full((nr,), b, np.int32)
    iota_r[: len(r_rows)] = r_rows.astype(np.int32)
    iota_w = np.full((nw,), b, np.int32)
    iota_w[: len(w_rows)] = w_rows.astype(np.int32)
    rvalid = np.zeros((nr,), bool)
    rvalid[: len(r_rows)] = True
    wvalid = np.zeros((nw,), bool)
    wvalid[: len(w_rows)] = True

    return PackedBatch(
        version=np.int32(version),
        new_oldest=np.int32(version - config.window_versions),
        n_txns=n_txns,
        n_reads=len(r_rows),
        n_writes=len(w_rows),
        txn_valid=txn_valid,
        snapshot=snapshot,
        has_reads=has_reads,
        read_begin=read_begin,
        read_end=read_end,
        read_txn=iota_r,
        read_index=np.zeros((nr,), np.int32),
        read_valid=rvalid,
        write_begin=write_begin,
        write_end=write_end,
        write_txn=iota_w,
        write_valid=wvalid,
    )
