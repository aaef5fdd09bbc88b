"""Vectorized (numpy) PackedBatch generation for large benches (the port's
own copy of foundationdb_tpu.testing.benchgen's skiplist-style generator).

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
