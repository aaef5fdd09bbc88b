"""Randomized transaction workload generators for parity tests and benches.

Modeled on the reference's test strategy: randomized range-read/write
transactions cross-checked against a model (the ConflictRange workload,
fdbserver/workloads/ConflictRange.actor.cpp) and the skipListTest
generator's shape (500 batches x 5000 ranges over a bounded keyspace,
fdbserver/SkipList.cpp:1082-1177).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from foundationdb_tpu_torch.models.types import CommitTransaction


def int_key(i: int, width: int = 8) -> bytes:
    """Order-preserving fixed-width integer key (like setK in the
    reference's skipListTest, SkipList.cpp:1015-1028)."""
    return i.to_bytes(width, "big")


@dataclasses.dataclass
class WorkloadConfig:
    n_txns: int = 32
    keyspace: int = 64            # distinct point keys
    max_read_ranges: int = 3
    max_write_ranges: int = 3
    point_fraction: float = 0.6   # point vs range accesses
    blind_write_fraction: float = 0.1
    snapshot_lag: int = 5         # snapshots in [version-lag, version-1]
    stale_fraction: float = 0.0   # txns with snapshots far below the window
    report_fraction: float = 0.5
    zipf: float = 0.0             # 0 = uniform; else zipf exponent
    key_width: int = 8


def _key_index(rng: np.random.Generator, cfg: WorkloadConfig) -> int:
    if cfg.zipf:
        while True:
            k = rng.zipf(cfg.zipf)
            if k <= cfg.keyspace:
                return int(k - 1)
    return int(rng.integers(0, cfg.keyspace))


def _range(rng: np.random.Generator, cfg: WorkloadConfig):
    a = _key_index(rng, cfg)
    if rng.random() < cfg.point_fraction:
        return (int_key(a, cfg.key_width), int_key(a, cfg.key_width) + b"\x00")
    b = _key_index(rng, cfg)
    lo, hi = min(a, b), max(a, b) + 1
    return (int_key(lo, cfg.key_width), int_key(hi, cfg.key_width))


def make_batch(
    rng: np.random.Generator, cfg: WorkloadConfig, version: int, window: int
) -> list[CommitTransaction]:
    txns = []
    for _ in range(cfg.n_txns):
        blind = rng.random() < cfg.blind_write_fraction
        nreads = 0 if blind else int(rng.integers(1, cfg.max_read_ranges + 1))
        nwrites = int(rng.integers(0 if nreads else 1, cfg.max_write_ranges + 1))
        if rng.random() < cfg.stale_fraction:
            snap = version - window - int(rng.integers(1, 100))
        else:
            snap = version - int(rng.integers(1, cfg.snapshot_lag + 1))
        txns.append(
            CommitTransaction(
                read_conflict_ranges=[_range(rng, cfg) for _ in range(nreads)],
                write_conflict_ranges=[_range(rng, cfg) for _ in range(nwrites)],
                read_snapshot=snap,
                report_conflicting_keys=bool(rng.random() < cfg.report_fraction),
            )
        )
    return txns
