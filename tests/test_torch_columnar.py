"""The port's columnar path, held against the JAX package on the CPU.

* `pack_columnar` equals the JAX one, and `pack_batch_columnar` equals
  the port's `pack_batch` and the JAX `pack_batch_columnar` array by
  array (values and dtypes), on seeded transactions with empty txns,
  blind writes, report flags, keys over `max_key_bytes` and 0-byte
  keys; `columnar_to_transactions` rebuilds the exact transactions and
  `columnar_key` slices every key in the blob's order.
* `TorchConflictSet(device="cpu").resolve_columnar` against the JAX
  `TpuConflictSet.resolve_columnar` on the JAX CPU and against the
  port's own object `resolve` on a second set, on five configurations
  (tiered exact, latch + read dedup, endpoint sweep + delta spill,
  classic, 2 shards): the same verdicts and conflicting-key reports
  batch by batch, and `columnarBatches` counts every columnar batch.

The tolerance is equality throughout: every compared value is an
integer, a bool or a byte string.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from foundationdb_tpu.config import KernelConfig as JaxConfig
from foundationdb_tpu.models import conflict_set as JCS
from foundationdb_tpu.models.types import CommitTransaction as JaxTxn
from foundationdb_tpu.parallel.mesh import cpu_mesh
from foundationdb_tpu.utils import packing as jax_packing
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.models import conflict_set as PCS
from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import packing

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

COL_FIELDS = ("snapshots", "read_counts", "write_counts", "flags",
              "key_lens")


def rand_key(rng, max_len: int) -> bytes:
    """A key of 0 .. max_len bytes over a small alphabet (so ranges
    overlap), a 0-byte key now and then."""
    n = int(rng.integers(0, max_len + 1))
    return bytes(rng.integers(0, 4, size=n, dtype=np.uint8))


def rand_txns(rng, n: int, max_key_bytes: int, base: int = 1000):
    """Seeded transactions: empty ones, blind writes, report flags, keys
    up to max_key_bytes + 6 bytes (longer than the packer keeps)."""
    out = []
    for t in range(n):
        kind = int(rng.integers(0, 6))
        reads, writes = [], []
        if kind != 0:  # kind 0: the empty transaction
            if kind != 1:  # kind 1: a blind write
                for _ in range(int(rng.integers(0, 4))):
                    a = rand_key(rng, max_key_bytes + 6)
                    b = rand_key(rng, max_key_bytes + 6)
                    reads.append((min(a, b), max(a, b) + b"\x00"))
            for _ in range(int(rng.integers(0 if kind > 1 else 1, 3))):
                a = rand_key(rng, max_key_bytes + 6)
                writes.append((a, a + b"\x00"))
        out.append(CommitTransaction(
            read_conflict_ranges=reads, write_conflict_ranges=writes,
            read_snapshot=base - int(rng.integers(0, 3000)),
            report_conflicting_keys=bool(rng.integers(0, 2))))
    return out


def to_jax(txns):
    return [JaxTxn(read_conflict_ranges=list(t.read_conflict_ranges),
                   write_conflict_ranges=list(t.write_conflict_ranges),
                   read_snapshot=t.read_snapshot,
                   report_conflicting_keys=t.report_conflicting_keys)
            for t in txns]


def assert_same_columns(a, b):
    assert (a.n_txns, a.n_reads, a.n_writes) == (b.n_txns, b.n_reads,
                                                 b.n_writes)
    for f in COL_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        assert va.dtype == vb.dtype and np.array_equal(va, vb), f
    assert bytes(a.key_blob) == bytes(b.key_blob)


def assert_same_packed(a, b, tag):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), (
                tag, f.name)
        else:
            assert va == vb, (tag, f.name)


@pytest.mark.parametrize("max_key_bytes", [4, 8, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_columnar_equals_jax_and_pack_batch(seed, max_key_bytes):
    rng = np.random.default_rng(seed)
    txns = rand_txns(rng, 48, max_key_bytes)
    assert any(not t.read_conflict_ranges and not t.write_conflict_ranges
               for t in txns)
    assert any(len(k) > max_key_bytes for t in txns
               for r in t.read_conflict_ranges + t.write_conflict_ranges
               for k in r)
    cols = packing.pack_columnar(txns)
    jcols = jax_packing.pack_columnar(to_jax(txns))
    assert_same_columns(cols, jcols)
    cfg = KernelConfig(max_key_bytes=max_key_bytes, max_txns=64,
                       max_reads=256, max_writes=256)
    jcfg = JaxConfig(max_key_bytes=max_key_bytes, max_txns=64,
                     max_reads=256, max_writes=256)
    for version, base in ((5000, 0), (5000, 4000), (2**31 + 10, 2**31)):
        got = packing.pack_batch_columnar(cols, version, base, cfg)
        assert_same_packed(got, packing.pack_batch(txns, version, base, cfg),
                           "pack_batch")
        want = jax_packing.pack_batch_columnar(jcols, version, base, jcfg)
        assert_same_packed(got, want, "jax pack_batch_columnar")


@pytest.mark.parametrize("seed", [3, 4])
def test_columnar_round_trip_and_keys(seed):
    rng = np.random.default_rng(seed)
    txns = rand_txns(rng, 40, 8)
    cols = packing.pack_columnar(txns)
    back = packing.columnar_to_transactions(cols)
    assert len(back) == len(txns)
    for a, b in zip(txns, back):
        assert a.read_conflict_ranges == b.read_conflict_ranges
        assert a.write_conflict_ranges == b.write_conflict_ranges
        assert a.read_snapshot == b.read_snapshot
        assert a.report_conflicting_keys == b.report_conflicting_keys
    keys = ([r[0] for t in txns for r in t.read_conflict_ranges]
            + [r[1] for t in txns for r in t.read_conflict_ranges]
            + [r[0] for t in txns for r in t.write_conflict_ranges]
            + [r[1] for t in txns for r in t.write_conflict_ranges])
    jcols = jax_packing.pack_columnar(to_jax(txns))
    for i, k in enumerate(keys):
        assert packing.columnar_key(cols, i) == k
        assert jax_packing.columnar_key(jcols, i) == k


def test_columnar_empty_batch():
    cols = packing.pack_columnar([])
    assert_same_columns(cols, jax_packing.pack_columnar([]))
    cfg = KernelConfig(max_key_bytes=8, max_txns=4, max_reads=4,
                       max_writes=4)
    assert_same_packed(packing.pack_batch_columnar(cols, 10, 0, cfg),
                       packing.pack_batch([], 10, 0, cfg), "empty")
    assert packing.columnar_to_transactions(cols) == []


def test_columnar_refuses_what_pack_batch_refuses():
    cfg = KernelConfig(max_key_bytes=8, max_txns=2, max_reads=2,
                       max_writes=2)
    three = [CommitTransaction(write_conflict_ranges=[(b"a", b"b")])] * 3
    with pytest.raises(ValueError, match="max_txns"):
        packing.pack_batch_columnar(packing.pack_columnar(three), 10, 0, cfg)
    wide = [CommitTransaction(read_conflict_ranges=[(b"a", b"b")] * 3)]
    with pytest.raises(ValueError, match="max_reads"):
        packing.pack_batch_columnar(packing.pack_columnar(wide), 10, 0, cfg)
    old = [CommitTransaction(read_snapshot=2**32)]
    with pytest.raises(OverflowError):
        packing.pack_batch_columnar(packing.pack_columnar(old), 10, 0, cfg)


# ---------------------------------------------------------------------------
# resolve_columnar on five configurations

KEY_BYTES = 8
KEYSPACE = 2000
BASE_KW = dict(max_key_bytes=KEY_BYTES, max_txns=64, max_reads=128,
               max_writes=128, history_capacity=1024, window_versions=1000,
               delta_capacity=512, compact_interval=3)
CONFIGS = {
    "tiered exact": ({}, "uniform"),
    "latch + dedup": ({"fixpoint_latch": True, "fixpoint_unroll": 2,
                       "dedup_reads": 32}, "hot"),
    "sweep + spill": ({"range_sweep": True, "delta_spill": True,
                       "fixpoint_latch": True, "fixpoint_unroll": 4,
                       "delta_capacity": 256, "compact_interval": 0},
                      "scan"),
    "classic": ({"delta_capacity": 0}, "uniform"),
    "2 shards": ({"n_shards": 2}, "uniform"),
}
N_BATCHES = 6


def key(i: int) -> bytes:
    return int(i).to_bytes(KEY_BYTES, "big")


def stream(letter: str, seed: int):
    """Seeded batches of 60 txns: uniform point reads and writes, hot
    keys (a 40-key space, so the dedup and the latch have work) or range
    scans (up to 100 keys), with report flags and a blind write or two,
    and now and then a key longer than the packer keeps."""
    rng = np.random.default_rng(seed)
    space = 40 if letter == "hot" else KEYSPACE
    out = []
    for b in range(N_BATCHES):
        version = 1000 + 200 * (b + 1)
        txns = []
        for t in range(60):
            reads = []
            if t % 7:
                for _ in range(int(rng.integers(1, 3))):
                    k = int(rng.integers(0, space))
                    span = (int(rng.integers(1, 100)) if letter == "scan"
                            else 1)
                    reads.append((key(k), key(k + span)))
            writes = []
            for _ in range(int(rng.integers(0 if t % 7 else 1, 3))):
                k = key(int(rng.integers(0, space)))
                if t % 11 == 5:
                    k += b"long-tail"  # over max_key_bytes
                writes.append((k, k + b"\x00"))
            txns.append(CommitTransaction(
                read_conflict_ranges=reads, write_conflict_ranges=writes,
                read_snapshot=version - int(rng.integers(100, 500)),
                report_conflicting_keys=bool(t % 3 == 0)))
        out.append((txns, version))
    return out


def jax_set(kw):
    if kw.get("n_shards", 0) > 1:
        b = [key(KEYSPACE // 2)]
        return (JCS.TpuConflictSet(JaxConfig(**kw), mesh=cpu_mesh(2),
                                   shard_boundaries=b), b)
    return JCS.TpuConflictSet(JaxConfig(**kw)), None


@pytest.mark.parametrize("name", list(CONFIGS))
def test_resolve_columnar_matches_jax_and_object_path(name):
    over, letter = CONFIGS[name]
    kw = {**BASE_KW, **over}
    jcs, bounds = jax_set(kw)
    port = PCS.make_conflict_set(KernelConfig(**kw), "cuda", device="cpu",
                                 shard_boundaries=bounds)
    port_obj = PCS.make_conflict_set(KernelConfig(**kw), "cuda",
                                     device="cpu", shard_boundaries=bounds)
    n_conflicts = n_reports = 0
    for i, (txns, version) in enumerate(stream(letter, seed=7)):
        cols = packing.pack_columnar(txns)
        got = port.resolve_columnar(cols, version)
        want = jcs.resolve_columnar(jax_packing.pack_columnar(to_jax(txns)),
                                    version)
        obj = port_obj.resolve(txns, version)
        assert [int(v) for v in got.verdicts] == [
            int(v) for v in want.verdicts], (name, i)
        assert got.conflicting_key_ranges == want.conflicting_key_ranges, (
            name, i)
        assert got.verdicts == obj.verdicts, (name, i)
        assert got.conflicting_key_ranges == obj.conflicting_key_ranges, (
            name, i)
        n_conflicts += sum(int(v) == 0 for v in got.verdicts)
        n_reports += len(got.conflicting_key_ranges)
    assert n_conflicts and n_reports, "the stream checks no conflict"
    c = port.metrics.counters.as_dict()
    assert c["columnarBatches"] == N_BATCHES
    assert c["resolveBatches"] == N_BATCHES
    assert port_obj.metrics.counters.get("columnarBatches") == 0
    assert (jcs.metrics.counters.as_dict()["columnarBatches"]
            == N_BATCHES)


def test_cpu_set_has_no_columnar_path():
    """As in JAX, the host oracle takes objects only: the wire role tells
    the two kinds of set apart by this attribute."""
    cpu = PCS.make_conflict_set(KernelConfig(**BASE_KW), "cpu")
    assert not hasattr(cpu, "pack_columnar_batch")
    assert not hasattr(JCS.CpuConflictSet(JaxConfig(**BASE_KW)),
                       "pack_columnar_batch")
    assert hasattr(PCS.TorchConflictSet, "resolve_columnar")
