"""The port's main path as a whole, held against the JAX tiered kernel.

`make_conflict_set(cfg, "cuda", device="cpu")` (the plain PyTorch path)
runs beside the JAX `TpuConflictSet(..., "tpu-force")` on the tiered,
exact configuration and the copied ConflictOracle, on the same streams:

* through `resolve()`: verdicts and conflicting-key reports identical to
  JAX and to the oracle;
* through `resolve_packed()` on the same packed batches: every
  BatchVerdict field bit-identical to JAX (verdict, hist_conflict_read,
  intra_first_range, the three counts, overflow);
* the two-tier history identical to JAX's row for row after the stream,
  and its combined map the same piecewise map as the oracle's history.

The tolerance is equality throughout: every output is an integer or a
bool. One configuration (one JAX compile) serves the module.
"""

from __future__ import annotations

import bisect

import numpy as np
import pytest

from foundationdb_tpu.config import KernelConfig as JaxConfig
from foundationdb_tpu.models.conflict_set import (
    HistoryOverflowError as JaxOverflow,
)
from foundationdb_tpu.models.conflict_set import make_conflict_set as jax_make
from foundationdb_tpu.testing import benchgen as jax_benchgen
from foundationdb_tpu.utils import packing as jax_packing
from foundationdb_tpu_torch import HistoryOverflowError, interop
from foundationdb_tpu_torch import make_conflict_set
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.testing import benchgen
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import packing

from conftest import random_range

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

BASE_KW = dict(max_key_bytes=8, max_txns=16, max_reads=32, max_writes=32,
               history_capacity=512, window_versions=1000,
               delta_capacity=256, compact_interval=2)


def random_txn(rng, *, snap_lo, snap_hi):
    reads = [] if rng.random() < 0.15 else [
        random_range(rng) for _ in range(1 + int(rng.integers(0, 2)))]
    writes = [random_range(rng) for _ in range(1 + int(rng.integers(0, 2)))]
    return CommitTransaction(
        read_conflict_ranges=reads, write_conflict_ranges=writes,
        read_snapshot=int(rng.integers(snap_lo, snap_hi)),
        report_conflicting_keys=bool(rng.random() < 0.5),
    )


def gen_stream(rng, n_batches, *, base=1000, step=100, n_txns=12):
    out = []
    for i in range(n_batches):
        version = base + (i + 1) * step
        out.append(([random_txn(rng, snap_lo=max(0, base - 2 * step),
                                snap_hi=version)
                     for _ in range(n_txns)], version))
    return out


class Trio:
    """The JAX kernel, the port and the oracle on one configuration,
    plus a JAX/port pair driven through resolve_packed."""

    def __init__(self, **kw):
        kw = {**BASE_KW, **kw}
        self.tcfg = KernelConfig(**kw)
        self.jcfg = JaxConfig(**kw)
        self.jax = jax_make(self.jcfg, "tpu-force")
        self.port = make_conflict_set(self.tcfg, "cuda", device="cpu")
        self.oracle = make_conflict_set(self.tcfg, "cpu")
        self.jax_p = jax_make(self.jcfg, "tpu-force")
        self.port_p = make_conflict_set(self.tcfg, "cuda", device="cpu")

    def resolve(self, txns, version):
        rj = self.jax.resolve(txns, version)
        rt = self.port.resolve(txns, version)
        ro = self.oracle.resolve(txns, version)
        assert rt.verdicts == rj.verdicts == ro.verdicts
        assert (rt.conflicting_key_ranges == rj.conflicting_key_ranges
                == ro.conflicting_key_ranges)
        pb = packing.pack_batch(txns, version, 0, self.tcfg)
        jb = jax_packing.pack_batch(txns, version, 0, self.jcfg)
        for k, v in pb.device_args().items():
            assert np.array_equal(v, jb.device_args()[k]), k
        self.packed(pb)
        return rt

    def packed(self, pb):
        """resolve_packed on the JAX/port pair: every field identical."""
        want = self.jax_p.resolve_packed(pb)
        got = self.port_p.resolve_packed(pb)
        for f in want._fields:
            assert np.array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(want, f))), f
        return got

    def compact(self):
        for cs in (self.jax, self.port, self.jax_p, self.port_p):
            cs.compact_history()

    def check_state(self):
        for j, t in ((self.jax, self.port), (self.jax_p, self.port_p)):
            assert_state_equal(t.state, j.state)
        assert_same_map(self.port.state, self.oracle._oracle,
                        self.port.base_version)


def assert_state_equal(port_state, jax_state):
    """The two tiers identical row for row (both keep canonical form)."""
    got = interop.tiered_state_to_numpy(port_state)
    for tier, want in zip(got, (jax_state.main, jax_state.delta)):
        keys, ver, oldest, overflow = tier
        assert np.array_equal(keys, np.asarray(want.main_keys))
        assert np.array_equal(ver, np.asarray(want.main_ver))
        assert oldest == int(want.oldest)
        assert overflow == bool(want.overflow)


def _tier_map(tier):
    keys, ver, _, _ = interop.history_to_numpy(tier)
    live = keys[:, -1] != 0xFFFFFFFF
    return [packing.unpack_key(k) for k in keys[live]], list(ver[live])


def _value_at(ks, vs, key, background):
    i = bisect.bisect_right(ks, key) - 1
    return vs[i] if i >= 0 else background


def assert_same_map(state, oracle, base: int):
    """The port's combined map (max of the tiers, offsets from `base`)
    and the oracle's history (absolute versions) give every key the same
    effective version: values at or under the floor can conflict with no
    live read, so both count as NEG there (the oracle's background is 0,
    the port's NEG)."""
    floor = max(oracle.oldest, 0)
    m_ks, m_vs = _tier_map(state.main)
    d_ks, d_vs = _tier_map(state.delta)
    h = oracle.history

    def eff(v):
        return v if v > floor else H.VERSION_NEG

    for key in sorted(set(m_ks) | set(d_ks) | set(h.boundaries)):
        port = max(_value_at(m_ks, m_vs, key, H.VERSION_NEG),
                   _value_at(d_ks, d_vs, key, H.VERSION_NEG))
        port = port if port == H.VERSION_NEG else port + base
        want = _value_at(h.boundaries, h.values, key, h.background)
        assert eff(port) == eff(want), key


def drive(trio, stream, compact_at=()):
    for i, (txns, v) in enumerate(stream):
        trio.resolve(txns, v)
        if i in compact_at:
            trio.compact()
    trio.check_state()


@pytest.mark.parametrize("seed", range(4))
def test_random_streams_match_jax_and_oracle(seed):
    rng = np.random.default_rng(seed)
    drive(Trio(), gen_stream(rng, 8))


@pytest.mark.parametrize("interval", [1, 3])
def test_compaction_cadences(interval):
    rng = np.random.default_rng(40 + interval)
    drive(Trio(compact_interval=interval), gen_stream(rng, 7))


def test_explicit_compaction():
    rng = np.random.default_rng(50)
    drive(Trio(compact_interval=0), gen_stream(rng, 7), compact_at=(1, 4))


def test_window_edge_snapshots():
    """Snapshots at and beside the MVCC floor: the too-old boundary and
    the GC boundary (window 100)."""
    trio = Trio(window_versions=100)
    k = lambda i: bytes([i])  # noqa: E731
    stream = []
    for snap in (99, 100, 101, 199, 200):
        stream.append(([
            CommitTransaction([(k(1), k(2))], [(k(1), k(2))],
                              read_snapshot=snap),
            CommitTransaction([], [(k(3), k(4))], read_snapshot=snap),
            CommitTransaction([(k(3), k(5))], [(k(6), k(7))],
                              read_snapshot=snap,
                              report_conflicting_keys=True),
        ], 200 + len(stream)))
    drive(trio, stream)


def test_benchgen_stream():
    """The port's copy of the skiplist-style generator gives the JAX
    generator's arrays, and a small contended stream of them resolves
    field for field alike."""
    trio = Trio(window_versions=500)
    rng_t, rng_j = np.random.default_rng(9), np.random.default_rng(9)
    for i in range(6):
        kw = dict(version=1000 + 200 * i, keyspace=60, range_len=2,
                  snapshot_lag=300)
        pb = benchgen.skiplist_style_batch(rng_t, trio.tcfg, 16, **kw)
        jb = jax_benchgen.skiplist_style_batch(rng_j, trio.jcfg, 16, **kw)
        for key, v in pb.device_args().items():
            assert np.array_equal(v, jb.device_args()[key]), key
        trio.packed(pb)
    for j, t in ((trio.jax_p, trio.port_p),):
        assert_state_equal(t.state, j.state)


def test_delta_overflow_raises():
    """A delta tier that fills (blind point writes on fresh keys, no
    compaction) raises HistoryOverflowError on the same batch as the JAX
    kernel; it never truncates silently."""
    kw = {**BASE_KW, "compact_interval": 0}
    jax_cs = jax_make(JaxConfig(**kw), "tpu-force")
    port = make_conflict_set(KernelConfig(**kw), "cuda", device="cpu")
    raised = {}
    for i in range(8):
        keys = [(100 * i + j).to_bytes(8, "big") for j in range(32)]
        txns = [CommitTransaction([], [(k, k + b"\x00")], read_snapshot=0)
                for k in keys]
        txns = [CommitTransaction([], [w for t in txns[2 * j:2 * j + 2]
                                       for w in t.write_conflict_ranges],
                                  read_snapshot=0) for j in range(16)]
        for name, cs, err in (("jax", jax_cs, JaxOverflow),
                              ("port", port, HistoryOverflowError)):
            if name in raised:
                continue
            try:
                cs.resolve(txns, 1000 + 10 * i)
            except err:
                raised[name] = i
    assert "port" in raised, "the delta tier never overflowed"
    assert raised["port"] == raised.get("jax")
    assert bool(port.state.delta.overflow)


def test_rebase():
    """Versions past 2**30 shift every stored offset down (NEG stays
    NEG) on both sides, mid-stream, with decisions unchanged."""
    trio = Trio()
    rng = np.random.default_rng(70)
    stream = gen_stream(rng, 6, base=(1 << 30) - 250)
    drive(trio, stream)
    assert trio.port.metrics.counters.get("rebases") == 1
    assert trio.port.base_version == trio.jax.base_version


def test_state_carried_across_from_jax():
    """k batches in JAX, the state carried into the port through
    interop, then m more batches on both: identical results and state."""
    rng = np.random.default_rng(80)
    stream = gen_stream(rng, 9)
    kw = {**BASE_KW, "compact_interval": 3}
    jax_cs = jax_make(JaxConfig(**kw), "tpu-force")
    for txns, v in stream[:4]:
        jax_cs.resolve(txns, v)
    port = make_conflict_set(KernelConfig(**kw), "cuda", device="cpu")
    port.load_state(
        ([np.asarray(x) for x in jax_cs.state.main],
         [np.asarray(x) for x in jax_cs.state.delta]),
        jax_cs.base_version, jax_cs._batches_since_compact,
        jax_cs._spill_bound_rows)
    assert_state_equal(port.state, jax_cs.state)
    for txns, v in stream[4:]:
        rj, rt = jax_cs.resolve(txns, v), port.resolve(txns, v)
        assert rt.verdicts == rj.verdicts
        assert rt.conflicting_key_ranges == rj.conflicting_key_ranges
    assert_state_equal(port.state, jax_cs.state)


def test_group_args_match_jax():
    """resolve_group_args on stacked groups of 3 batches: the port's host
    loop against the JAX scan, every GroupVerdict field and the tiers."""
    kw = {**BASE_KW, "compact_interval": 3}
    jax_cs = jax_make(JaxConfig(**kw), "tpu-force")
    port = make_conflict_set(KernelConfig(**kw), "cuda", device="cpu")
    rng = np.random.default_rng(90)
    stream = gen_stream(rng, 6)
    for lo in (0, 3):
        stacked = packing.stack_device_args([
            packing.pack_batch(txns, v, 0, port.config)
            for txns, v in stream[lo:lo + 3]
        ])
        want = jax_cs.resolve_group_args(stacked)
        got = port.resolve_group_args(stacked)
        for f in want._fields:
            assert np.array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(want, f))), f
    assert_state_equal(port.state, jax_cs.state)


def test_interval_overflow_check_raises():
    """On the kernel-only path the overflow is read every 32 batches:
    both packages raise on the same call, once the delta tier filled."""
    kw = {**BASE_KW, "compact_interval": 0}
    jax_cs = jax_make(JaxConfig(**kw), "tpu-force")
    port = make_conflict_set(KernelConfig(**kw), "cuda", device="cpu")
    raised = {}
    for i in range(40):
        txns = [CommitTransaction(
            [], [((64 * i + j).to_bytes(8, "big"),
                  (64 * i + j).to_bytes(8, "big") + b"\x00")],
            read_snapshot=0) for j in range(16)]
        pb = packing.pack_batch(txns, 1000 + 10 * i, 0, port.config)
        for name, cs, err in (("jax", jax_cs, JaxOverflow),
                              ("port", port, HistoryOverflowError)):
            if name in raised:
                continue
            try:
                cs.resolve_packed(pb)
            except err:
                raised[name] = i
    assert raised.get("port") == raised.get("jax") == 31
