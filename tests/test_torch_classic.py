"""The port's classic single-tier path as a whole, held against the JAX
classic kernel and the oracle on the CPU.

`make_conflict_set(cfg, "cuda", device="cpu")` with `delta_capacity=0`
(the plain PyTorch path) runs beside the JAX `TpuConflictSet(...,
"tpu-force")` on the same configuration and the copied ConflictOracle:

* `resolve_batch` (K15) against JAX `resolve_batch` on random streams;
* `resolve()` with conflict reports: verdicts and reports identical to
  JAX and to the oracle, the history the same canonical map as JAX's
  after every call and the same piecewise map as the oracle's;
* `resolve_args`, `resolve_args_scan` (K batches in order) and
  `resolve_group_args` (the group kernel at G > 1, exact, and latched
  with the exact fallback): every field bit-identical to JAX;
* the version rebase; overflow raising at a small capacity on the
  overflowing batch (tests/test_overflow.py's shapes); a JAX history
  carried into the port mid-stream and read back; unordered group
  versions refused.

The tolerance is equality throughout: every output is an integer or a
bool.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from foundationdb_tpu.config import KernelConfig as JaxConfig
from foundationdb_tpu.models.conflict_set import (
    HistoryOverflowError as JaxOverflow,
)
from foundationdb_tpu.models.conflict_set import make_conflict_set as jax_make
from foundationdb_tpu.ops import conflict as JC
from foundationdb_tpu.ops import history as JH
from foundationdb_tpu_torch import HistoryOverflowError, interop
from foundationdb_tpu_torch import make_conflict_set
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.ops import conflict as C
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import packing

from conftest import random_range
from test_torch_group import canonical_map
from test_torch_tiered import _value_at

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

BASE_KW = dict(max_key_bytes=8, max_txns=16, max_reads=32, max_writes=32,
               history_capacity=512, window_versions=1000)


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
    return [([random_txn(rng, snap_lo=max(0, base - 2 * step),
                         snap_hi=base + (i + 1) * step)
              for _ in range(n_txns)], base + (i + 1) * step)
            for i in range(n_batches)]


def assert_same_state(port, jax_cs):
    (keys, ver, oldest, overflow), base = port.store_state()
    want = jax_cs.state
    assert canonical_map(keys, ver) == canonical_map(
        np.asarray(want.main_keys), np.asarray(want.main_ver))
    assert oldest == int(want.oldest)
    assert overflow == bool(want.overflow)
    assert base == jax_cs.base_version


def assert_same_fields(got, want, tag=""):
    for f in want._fields:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f"{tag} {f}"


def assert_same_map_as_oracle(port, oracle):
    """The port's tier and the oracle's history give every key the same
    effective version (values at or under the floor count as NEG)."""
    (keys, ver, _, _), base = port.store_state()
    live = keys[:, -1] != 0xFFFFFFFF
    ks = [packing.unpack_key(k) for k in keys[live]]
    vs = list(ver[live])
    h = oracle._oracle.history
    floor = max(oracle._oracle.oldest, 0)

    def eff(v):
        return v if v > floor else H.VERSION_NEG

    for key in sorted(set(ks) | set(h.boundaries)):
        got = _value_at(ks, vs, key, H.VERSION_NEG)
        got = got if got == H.VERSION_NEG else got + base
        assert eff(got) == eff(_value_at(h.boundaries, h.values, key,
                                         h.background)), key


def pair(**kw):
    kw = {**BASE_KW, **kw}
    return (jax_make(JaxConfig(**kw), "tpu-force"),
            make_conflict_set(KernelConfig(**kw), "cuda", device="cpu"))


def packed(stream, cfg):
    return [packing.pack_batch(txns, v, 0, cfg) for txns, v in stream]


# ---------------------------------------------------------------------------
# K15: resolve_batch

@pytest.mark.parametrize("seed", range(3))
def test_resolve_batch_matches_jax(seed):
    rng = np.random.default_rng(seed)
    cfg = KernelConfig(**BASE_KW)
    js, ts = JH.init(JaxConfig(**BASE_KW)), H.init(cfg, "cpu")
    step = jax.jit(JC.resolve_batch)
    for i, pb in enumerate(packed(gen_stream(rng, 6), cfg)):
        js, want = step(js, pb.device_args())
        ts, got = C.resolve_batch(ts, pb.device_args())
        assert_same_fields(got, want, f"batch {i}:")
        assert canonical_map(*interop.history_to_numpy(ts)[:2]) == \
            canonical_map(np.asarray(js.main_keys), np.asarray(js.main_ver))
        assert ts.oldest == int(js.oldest)


# ---------------------------------------------------------------------------
# TorchConflictSet, classic

@pytest.mark.parametrize("seed", range(3))
def test_resolve_matches_jax_and_oracle(seed):
    rng = np.random.default_rng(20 + seed)
    jax_cs, port = pair()
    assert not port.tiered
    oracle = make_conflict_set(port.config, "cpu")
    for txns, v in gen_stream(rng, 8):
        rj, rt, ro = (cs.resolve(txns, v) for cs in (jax_cs, port, oracle))
        assert rt.verdicts == rj.verdicts == ro.verdicts
        assert (rt.conflicting_key_ranges == rj.conflicting_key_ranges
                == ro.conflicting_key_ranges)
        assert_same_state(port, jax_cs)
    assert_same_map_as_oracle(port, oracle)
    assert port.metrics.counters.get("resolveBatches") == 8


def test_resolve_args_and_scan_match_jax():
    """resolve_args batch by batch, then resolve_args_scan over stacked
    groups of 3: every field, and the tier after each call."""
    rng = np.random.default_rng(30)
    jax_cs, port = pair()
    batches = packed(gen_stream(rng, 9), port.config)
    for pb in batches[:3]:
        assert_same_fields(port.resolve_args(pb.device_args()),
                           jax_cs.resolve_args(pb.device_args()))
        assert_same_state(port, jax_cs)
    for lo in (3, 6):
        stacked = packing.stack_device_args(batches[lo:lo + 3])
        got = port.resolve_args_scan(stacked)
        assert isinstance(got, C.BatchVerdict) and got.verdict.shape[0] == 3
        assert_same_fields(got, jax_cs.resolve_args_scan(stacked))
        assert_same_state(port, jax_cs)
    assert port.metrics.counters.get("groupDispatches") == 2


@pytest.mark.parametrize("gn", [2, 4])
def test_group_args_match_jax(gn):
    """resolve_group_args (the group kernel) over consecutive groups, and
    the same batches through resolve_args_scan on a third pair."""
    rng = np.random.default_rng(40 + gn)
    jax_cs, port = pair()
    _, scan = pair()
    batches = packed(gen_stream(rng, 2 * gn), port.config)
    for lo in (0, gn):
        stacked = packing.stack_device_args(batches[lo:lo + gn])
        got = port.resolve_group_args(stacked)
        assert_same_fields(got, jax_cs.resolve_group_args(stacked))
        assert_same_state(port, jax_cs)
        seq = scan.resolve_args_scan(stacked)
        for f in seq._fields:
            assert torch.equal(getattr(got, f), getattr(seq, f)), f
    assert canonical_map(*interop.history_to_numpy(scan.state)[:2]) == \
        canonical_map(*interop.history_to_numpy(port.state)[:2])


def chain_stream(n=12):
    """Two batches; in the second a chain txn i reads key i-1 and writes
    key i, a conflict chain n deep."""
    T = CommitTransaction
    txns = []
    for i in range(n):
        prev = b"ch%02d" % (i - 1) if i else b"yy"
        cur = b"ch%02d" % i
        txns.append(T([(prev, prev + b"\x00")], [(cur, cur + b"\x00")],
                      read_snapshot=5))
    return [([T([], [(b"zz", b"zz\x00")], read_snapshot=5)], 10),
            (txns, 20)]


def test_latched_group_falls_back_and_matches_jax():
    """fixpoint_latch with unroll 2 on a 12-deep chain: the group trips,
    resolve_group_args re-runs it exactly on the same input state, and
    the result equals the JAX conflict set's (which falls back too) and
    the exact configuration's. check_latch=False hands the refused group
    back with the state unchanged."""
    jax_cs, port = pair(fixpoint_latch=True, fixpoint_unroll=2)
    _, exact = pair()
    _, raw = pair(fixpoint_latch=True, fixpoint_unroll=2)
    stacked = packing.stack_device_args(packed(chain_stream(), port.config))
    port.prewarm_exact(stacked)
    got = port.resolve_group_args(stacked)
    assert_same_fields(got, jax_cs.resolve_group_args(stacked))
    assert_same_state(port, jax_cs)
    want = exact.resolve_group_args(stacked)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    c = port.metrics.counters.as_dict()
    assert c["latchTrips"] == c["exactFallbacks"] == 1
    before = raw.state
    refused = raw.resolve_group_args(stacked, check_latch=False)
    assert bool(refused.unconverged.all()) and raw.state is before


def test_rebase_matches_jax():
    rng = np.random.default_rng(50)
    jax_cs, port = pair()
    for txns, v in gen_stream(rng, 5, base=(1 << 30) - 250):
        rj, rt = jax_cs.resolve(txns, v), port.resolve(txns, v)
        assert rt.verdicts == rj.verdicts
        assert rt.conflicting_key_ranges == rj.conflicting_key_ranges
        assert_same_state(port, jax_cs)
    assert port.metrics.counters.get("rebases") == 1


def disjoint_write_batch(base: int, n: int):
    """n disjoint, non-adjacent one-key writes: 2n new boundaries."""
    def k(i):
        return int(i).to_bytes(4, "big")
    return [CommitTransaction(write_conflict_ranges=[
        (k(base + 10 * i), k(base + 10 * i + 1))]) for i in range(n)]


def test_overflow_raises_on_the_overflowing_batch():
    """tests/test_overflow.py's shapes: capacity 24, 8 two-boundary
    writes per batch; both packages raise on the same resolve(). Through
    one group the overflow is latched in every batch's verdict and the
    next check raises."""
    kw = dict(max_key_bytes=8, max_txns=16, max_reads=16, max_writes=16,
              history_capacity=24, window_versions=10_000_000)
    jax_cs, port = pair(**kw)
    raised = {}
    for step in range(6):
        for name, cs, err in (("jax", jax_cs, JaxOverflow),
                              ("port", port, HistoryOverflowError)):
            if name in raised:
                continue
            try:
                cs.resolve(disjoint_write_batch(100_000 * step, 8),
                           100 * (step + 1))
            except err:
                raised[name] = step
    assert raised.get("port") == raised.get("jax") is not None
    assert raised["port"] <= 3
    # the same overflow through one group: latched in the verdict
    _, grp = pair(**kw)
    stacked = packing.stack_device_args([
        packing.pack_batch(disjoint_write_batch(100_000 * s, 8),
                           100 * (s + 1), 0, grp.config) for s in range(3)])
    out = grp.resolve_group_args(stacked)
    assert bool(out.overflow.all())
    with pytest.raises(HistoryOverflowError):
        grp.check_overflow()


def test_state_carried_across_from_jax():
    """k batches in JAX, the single-tier state carried into the port
    (load_state), then more on both: identical results and state;
    store_state gives JAX's leaves back."""
    rng = np.random.default_rng(60)
    stream = gen_stream(rng, 8)
    jax_cs, port = pair()
    for txns, v in stream[:4]:
        jax_cs.resolve(txns, v)
    port.load_state([np.asarray(x) for x in jax_cs.state],
                    jax_cs.base_version)
    (keys, ver, oldest, overflow), base = port.store_state()
    assert np.array_equal(keys, np.asarray(jax_cs.state.main_keys))
    assert np.array_equal(ver, np.asarray(jax_cs.state.main_ver))
    assert (oldest, overflow, base) == (int(jax_cs.state.oldest),
                                        bool(jax_cs.state.overflow),
                                        jax_cs.base_version)
    for txns, v in stream[4:]:
        rj, rt = jax_cs.resolve(txns, v), port.resolve(txns, v)
        assert rt.verdicts == rj.verdicts
        assert rt.conflicting_key_ranges == rj.conflicting_key_ranges
    assert_same_state(port, jax_cs)


def test_group_versions_must_ascend():
    rng = np.random.default_rng(70)
    _, port = pair()
    a, b = packed(gen_stream(rng, 2), port.config)
    stacked = packing.stack_device_args([a, b])
    stacked["version"] = stacked["version"][::-1].copy()
    with pytest.raises(ValueError, match="ascend"):
        port.resolve_group_args(stacked)
    port.compact_history()   # a no-op on the single tier
    assert port.metrics.counters.get("compactions") == 0
