"""The hot-key and range-scan profiles of the port, held against the JAX
package on the CPU.

The port's plain PyTorch path (CPU tensors) and the JAX package run the
same seeded numpy inputs; every output is an integer or a bool, so the
tolerance is equality throughout:

* K12, read dedup (`_main_stale` with dedup_reads = U): stale bits, the
  latch flag and the exact distinct count, U above and below it;
* K11, the endpoint sweep (`sweep_read_ranks`): il/ir on every live
  read, ties on both ends, an empty main tier, reads outside it;
* the fixpoint latch at G=1 and on the tiered loop: the raw trip leaves
  the state unchanged, the conflict set's exact fallback serves the
  exact decisions;
* seeded zipf streams (latch + dedup) and YCSB-E streams (sweep +
  spill, groups of 3) against `TpuConflictSet` and the oracle: every
  field, both tiers after every group, and the counters;
* the profile router, the YCSB generator and the start-up self-check
  (K20).

One exception, as in the contract: the verdicts of a tripped (latched)
group are never compared. Neither package hands them out; what must
match is `unconverged`, the unchanged state and, after the fallback,
every field.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.config import KernelConfig as JaxConfig
from foundationdb_tpu.models import conflict_set as JCS
from foundationdb_tpu.models.conflict_set import (
    HistoryOverflowError as JaxOverflow,
)
from foundationdb_tpu.ops import delta as JD
from foundationdb_tpu.ops import group as JG
from foundationdb_tpu.ops import history as JH
from foundationdb_tpu.ops import rangemax as JR
from foundationdb_tpu.testing import benchgen as jax_benchgen
from foundationdb_tpu_torch import HistoryOverflowError, interop
from foundationdb_tpu_torch import make_conflict_set
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.models import conflict_set as CS
from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.ops import delta as D
from foundationdb_tpu_torch.ops import group as G
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.ops import rangemax as R
from foundationdb_tpu_torch.testing import benchgen
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import packing

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

KEY_BYTES = 8
W = KEY_BYTES // 4 + 1
NEG = JH.VERSION_NEG
SENT = 0xFFFFFFFF


def t(a) -> torch.Tensor:
    return interop.to_torch(np.asarray(a), "cpu")


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x)


def int_keys(v) -> np.ndarray:
    return benchgen.int_keys_packed(np.asarray(v, np.int64), KEY_BYTES, W)


def main_tier(rng, n_live, cap, span=1 << 16):
    """[cap, W] sorted distinct keys with a sentinel tail, versions."""
    ks = np.unique(rng.integers(0, span, size=n_live))
    keys = np.full((cap, W), SENT, np.uint32)
    keys[: len(ks)] = int_keys(ks)
    ver = np.full((cap,), NEG, np.int32)
    ver[: len(ks)] = rng.integers(0, 10_000, size=len(ks))
    return keys, ver, ks


def jax_history(keys, ver):
    return JH.VersionHistory(jnp.asarray(keys), jnp.asarray(ver),
                             jnp.int32(NEG), jnp.asarray(False))


def port_history(keys, ver):
    return interop.history_from_numpy(keys, ver, NEG, False, "cpu")


# ---------------------------------------------------------------------------
# K12: read dedup

_JAX_MAIN_STALE = jax.jit(JD._main_stale, static_argnums=(6,))


def dedup_reads_case(rng, nr=128, n_live=100):
    """Reads with many exact duplicates, duplicates differing only in the
    end key, dead rows, and snapshots that straddle the versions."""
    pool_b = rng.integers(0, 1 << 16, size=12)
    b = pool_b[rng.integers(0, len(pool_b), size=nr)]
    e = b + rng.integers(1, 3, size=nr) * rng.choice([1, 500], size=nr)
    rb, re = int_keys(b), int_keys(e)
    rvalid = np.zeros((nr,), bool)
    rvalid[:n_live] = True
    # dead rows carry keys equal to live ones: they must never count
    rb[n_live:] = rb[: nr - n_live]
    rsnap = rng.integers(0, 10_000, size=nr).astype(np.int32)
    return rb, re, rsnap, rvalid


def live_distinct(rb, re, rvalid) -> int:
    pairs = np.concatenate([rb[rvalid], re[rvalid]], axis=1)
    return len(np.unique(pairs, axis=0))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("where", ["above", "equal", "below"])
def test_main_stale_dedup_matches_jax(seed, where):
    rng = np.random.default_rng(300 + seed)
    keys, ver, _ = main_tier(rng, 150, 256)
    rb, re, rsnap, rvalid = dedup_reads_case(rng)
    n = live_distinct(rb, re, rvalid)
    u = {"above": 1 << n.bit_length(), "equal": n, "below": n - 1}[where]
    jtab = JR.build(jnp.asarray(ver), op="max")
    j_stale, j_ok = _JAX_MAIN_STALE(
        jax_history(keys, ver), jtab, jnp.asarray(rb), jnp.asarray(re),
        jnp.asarray(rsnap), jnp.asarray(rvalid), u)
    main = port_history(keys, ver)
    tab = R.build(main.main_ver, op="max")
    stale, ok = D._main_stale(main, tab, t(rb), t(re), t(rsnap), t(rvalid), u)
    _, n_uniq = D.dedup_vmax(main, tab, t(rb), t(re), t(rvalid), u)
    assert int(n_uniq) == n
    assert bool(ok) == bool(j_ok) == (where != "below")
    if where != "below":
        exact, _ = D._main_stale(main, tab, t(rb), t(re), t(rsnap),
                                 t(rvalid), 0)
        assert np.array_equal(np_of(stale), np.asarray(j_stale))
        assert np.array_equal(np_of(stale), np_of(exact))
        assert np_of(stale).any() and not np_of(stale).all()


def test_dedup_counts_only_live_rows():
    """All reads dead: n_uniq 0; one live read among dead copies of it:
    n_uniq 1."""
    rng = np.random.default_rng(5)
    keys, ver, _ = main_tier(rng, 40, 64)
    main = port_history(keys, ver)
    tab = R.build(main.main_ver, op="max")
    rb = int_keys(np.full(16, 7))
    re = int_keys(np.full(16, 9))
    rvalid = np.zeros((16,), bool)
    _, n0 = D.dedup_vmax(main, tab, t(rb), t(re), t(rvalid), 4)
    rvalid[3] = True
    _, n1 = D.dedup_vmax(main, tab, t(rb), t(re), t(rvalid), 4)
    assert (int(n0), int(n1)) == (0, 1)


# ---------------------------------------------------------------------------
# K11: sweep ranks

_JAX_SWEEP = jax.jit(JD.sweep_read_ranks)


def sweep_case(rng, kind, r=200):
    n_main = 0 if kind == "empty_main" else 120
    keys, _, ks = main_tier(rng, n_main, 256, span=10_000)
    b = rng.integers(0, 10_000, size=r)
    e = b + rng.integers(1, 300, size=r)
    if kind in ("ties", "empty_main") and len(ks):
        # begins and ends exactly on main boundaries, both sides
        b[::3] = ks[rng.integers(0, len(ks), size=len(b[::3]))]
        e[1::3] = ks[rng.integers(0, len(ks), size=len(e[1::3]))]
        b[1::3] = np.maximum(np.minimum(b[1::3], e[1::3] - 1), 0)
        e[::3] = np.maximum(e[::3], b[::3] + 1)
    if kind == "edges" and len(ks):
        b[:20] = 0                       # before the first boundary
        e[:10] = np.minimum(e[:10], max(int(ks[0]) - 1, 1))
        b[20:40] = int(ks[-1]) + 1       # after the last boundary
        e[20:40] = int(ks[-1]) + 50
        b[40:50], e[40:50] = ks[0], ks[-1]   # the whole tier
    rvalid = rng.random(r) < 0.85
    return keys, int_keys(b), int_keys(e), rvalid


@pytest.mark.parametrize("kind", ["random", "ties", "edges", "empty_main"])
def test_sweep_read_ranks_matches_jax(kind):
    rng = np.random.default_rng(len(kind))
    keys, rb, re, rvalid = sweep_case(rng, kind)
    j_il, j_ir = _JAX_SWEEP(jnp.asarray(keys), jnp.asarray(rb),
                            jnp.asarray(re), jnp.asarray(rvalid))
    il, ir = D.sweep_read_ranks(t(keys), t(rb), t(re), t(rvalid))
    live = rvalid
    assert np.array_equal(np_of(il)[live], np.asarray(j_il)[live])
    assert np.array_equal(np_of(ir)[live], np.asarray(j_ir)[live])
    assert (np_of(il)[~live] == -1).all() and (np_of(ir)[~live] == -1).all()
    if kind == "empty_main":
        assert (np_of(il)[live] == -1).all() and (np_of(ir)[live] == -1).all()


# ---------------------------------------------------------------------------
# the fixpoint latch

LATCH_KW = dict(max_key_bytes=8, max_txns=16, max_reads=16, max_writes=16,
                history_capacity=256, window_versions=10_000,
                delta_capacity=128, compact_interval=0,
                fixpoint_unroll=1, fixpoint_latch=True)


def chain_batch(config, n, version, snapshot):
    """A conflict chain of depth n: t0 writes k0, t_i reads k_{i-1} and
    writes k_i. Sequentially every txn commits, but the fixpoint needs
    about n applications to prove it, so a small unroll trips."""
    def key(i):
        return b"k%04d" % i

    txns = [CommitTransaction(
        read_conflict_ranges=[] if i == 0 else [(key(i - 1),
                                                 key(i - 1) + b"\x00")],
        write_conflict_ranges=[(key(i), key(i) + b"\x00")],
        read_snapshot=snapshot) for i in range(n)]
    return packing.pack_batch(txns, version, 0, config)


def pair(**kw):
    """A JAX TpuConflictSet and the port's plain path on one config."""
    return (JCS.make_conflict_set(JaxConfig(**kw), "tpu-force"),
            make_conflict_set(KernelConfig(**kw), "cuda", device="cpu"))


def assert_fields(got, want):
    for f in want._fields:
        assert np.array_equal(np_of(getattr(got, f)),
                              np.asarray(getattr(want, f))), f


def assert_state_equal(port_state, jax_state):
    got = interop.tiered_state_to_numpy(port_state)
    for tier, want in zip(got, (jax_state.main, jax_state.delta)):
        keys, ver, oldest, overflow = tier
        assert np.array_equal(keys, np.asarray(want.main_keys))
        assert np.array_equal(ver, np.asarray(want.main_ver))
        assert oldest == int(want.oldest)
        assert overflow == bool(want.overflow)


_JAX_LATCHED_GROUP = jax.jit(
    lambda s, g: JG.resolve_group(s, g, fixpoint_unroll=1,
                                  fixpoint_latch=True))


@pytest.mark.parametrize("depth", [10, 1])
def test_group_latch_at_g1_matches_jax(depth):
    """ops-level: an unconverged batch returns the input tier itself and
    `unconverged` set; a depth-1 chain converges and merges."""
    cfg = KernelConfig(**LATCH_KW)
    pb = chain_batch(cfg, depth, version=100, snapshot=50)
    g = packing.stack_device_args([pb])
    jstate = JH.VersionHistory(
        jnp.asarray(np.full((64, 3), SENT, np.uint32)),
        jnp.full((64,), NEG, jnp.int32), jnp.int32(NEG), jnp.asarray(False))
    jnew, jout = _JAX_LATCHED_GROUP(jstate,
                                    {k: jnp.asarray(v) for k, v in g.items()})
    tstate = H.empty(64, 3, "cpu")
    tnew, tout = G.resolve_group(tstate, interop.device_args_to_torch(
        g, "cpu"), fixpoint_unroll=1, fixpoint_latch=True)
    assert bool(tout.unconverged[0]) == bool(jout.unconverged[0]) == (
        depth > 1)
    assert np.array_equal(np_of(tnew.main_keys).view(np.uint32),
                          np.asarray(jnew.main_keys))
    assert np.array_equal(np_of(tnew.main_ver), np.asarray(jnew.main_ver))
    assert tnew.oldest == int(jnew.oldest)
    if depth > 1:
        assert tnew is tstate
    else:
        assert_fields(tout, jout)


def test_latch_raw_trip_and_fallback_match_jax_and_exact():
    jax_raw, port_raw = pair(**LATCH_KW)
    jax_cs, port = pair(**LATCH_KW)
    exact = make_conflict_set(
        KernelConfig(**{**LATCH_KW, "fixpoint_latch": False}), "cuda",
        device="cpu")
    cfg = port.config
    for step in range(2):
        v = 100 * (2 * step + 1)
        stacked = packing.stack_device_args([
            chain_batch(cfg, 10, version=v, snapshot=v - 50),
            chain_batch(cfg, 10, version=v + 100, snapshot=v + 50),
        ])
        before = interop.tiered_state_to_numpy(port_raw.state)
        raw = port_raw.resolve_group_args(stacked, check_latch=False)
        jraw = jax_raw.resolve_group_args(stacked, check_latch=False)
        assert np_of(raw.unconverged).all() and np.asarray(
            jraw.unconverged).all()
        for tier_b, tier_a in zip(before, interop.tiered_state_to_numpy(
                port_raw.state)):
            for x, y in zip(tier_b, tier_a):
                assert np.array_equal(x, y)
        assert_state_equal(port_raw.state, jax_raw.state)

        got = port.resolve_group_args(stacked)
        assert_fields(got, jax_cs.resolve_group_args(stacked))
        assert_fields(got, exact.resolve_group_args(stacked))
        assert not np_of(got.unconverged).any()
        assert_state_equal(port.state, jax_cs.state)
    c = port.metrics.counters.as_dict()
    assert c["latchTrips"] == c["exactFallbacks"] == 2
    assert jax_cs.metrics.counters.get("latchTrips") == 2


def test_shallow_group_never_trips():
    jax_cs, port = pair(**{**LATCH_KW, "fixpoint_unroll": 3})
    stacked = packing.stack_device_args(
        [chain_batch(port.config, 3, version=100, snapshot=50)])
    got = port.resolve_group_args(stacked, check_latch=False)
    assert_fields(got, jax_cs.resolve_group_args(stacked, check_latch=False))
    assert not np_of(got.unconverged).any()
    assert port.metrics.counters.get("latchTrips") == 0
    assert_state_equal(port.state, jax_cs.state)


# ---------------------------------------------------------------------------
# seeded zipf and YCSB-E streams through the conflict set

STREAM_KW = dict(max_key_bytes=8, max_txns=64, max_reads=64, max_writes=64,
                 history_capacity=1024, window_versions=1000,
                 delta_capacity=512, compact_interval=3)


def txns_of(pb) -> list:
    """The CommitTransactions a packed batch holds (reads and writes are
    grouped by txn id), for the oracle."""
    reads = [[] for _ in range(pb.n_txns)]
    writes = [[] for _ in range(pb.n_txns)]
    for r in range(pb.n_reads):
        reads[int(pb.read_txn[r])].append(
            (packing.unpack_key(pb.read_begin[r]),
             packing.unpack_key(pb.read_end[r])))
    for w in range(pb.n_writes):
        writes[int(pb.write_txn[w])].append(
            (packing.unpack_key(pb.write_begin[w]),
             packing.unpack_key(pb.write_end[w])))
    return [CommitTransaction(reads[i], writes[i],
                              read_snapshot=int(pb.snapshot[i]))
            for i in range(pb.n_txns)]


def make_stream(letter, config, n_batches, seed):
    """Both packages' generators from one seed: identical arrays."""
    rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        kw = dict(version=1000 + 200 * (i + 1), snapshot_lag=300,
                  key_bytes=KEY_BYTES)
        if letter == "zipf":
            kw.update(zipf=1.1, keyspace=200)
            pb = benchgen.skiplist_style_batch(rng_t, config, 60, **kw)
            jb = jax_benchgen.skiplist_style_batch(rng_j, config, 60, **kw)
        else:
            kw.update(zipf=1.1, keyspace=2000, scan_max=100)
            pb = benchgen.ycsb_batch(rng_t, config, 60, letter, **kw)
            jb = jax_benchgen.ycsb_batch(rng_j, config, 60, letter, **kw)
        for k, v in pb.device_args().items():
            assert np.array_equal(v, jb.device_args()[k]), k
        out.append(pb)
    return out


COUNTERS = ("spills", "compactions", "latchTrips", "exactFallbacks",
            "sweepGroups")


def drive_groups(kw, batches, group):
    """Port, JAX and the oracle over the same groups: every field, both
    tiers after every group, verdicts against the oracle, counters."""
    jax_cs, port = pair(**kw)
    oracle = make_conflict_set(KernelConfig(**kw), "cpu")
    outs = []
    for lo in range(0, len(batches), group):
        chunk = batches[lo:lo + group]
        stacked = packing.stack_device_args(chunk)
        got = port.resolve_group_args(stacked)
        assert_fields(got, jax_cs.resolve_group_args(stacked))
        assert_state_equal(port.state, jax_cs.state)
        for i, pb in enumerate(chunk):
            want = oracle.resolve(txns_of(pb), int(pb.version)).verdicts
            assert [int(v) for v in want] == np_of(
                got.verdict[i])[: pb.n_txns].tolist()
        outs.append(got)
    port.check_overflow()
    for name in COUNTERS:
        assert port.metrics.counters.get(name) == jax_cs.metrics.counters.get(
            name), name
    return port, outs


@pytest.mark.parametrize("dedup,group", [(64, 1), (64, 3), (32, 3), (8, 1)])
def test_zipf_stream_latch_dedup_matches_jax_and_oracle(dedup, group):
    kw = {**STREAM_KW, "fixpoint_latch": True, "fixpoint_unroll": 2,
          "dedup_reads": dedup}
    batches = make_stream("zipf", KernelConfig(**kw), 6, seed=11)
    port, outs = drive_groups(kw, batches, group)
    c = port.metrics.counters.as_dict()
    if dedup == 8:   # far under the ~25 distinct ranges per batch
        assert c["latchTrips"] == c["exactFallbacks"] == 6 // group
    assert sum(int(np_of(o.conflict_count).sum()) for o in outs) > 0


@pytest.mark.parametrize("seed", [21, 22])
def test_ycsb_e_stream_sweep_spill_matches_jax_and_oracle(seed):
    kw = {**STREAM_KW, "range_sweep": True, "delta_spill": True,
          "fixpoint_latch": True, "fixpoint_unroll": 4,
          "delta_capacity": 256, "compact_interval": 0}
    batches = make_stream("ycsb_e", KernelConfig(**kw), 9, seed=seed)
    port, outs = drive_groups(kw, batches, 3)
    c = port.metrics.counters.as_dict()
    assert c["spills"] > 0 and c["sweepGroups"] == 3
    # the same stream on the probe path: the same decisions
    probe = make_conflict_set(
        KernelConfig(**{**kw, "range_sweep": False}), "cuda", device="cpu")
    for lo, got in zip(range(0, 9, 3), outs):
        want = probe.resolve_group_args(
            packing.stack_device_args(batches[lo:lo + 3]))
        assert_fields(got, want)


def test_single_group_past_capacity_still_raises():
    """Spill cannot help a group whose own rows exceed the delta tier:
    both packages raise on the reply, never truncate."""
    kw = {**STREAM_KW, "range_sweep": True, "delta_spill": True,
          "delta_capacity": 4, "compact_interval": 0}
    jax_cs, port = pair(**kw)
    txns = [CommitTransaction([], [(bytes([2 * i]), bytes([2 * i + 1]))],
                              read_snapshot=50) for i in range(8)]
    with pytest.raises(JaxOverflow):
        jax_cs.resolve(txns, 100)
    with pytest.raises(HistoryOverflowError):
        port.resolve(txns, 100)
    assert port.metrics.counters.get("spills") == 1


def test_spill_bound_re_anchors_on_the_overflow_check():
    """The check's live delta count tightens the host bound; decisions
    and compaction points stay those of JAX."""
    kw = {**STREAM_KW, "range_sweep": True, "delta_spill": True,
          "delta_capacity": 512, "compact_interval": 0}
    batches = make_stream("ycsb_e", KernelConfig(**kw), 6, seed=31)
    jax_cs, port = pair(**kw)
    for pb in batches:
        assert_fields(port.resolve_packed(pb), jax_cs.resolve_packed(pb))
        port.check_overflow()
        jax_cs.check_overflow()
        assert port._spill_bound_rows == jax_cs._spill_bound_rows
    assert port.metrics.counters.get("spillBoundAnchors") > 0
    assert_state_equal(port.state, jax_cs.state)


# ---------------------------------------------------------------------------
# the router, the generator, the knobs, the self-check

ROUTE_CFG = dict(max_key_bytes=8, max_txns=4096, max_reads=4096,
                 max_writes=4096, history_capacity=12 * 4096,
                 window_versions=1_000_000)
MODES = {
    "uniform": {},
    "zipf": {"zipf": 1.1, "keyspace": 10_000_000},
    "range": {"range_len": 500},
    "ycsb_b": {"zipf": 1.1, "keyspace": 10_000_000},
    "ycsb_c": {"zipf": 1.1, "keyspace": 10_000_000},
    "ycsb_d": {"keyspace": 10_000_000},
    "ycsb_e": {"zipf": 1.1, "scan_max": 100},
}
ROUTE_CONFIGS = [
    {},
    {"delta_capacity": 1024},
    {"delta_capacity": 1024, "dedup_reads": 1024},
    {"delta_capacity": 1024, "range_sweep": True},
    {"delta_capacity": 1024, "range_sweep": True, "delta_spill": True},
    {"delta_capacity": 1024, "dedup_reads": 512, "delta_spill": True},
]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_router_matches_jax(mode):
    cfg = KernelConfig(**ROUTE_CFG)
    rng_t, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    kw = dict(version=200_000, key_bytes=8, snapshot_lag=400_000,
              **{"keyspace": 1_000_000, **MODES[mode]})
    if mode.startswith("ycsb"):
        kw["insert_frontier"] = kw["keyspace"] // 2
        pb = benchgen.ycsb_batch(rng_t, cfg, 4096, mode, **kw)
        jb = jax_benchgen.ycsb_batch(rng_j, JaxConfig(**ROUTE_CFG), 4096,
                                     mode, **kw)
    else:
        pb = benchgen.skiplist_style_batch(rng_t, cfg, 4096, **kw)
        jb = jax_benchgen.skiplist_style_batch(rng_j, JaxConfig(**ROUTE_CFG),
                                               4096, **kw)
    for k, v in pb.device_args().items():
        assert np.array_equal(v, jb.device_args()[k]), k
    prof = CS.profile_batch(pb)
    assert prof == JCS.profile_batch(jb)
    assert CS.profile_transactions(txns_of(pb)[:512]) == \
        JCS.profile_transactions(txns_of(pb)[:512])
    for extra in ROUTE_CONFIGS:
        port_b = CS.backend_for_profile(prof, KernelConfig(**ROUTE_CFG,
                                                           **extra))
        jax_b = JCS.backend_for_profile(prof, JaxConfig(**ROUTE_CFG, **extra))
        assert port_b == {"tpu": "cuda"}.get(jax_b, jax_b)
        assert CS.fallback_free(KernelConfig(**ROUTE_CFG, **extra)) == \
            JCS.fallback_free(JaxConfig(**ROUTE_CFG, **extra))
    if mode == "ycsb_e":
        assert prof == "range_heavy"


def test_variant_knobs_are_served():
    for kw in ({"fixpoint_latch": True}, {"dedup_reads": 8},
               {"range_sweep": True, "delta_spill": True}):
        cfg = KernelConfig(**{**STREAM_KW, **kw})
        assert make_conflict_set(cfg, "cuda", device="cpu").config == cfg


@pytest.mark.parametrize("m", [1, 2, 1000, 5000])
def test_flat_gather_selftest_passes_on_plain_versions(m):
    R.flat_gather_selftest(m, device="cpu", force=True)
    assert ("cpu", m) in R._SELFTEST_OK


def test_flat_gather_selftest_raises_on_a_corrupt_table(monkeypatch):
    build = R.build

    def corrupt(values, *, op="max"):
        tab = build(values, op=op).clone()
        tab[1:] = tab[1:].flip(-1)
        return tab

    monkeypatch.setattr(R, "build", corrupt)
    with pytest.raises(RuntimeError, match="self-check failed"):
        R.flat_gather_selftest(4096, device="cpu", force=True)


def test_prewarm_exact_leaves_the_state_alone():
    port = make_conflict_set(KernelConfig(**LATCH_KW), "cuda", device="cpu")
    stacked = packing.stack_device_args(
        [chain_batch(port.config, 10, version=100, snapshot=50)])
    before = interop.tiered_state_to_numpy(port.state)
    port.prewarm_exact(stacked)
    after = interop.tiered_state_to_numpy(port.state)
    for a, b in zip(before, after):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert port.metrics.counters.get("groupDispatches") == 0
    assert dataclasses.asdict(port.metrics.fixpoint)["batches"] == 0
