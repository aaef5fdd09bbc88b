"""The port's staging pipeline, stage ledger and stage metrics, held
against the JAX package on the CPU.

* `resolve_stream_pipelined` (PackedBatches, chunked on the staging
  thread) and `resolve_group_stream` (pre-stacked groups) on five
  configurations: tiered exact, the latch + read dedup (with and without
  the caller's latch check), the endpoint sweep + delta spill, classic,
  and 2 shards. The same seeded batches go to JAX's `TpuConflictSet`;
  every GroupVerdict field is equal chunk by chunk, the history is equal
  row for row at the end, and so are the counters both packages keep
  alike (stagedChunks among them).
* A mid-stream HistoryOverflowError (tests/test_delta_parity.py's case)
  and a failure on the staging thread surface on the caller, with the
  `resolver-staging` thread joined.
* `stage_ledger`'s keys, and the values a run decides (merge rows, the
  tiers' live boundaries), against JAX's.
* `KernelStageMetrics.qos()`: the same keys as JAX's and the same
  counts and occupancy after the same stream.
* The port's `LatencySample` (and `Smoother`, `CounterCollection`)
  against JAX's on seeded samples: the same quantiles and dicts.

The tolerance is equality throughout: every compared value is an
integer, a bool or the same float arithmetic on the same inputs.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from foundationdb_tpu.config import KernelConfig as JaxConfig
from foundationdb_tpu.models import conflict_set as JCS
from foundationdb_tpu.parallel.mesh import cpu_mesh
from foundationdb_tpu.testing import benchgen as jax_benchgen
from foundationdb_tpu.utils import metrics as JM
from foundationdb_tpu.utils import packing as jax_packing
from foundationdb_tpu_torch import HistoryOverflowError, interop
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.models import conflict_set as PCS
from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.testing import benchgen
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import metrics as PM
from foundationdb_tpu_torch.utils import packing

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

KEY_BYTES = 8
KEYSPACE = 2000
BASE_KW = dict(max_key_bytes=KEY_BYTES, max_txns=64, max_reads=64,
               max_writes=64, history_capacity=1024, window_versions=1000,
               delta_capacity=512, compact_interval=3)

#: name -> (config overrides, stream letter)
CONFIGS = {
    "tiered exact": ({}, "uniform"),
    "latch + dedup": ({"fixpoint_latch": True, "fixpoint_unroll": 2,
                       "dedup_reads": 32}, "zipf"),
    "sweep + spill": ({"range_sweep": True, "delta_spill": True,
                       "fixpoint_latch": True, "fixpoint_unroll": 4,
                       "delta_capacity": 256, "compact_interval": 0},
                      "ycsb_e"),
    "classic": ({"delta_capacity": 0}, "uniform"),
    "2 shards": ({"n_shards": 2}, "uniform"),
}
#: the counters both packages keep alike on the tiered path (the port
#: also counts the classic group kernel's dispatches, JAX does not)
TIERED_COUNTERS = ("groupDispatches", "stagedChunks", "compactions",
                   "spills", "spillBoundAnchors", "sweepGroups",
                   "latchTrips", "exactFallbacks", "rebases",
                   "overflowRaised", "resolveBatches", "columnarBatches",
                   "warmCompiles")


def boundaries(kw):
    n = kw.get("n_shards", 0)
    return ([(KEYSPACE * i // n).to_bytes(KEY_BYTES, "big")
             for i in range(1, n)] if n > 1 else None)


def sets(kw):
    """JAX's TpuConflictSet and the port's plain path on one config."""
    b = boundaries(kw)
    if b is None:
        jax_cs = JCS.TpuConflictSet(JaxConfig(**kw))
    else:
        jax_cs = JCS.TpuConflictSet(JaxConfig(**kw),
                                    mesh=cpu_mesh(kw["n_shards"]),
                                    shard_boundaries=b)
    port = PCS.make_conflict_set(KernelConfig(**kw), "cuda", device="cpu",
                                 shard_boundaries=b)
    return jax_cs, port


def make_stream(letter, kw, n_batches, seed, start=0):
    """Both packages' generators from one seed: identical arrays."""
    pc, jc = KernelConfig(**kw), JaxConfig(**kw)
    rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    ports, jaxes = [], []
    for i in range(start, start + n_batches):
        mk = dict(version=1000 + 200 * (i + 1), snapshot_lag=300,
                  key_bytes=KEY_BYTES)
        if letter == "ycsb_e":
            mk.update(zipf=1.1, keyspace=KEYSPACE, scan_max=100)
            ports.append(benchgen.ycsb_batch(rng_t, pc, 60, letter, **mk))
            jaxes.append(jax_benchgen.ycsb_batch(rng_j, jc, 60, letter, **mk))
        else:
            mk.update(keyspace=200 if letter == "zipf" else KEYSPACE,
                      zipf=1.1 if letter == "zipf" else 0.0)
            ports.append(benchgen.skiplist_style_batch(rng_t, pc, 60, **mk))
            jaxes.append(jax_benchgen.skiplist_style_batch(rng_j, jc, 60,
                                                           **mk))
    for a, b in zip(ports, jaxes):
        for k, v in b.device_args().items():
            assert np.array_equal(a.device_args()[k], np.asarray(v)), k
    return ports, jaxes


def np_of(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_fields(got, want, skip_verdicts=False):
    for f in want._fields:
        if skip_verdicts and f not in ("unconverged",):
            continue
        assert np.array_equal(np_of(getattr(got, f)),
                              np.asarray(getattr(want, f))), f


def assert_history(port, jax_cs):
    got = port.store_state()[0]
    st = jax_cs.state
    if port.tiered:
        tiers = zip(got, (st.main, st.delta))
    else:
        tiers = [(got, st)]
    for mine, theirs in tiers:
        for a, b in zip(mine, theirs):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def assert_counters(port, jax_cs, names):
    for name in names:
        assert port.metrics.counters.get(name) == jax_cs.metrics.counters.get(
            name), name


@pytest.mark.parametrize("api", ["stream", "groups"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pipeline_matches_jax(name, api):
    over, letter = CONFIGS[name]
    kw = {**BASE_KW, **over}
    ports, jaxes = make_stream(letter, kw, 9, seed=sorted(CONFIGS).index(name))
    jax_cs, port = sets(kw)
    latched = bool(kw.get("fixpoint_latch") or kw.get("dedup_reads"))
    if api == "stream":
        want = jax_cs.resolve_stream_pipelined(jaxes, chunk=3, depth=2,
                                               check_latch=latched)
        got = port.resolve_stream_pipelined(ports, chunk=3, depth=2,
                                            check_latch=latched)
    else:
        want = jax_cs.resolve_group_stream(
            [jax_packing.stack_device_args(jaxes[i:i + 3])
             for i in range(0, 9, 3)])
        got = port.resolve_group_stream(
            [packing.stack_device_args(ports[i:i + 3])
             for i in range(0, 9, 3)])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_fields(g, w)
    assert_history(port, jax_cs)
    assert port.metrics.counters.get("stagedChunks") == 3
    assert_counters(port, jax_cs, ("stagedChunks",) if name == "classic"
                    else TIERED_COUNTERS)
    assert port.metrics.pack.count == port.metrics.transfer.count == 3
    if latched:
        # the stream reaches the latch: a fallback on both sides
        assert port.metrics.counters.get("latchTrips") > 0
    assert sum(int(np_of(g.conflict_count).sum()) for g in got) > 0


def test_refused_chunks_come_back_unconverged():
    """check_latch=False (the pipelined default): a chunk the latch or
    the dedup cap refuses comes back `unconverged` on both sides, the
    history unchanged, and the caller's fallback gives JAX's results."""
    kw = {**BASE_KW, **CONFIGS["latch + dedup"][0], "dedup_reads": 8,
          "compact_interval": 0}
    ports, jaxes = make_stream("zipf", kw, 6, seed=4)
    jax_cs, port = sets(kw)
    want = jax_cs.resolve_stream_pipelined(jaxes, chunk=3)
    got = port.resolve_stream_pipelined(ports, chunk=3)
    for g, w in zip(got, want):
        assert np.asarray(w.unconverged).all()
        assert_fields(g, w, skip_verdicts=True)
    assert_history(port, jax_cs)
    assert port.metrics.counters.get("latchTrips") == 0
    exact = {**kw, "fixpoint_latch": False, "dedup_reads": 0}
    jax_ex, port_ex = sets(exact)
    for g, w in zip(port_ex.resolve_stream_pipelined(ports, chunk=3),
                    jax_ex.resolve_stream_pipelined(jaxes, chunk=3)):
        assert_fields(g, w)


def staging_threads() -> list:
    return [t for t in threading.enumerate() if t.name == "resolver-staging"]


def overflow_batches(pack, cfg):
    """tests/test_delta_parity.py:342's stream: blind writes of fresh
    keys past an 8-row delta tier that never compacts."""
    def k(i):
        return bytes([i % 250])

    out = []
    for i in range(3 * PCS.OVERFLOW_CHECK_INTERVAL):
        txns = [([], [(k(3 * j + i), k(3 * j + i) + b"\x01")])
                for j in range(8)]
        out.append(pack(txns, 100 + i, cfg))
    return out


def test_overflow_mid_stream_joins_the_staging_thread():
    kw = {**BASE_KW, "max_txns": 8, "max_reads": 8, "max_writes": 8,
          "delta_capacity": 8, "compact_interval": 0,
          "window_versions": 100_000}
    from foundationdb_tpu.models.types import CommitTransaction as JaxTxn

    jb = overflow_batches(
        lambda t, v, c: jax_packing.pack_batch(
            [JaxTxn(r, w, read_snapshot=50) for r, w in t], v, 0, c),
        JaxConfig(**kw))
    pb = overflow_batches(
        lambda t, v, c: packing.pack_batch(
            [CommitTransaction(r, w, read_snapshot=50) for r, w in t],
            v, 0, c),
        KernelConfig(**kw))
    jax_cs, port = sets(kw)
    with pytest.raises(JCS.HistoryOverflowError):
        jax_cs.resolve_stream_pipelined(jb, chunk=1, check_latch=False)
    with pytest.raises(HistoryOverflowError):
        port.resolve_stream_pipelined(pb, chunk=1, check_latch=False)
    assert not staging_threads()
    assert (port.metrics.counters.get("overflowRaised")
            == jax_cs.metrics.counters.get("overflowRaised") == 1)


def test_staging_failure_surfaces_on_the_caller():
    """pack_fn fails on the staging thread (a chunk whose versions do
    not ascend): the error is raised here, after the chunks before it
    were resolved, and the thread is joined."""
    kw = {**BASE_KW}
    ports, _ = make_stream("uniform", kw, 6, seed=8)
    _, port = sets(kw)
    bad = ports[:3] + [ports[5], ports[4], ports[3]]
    with pytest.raises(ValueError, match="ascend"):
        port.resolve_stream_pipelined(bad, chunk=3)
    assert not staging_threads()
    assert port.metrics.counters.get("groupDispatches") == 1


def test_empty_stream():
    _, port = sets(dict(BASE_KW))
    assert port.resolve_stream_pipelined([]) == []
    assert port.resolve_group_stream([]) == []


def test_stager_on_the_cpu_is_the_plain_copy():
    """On a CPU set the pipeline runs the same thread and queue with no
    streams: a chunk is `device_args_to_torch`, no event."""
    ports, _ = make_stream("uniform", dict(BASE_KW), 2, seed=1)
    st = interop.Stager("cpu", depth=2)
    host = packing.stack_device_args(ports)
    args, event = st.send(st.fill(packing.group_args(ports), stack=True))
    assert event is None and st.stream is None and st.n_slots == 3
    want = interop.device_args_to_torch(host, "cpu")
    assert st.receive(args, event) is args
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(args[k], v), k
        else:
            assert np.array_equal(args[k], v), k


def test_slab_layout_round_trip():
    """The Stager's slab arithmetic, on a CPU slab: every array lands at
    an aligned offset and its view reads back the argument as
    `device_args_to_torch` gives it (uint32 keys as int32, bools,
    int32), for a stacked group placed as it is and for its batches
    stacked in the slab; the HOST_ARGS stay numpy; a smaller chunk fits
    the slab a larger one sized."""
    ports, _ = make_stream("ycsb_e", dict(BASE_KW), 3, seed=2)
    group = packing.stack_device_args(ports)
    _, _, size = interop.slab_layout([group], False)
    slab = torch.zeros(size, dtype=torch.uint8)
    cases = [([group], False, group),
             (packing.group_args(ports), True, group),
             (packing.group_args(ports[:1]), True,
              packing.stack_device_args(ports[:1]))]
    for parts, stack, args in cases:
        scalars, layout, used = interop.slab_layout(parts, stack)
        assert used <= size
        assert all(off % interop.SLAB_ALIGN == 0 for *_, off in layout)
        slab.zero_()
        interop.fill_slab(slab.numpy(), layout)
        views = interop.slab_views(slab, layout)
        want = interop.device_args_to_torch(args, "cpu")
        assert set(scalars) == set(interop.HOST_ARGS)
        for k, v in want.items():
            if k in interop.HOST_ARGS:
                assert np.array_equal(scalars[k], v), k
            else:
                assert views[k].dtype == v.dtype, k
                assert views[k].is_contiguous(), k
                assert torch.equal(views[k], v), k


# ---------------------------------------------------------------------------
# the stage ledger

DETERMINISTIC_LEDGER = ("merge_rows_classic_per_group",
                        "merge_rows_tiered_per_batch_cap",
                        "merge_rows_tiered_per_batch_live",
                        "delta_live_boundaries", "main_live_boundaries")


@pytest.mark.parametrize("name", ["tiered exact", "classic"])
def test_stage_ledger_matches_jax(name):
    over, letter = CONFIGS[name]
    kw = {**BASE_KW, **over}
    ports, jaxes = make_stream(letter, kw, 6, seed=3)
    want = JCS.stage_ledger(JaxConfig(**kw), jaxes, fuse=3, kernel_s=0.5,
                            pipelined_s=0.25, occupancy_delta_capacity=2048)
    got = PCS.stage_ledger(KernelConfig(**kw), ports, fuse=3, kernel_s=0.5,
                           pipelined_s=0.25, occupancy_delta_capacity=2048,
                           device="cpu")
    assert set(got) == set(want)
    for key in DETERMINISTIC_LEDGER:
        if key in want:
            assert got[key] == want[key], key
    assert got["kernel_ms_per_group"] == 0.5 / 2 * 1e3
    assert got["pipelined_ms_per_group"] == 0.25 / 2 * 1e3
    for key in ("pack_ms_per_group", "transfer_ms_per_group",
                "fence_ms_per_group"):
        assert got[key] >= 0.0
    if name == "tiered exact":
        assert got["delta_live_boundaries"] > 0


# ---------------------------------------------------------------------------
# qos() and the metrics classes

def test_qos_matches_jax_after_the_same_stream():
    """resolve() batches, then a pipelined stream and an overflow check
    on both sides: qos() has JAX's keys, and its counts, occupancy and
    device gauges are JAX's (the wall-clock entries only present)."""
    kw = {**BASE_KW, **CONFIGS["sweep + spill"][0]}
    ports, jaxes = make_stream("ycsb_e", kw, 6, seed=12)
    jax_cs, port = sets(kw)
    rng = np.random.default_rng(2)
    for i in range(3):
        version = 900 + 30 * i
        keys = [bytes([int(x)]) for x in rng.integers(1, 200, 20)]
        rows = [([(k, k + b"\x00")], [(k, k + b"\x01")], version - 40)
                for k in keys]
        from foundationdb_tpu.models.types import CommitTransaction as JaxTxn

        w = jax_cs.resolve([JaxTxn(r, w_, s) for r, w_, s in rows], version)
        g = port.resolve([CommitTransaction(r, w_, s) for r, w_, s in rows],
                         version)
        assert [int(v) for v in g.verdicts] == [int(v) for v in w.verdicts]
    jax_cs.resolve_stream_pipelined(jaxes, chunk=2)
    port.resolve_stream_pipelined(ports, chunk=2)
    jax_cs.check_overflow()
    port.check_overflow()
    want, got = jax_cs.metrics.qos(), port.metrics.qos()
    assert set(got) == set(want)
    assert set(got["stage_p99_seconds"]) == set(want["stage_p99_seconds"])
    wall = ("kernel_seconds_per_batch", "kernel_p99_seconds",
            "stage_p99_seconds", "compile_seconds", "compile_cache_hits",
            "compile_cache_misses", "last_compile_seconds",
            "collective_time_share")
    assert ({k: v for k, v in got.items() if k not in wall}
            == {k: v for k, v in want.items() if k not in wall})
    assert got["batches"] == 3 and got["spills"] > 0
    assert got["sweep_groups"] == 6 and got["delta_occupancy"] > 0
    assert_counters(port, jax_cs, TIERED_COUNTERS)
    assert got["stage_p99_seconds"]["transfer"] > 0.0
    d = port.metrics.as_dict()
    for name in ("compileSeconds", "transferSeconds", "packSeconds"):
        assert set(d[name]) == {"count", "mean", "p50", "p95", "p99", "max"}
    assert "fixpoint" in d and d["stagedChunks"] == 3


def test_prewarm_on_the_cpu_records_nothing():
    """prewarm_exact builds and loads the kernel libraries on the card
    (the `compile` stage, warmCompiles); on the CPU it has nothing to
    do and records nothing, as JAX's records nothing there."""
    _, port = sets({**BASE_KW, "fixpoint_latch": True})
    port.prewarm_exact(None)
    assert port.metrics.compile.count == 0
    assert port.metrics.counters.get("warmCompiles") == 0


SAMPLE_SETS = {
    "latencies": lambda r: r.lognormal(-7, 1.5, 2000),
    "with zeros and negatives": lambda r: np.concatenate(
        [r.exponential(1e-3, 300), np.zeros(40), -r.random(5)]),
    "integers": lambda r: r.integers(0, 5000, 700).astype(float),
    "one": lambda r: np.array([3.5]),
    "none": lambda r: np.array([]),
}


@pytest.mark.parametrize("eps", [0.01, 0.05])
@pytest.mark.parametrize("name", sorted(SAMPLE_SETS))
def test_latency_sample_matches_jax(name, eps):
    values = SAMPLE_SETS[name](np.random.default_rng(len(name)))
    a, b = PM.LatencySample("x", eps), JM.LatencySample("x", eps)
    for v in values:
        a.sample(float(v))
        b.sample(float(v))
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
        assert a.quantile(q) == b.quantile(q), q
    assert a.as_dict() == b.as_dict()
    assert (a.count, a.total, a.min, a.max) == (b.count, b.total, b.min,
                                                b.max)


def test_smoother_and_counters_match_jax():
    clock = [0.0]
    a = PM.Smoother(2.0, clock=lambda: clock[0])
    b = JM.Smoother(2.0, clock=lambda: clock[0])
    rng = np.random.default_rng(5)
    for _ in range(200):
        clock[0] += float(rng.exponential(0.3))
        d = float(rng.random())
        a.add_delta(d)
        b.add_delta(d)
        assert a.smooth_rate() == b.smooth_rate()
        assert a.smooth_total() == b.smooth_total()
    ca = PM.CounterCollection("c", ["x", "y"])
    cb = JM.CounterCollection("c", ["x", "y"])
    for name in ("x", "z", "x", "y"):
        ca.add(name, 3)
        cb.add(name, 3)
    assert ca.as_dict() == cb.as_dict() and ca.get("x") == 6
