"""The port's full-client ApiCorrectness workload against the JAX one.

`ApiWorkload` (testing/api_workload.py) drives the real client API on
`open_cluster` and cross-checks every read and every commit/abort
decision against `SequentialModel` (testing/oracle.py). Here the same
seeded run goes through the JAX package's cluster and the port's, on
"cpu" against "cpu" and on the port's "cuda" (its plain PyTorch
versions, device="cpu") against the JAX "tpu-force": the signature and
the stats are equal. The corruption self-test and the checker's
self-tests fail the port's run as they fail the JAX one's.
"""

from __future__ import annotations

import types

import pytest

import foundationdb_tpu.cluster.commit_proxy as j_cp
import foundationdb_tpu.cluster.database as j_db
import foundationdb_tpu.runtime.flow as j_flow
import foundationdb_tpu.testing.api_workload as j_api
import foundationdb_tpu.testing.oracle as j_oracle
import foundationdb_tpu_torch.cluster.commit_proxy as p_cp
import foundationdb_tpu_torch.cluster.database as p_db
import foundationdb_tpu_torch.runtime.flow as p_flow
import foundationdb_tpu_torch.testing.api_workload as p_api
import foundationdb_tpu_torch.testing.oracle as p_oracle
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

JAX = types.SimpleNamespace(db=j_db, flow=j_flow, api=j_api, cp=j_cp,
                            oracle=j_oracle, device={})
PORT = types.SimpleNamespace(db=p_db, flow=p_flow, api=p_api, cp=p_cp,
                             oracle=p_oracle, device={"device": "cpu"})
#: (JAX backend, port backend)
BACKENDS = [("cpu", "cpu"), ("tpu-force", "cuda")]


def _stamp(version: int, order: int = 0) -> bytes:
    return version.to_bytes(8, "big") + order.to_bytes(2, "big")


def run_api(ns, seed=5, backend="cpu", *, actors=3, rounds=10,
            corrupt=False, sabotage_first_commit=False):
    """tests/test_api_workload.py's run_api, written once against a
    package namespace."""
    sched, cluster, db = ns.db.open_cluster(
        ns.db.ClusterConfig(
            n_commit_proxies=2, n_resolvers=2, n_storage=2,
            sim_seed=seed, resolver_backend=backend, **ns.device,
        )
    )
    try:
        if sabotage_first_commit:
            proxy = cluster.commit_proxies[0]
            real_commit = proxy.commit
            fired = []

            def sabotaged_commit(ctr):
                p = real_commit(ctr)
                if not fired:
                    fired.append(True)
                    broken = ns.flow.Promise()

                    def relay(f):
                        if not broken.is_set:
                            broken.send_error(ns.cp.CommitUnknownResult())

                    p.future.add_done_callback(relay)
                    return broken
                return p

            proxy.commit = sabotaged_commit
        api = ns.api.ApiWorkload(sched, db, seed, actors=actors,
                                 rounds=rounds, strict_aborts=True)
        tasks = [sched.spawn(c, name=f"api-{i}").done
                 for i, c in enumerate(api.actor_coros())]
        sched.run_until(ns.flow.all_of(tasks))
        sched.run_for(1.0)
        if corrupt:
            api.corrupt_for_selftest(cluster)
        sched.run_until(sched.spawn(api.verify()).done)
        return api, sched.now()
    finally:
        cluster.stop()


@pytest.mark.parametrize("jb,pb", BACKENDS, ids=["cpu", "cuda"])
@pytest.mark.parametrize("seed", [5, 8])
def test_api_workload_equals_jax(seed, jb, pb):
    rounds = 10 if jb == "cpu" else 6
    j, j_now = run_api(JAX, seed, jb, rounds=rounds)
    p, p_now = run_api(PORT, seed, pb, rounds=rounds)
    assert p.stats["acked"] > 0 and p.stats["reads_checked"] > 0
    assert p.signature() == j.signature()
    assert p.stats == j.stats
    assert p_now == j_now


def test_api_workload_surface_and_conflicts():
    """The port's workload reaches the surface it claims to check, with
    the JAX generator's op stream (the records' ops equal)."""
    kinds, conflicts = set(), 0
    for seed in (6, 7):
        p, _ = run_api(PORT, seed)
        j, _ = run_api(JAX, seed)
        assert [r.ops for r in p.records] == [r.ops for r in j.records]
        conflicts += p.stats["conflict"]
        for rec in p.records:
            for op, _obs in rec.ops:
                k = op[0]
                if k == "range" and op[4]:
                    k = "range.reverse"
                elif k == "get" and op[2]:
                    k = "get.snapshot"
                kinds.add(k)
    assert conflicts > 0
    for needed in ("get", "get.snapshot", "range", "range.reverse", "set",
                   "clear_range", "atomic", "vs_value", "vs_key"):
        assert needed in kinds, needed


def test_injected_divergence_fails_the_run_as_jax():
    for ns in (JAX, PORT):
        with pytest.raises(AssertionError, match="api model divergence"):
            run_api(ns, seed=5, corrupt=True)


def test_unknown_result_resolved_by_marker_as_jax():
    p, _ = run_api(PORT, seed=11, sabotage_first_commit=True)
    j, _ = run_api(JAX, seed=11, sabotage_first_commit=True)
    assert p.stats["unknown"] >= 1 and p.stats["unknown_resolved"] >= 1
    assert p.stats == j.stats and p.signature() == j.signature()


@pytest.mark.parametrize("ns", [JAX, PORT], ids=["jax", "port"])
def test_checker_self_tests(ns):
    """The false-commit, false-abort, read-divergence and conflict-range
    audits fire in both packages on the same fabricated records."""
    A, DATA = ns.api, ns.api.DATA
    api = A.ApiWorkload(None, None, 0)
    writer = A.TxnRecord(actor=0, n=0)
    writer.outcome, writer.read_version = "acked", 1
    writer.write_conflicts = [(DATA + b"05", DATA + b"05\x00")]
    reader = A.TxnRecord(actor=1, n=0)
    reader.outcome, reader.read_version = "acked", 5
    reader.read_conflicts = [(DATA + b"00", DATA + b"09")]
    reader.write_conflicts = [(DATA + b"20", DATA + b"20\x00")]
    committed = [(_stamp(8), writer), (_stamp(12), reader)]
    with pytest.raises(AssertionError, match="FALSE COMMIT"):
        api._check_decisions(committed)
    reader.read_version = 9
    api._check_decisions(committed)

    strict = A.ApiWorkload(None, None, 0, strict_aborts=True)
    aborted = A.TxnRecord(actor=0, n=0)
    aborted.outcome, aborted.read_version = "conflict", 5
    aborted.read_conflicts = [(DATA + b"00", DATA + b"01")]
    strict.records = [aborted]
    with pytest.raises(AssertionError, match="FALSE ABORT"):
        strict._check_decisions([])
    w2 = A.TxnRecord(actor=1, n=0)
    w2.outcome, w2.read_version = "acked", 1
    w2.write_conflicts = [(DATA + b"00", DATA + b"00\x00")]
    strict._check_decisions([(_stamp(9), w2)])

    model = ns.oracle.SequentialModel()
    model.apply(_stamp(5), [("set", DATA + b"00", b"truth")])
    rec = A.TxnRecord(actor=0, n=0)
    rec.outcome, rec.read_version = "conflict", 7
    rec.ops = [(("get", DATA + b"00", False), b"LIES")]
    rec.read_conflicts = [(DATA + b"00", DATA + b"00\x00")]
    with pytest.raises(AssertionError, match="model says"):
        api._check_txn(rec, model)
    rec.ops = [(("get", DATA + b"00", False), b"truth")]
    api._check_txn(rec, model)
    rec.read_conflicts = []
    with pytest.raises(AssertionError, match="read-conflict contract"):
        api._check_txn(rec, model)


def test_sequential_model_equals_jax():
    muts = [
        (_stamp(20, 1), [("set", b"api/k/a", b"late")]),
        (_stamp(10), [("set", b"api/k/a", b"early"),
                      ("vs_key", b"api/vs/p", b"/sfx", b"vk"),
                      ("vs_value", b"api/k/b", b"pre-"),
                      ("clear", b"api/k/z", b"api/k/zz")]),
        (_stamp(20, 0), [("atomic", "add", b"api/k/c", b"\x05"),
                         ("atomic", "max", b"api/k/d", b"\x07\x00")]),
        (_stamp(30, 2), [("clear", b"api/k/a", b"api/k/b")]),
    ]
    p, j = p_oracle.SequentialModel(), j_oracle.SequentialModel()
    for stamp, m in muts:
        p.apply(stamp, m)
        j.apply(stamp, m)
    for v in (0, 9, 10, 19, 20, 29, 30, 1 << 40):
        assert p.state_at(v) == j.state_at(v)
    assert p.final_state() == j.final_state() and p.stamps() == j.stamps()
    assert p.state_at(10)[b"api/vs/p" + _stamp(10) + b"/sfx"] == b"vk"
    with pytest.raises(ValueError):
        p.apply(_stamp(10), [])
    with pytest.raises(ValueError):
        p.apply(b"short", [])


@pytest.mark.parametrize("kw", [
    {}, {"zipf": 1.2, "stale_fraction": 0.2, "n_txns": 48},
    {"key_width": 4, "point_fraction": 0.0, "blind_write_fraction": 0.5},
], ids=["default", "zipf-stale", "ranges-blind"])
def test_workload_batches_equal_jax(kw):
    """testing/workloads.make_batch draws the JAX generator's batches."""
    import numpy as np

    import foundationdb_tpu.testing.workloads as j_wl
    import foundationdb_tpu_torch.testing.workloads as p_wl

    for seed in range(3):
        p = p_wl.make_batch(np.random.default_rng(seed),
                            p_wl.WorkloadConfig(**kw), 1_000, 100)
        j = j_wl.make_batch(np.random.default_rng(seed),
                            j_wl.WorkloadConfig(**kw), 1_000, 100)
        assert [(t.read_conflict_ranges, t.write_conflict_ranges,
                 t.read_snapshot, t.report_conflicting_keys) for t in p] == [
            (t.read_conflict_ranges, t.write_conflict_ranges,
             t.read_snapshot, t.report_conflicting_keys) for t in j]
