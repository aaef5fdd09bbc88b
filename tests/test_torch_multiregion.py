"""The port's multi-region failover (`cluster/multiregion.py`:
`LogRouter`, `RemoteDC`) held against the JAX package's on the CPU.

Twins (tests/twins.py) of every test of tests/test_multiregion.py,
written once against a package namespace and run through both pairs of
backends: a remote DC fed by a log router, its lag, a graceful failover,
a primary death served at the router's watermark, and with satellite
logs a whole-primary-DC death that loses no acknowledged commit (RPO 0),
also after one satellite died. The digest holds the remote storages'
snapshots beside the cluster's; the multi-region probes are seen firing
in a twin.
"""

from __future__ import annotations

import pytest

from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from twins import PAIR_IDS, PAIRS, check_twin, norm

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

TWINS = {}


def twin(fn):
    TWINS[fn.__name__] = fn
    return fn


def _remote_view(remote):
    return [norm(s.snapshot()) for s in remote.storages], \
        remote.logs.version.get(), remote.router.pulled_version


def _workload(db, committed, prefix, val, n0, n1, mod):
    async def go():
        for i in range(n0, n1):
            txn = db.create_transaction()
            k = prefix % (i % mod)
            v = val % i
            txn.set(k, v)
            await txn.commit()
            committed[k] = (txn.committed_version, v)
    return go()


@twin
def remote_dc_replicates_and_fails_over(w):
    sched, cluster, db = w.open(n_storage=2)
    remote = w.P.multiregion.RemoteDC(
        sched, cluster.tlog, n_tlogs=2, n_storage=2,
        storage_boundaries=[b"m"])
    remote.start()
    committed = {}
    w.run(sched, _workload(db, committed, b"mr%02d", b"v%d", 0, 25, 12))
    w.run(sched, remote.wait_caught_up())
    assert remote.lag() == 0
    takeover = w.run(sched, remote.failover())
    for k, (vc, v) in committed.items():
        assert vc <= takeover
        assert w.run(sched, remote.read_at(k, takeover)) == v
    return takeover, committed, _remote_view(remote)


@twin
def remote_dc_bounded_lag_during_load(w):
    sched, cluster, db = w.open(n_storage=2)
    remote = w.P.multiregion.RemoteDC(sched, cluster.tlog, n_tlogs=1,
                                      n_storage=1)
    remote.start()
    committed = {}
    w.run(sched, _workload(db, committed, b"lag%02d", b"x%d", 0, 30, 8))
    w.run(sched, remote.wait_caught_up())
    assert remote.lag() == 0
    view = _remote_view(remote)
    remote.stop()
    return committed, view


@twin
def remote_dc_primary_death_serves_watermark_prefix(w):
    sched, cluster, db = w.open(n_storage=2)
    remote = w.P.multiregion.RemoteDC(sched, cluster.tlog, n_tlogs=1,
                                      n_storage=2, storage_boundaries=[b"m"])
    remote.start()
    committed = {}
    w.run(sched, _workload(db, committed, b"pd%02d", b"w%d", 0, 20, 10))
    w.run(sched, remote.wait_caught_up())
    cluster.tlog.live = [False] * len(cluster.tlog.live)
    takeover = w.run(sched, remote.failover())
    reads = {}
    for k, (vc, v) in committed.items():
        if vc <= takeover:
            reads[k] = w.run(sched, remote.read_at(k, takeover))
            assert reads[k] == v
    return takeover, reads, _remote_view(remote)


@twin
def satellite_logs_rpo_zero_on_primary_dc_death(w):
    sched, cluster, db = w.open(n_storage=2, n_tlogs=2, n_satellite_logs=2)
    remote = w.P.multiregion.RemoteDC(sched, cluster.tlog, n_tlogs=1,
                                      n_storage=2, storage_boundaries=[b"m"])
    remote.start()
    committed = {}
    w.run(sched, _workload(db, committed, b"sat%02d", b"s%d", 0, 10, 10))
    w.run(sched, remote.wait_caught_up())
    remote.router._task.cancel()
    remote.router._task = None
    w.run(sched, _workload(db, committed, b"sat%02d", b"s%d", 10, 25, 10))
    last_acked = max(v for v, _ in committed.values())
    behind = remote.logs.version.get()
    assert behind < last_acked
    cluster.tlog.kill_dc()
    takeover = w.run(sched, remote.failover())
    assert takeover >= last_acked
    for k, (_vc, v) in committed.items():
        assert w.run(sched, remote.read_at(k, takeover)) == v
    return behind, takeover, committed, _remote_view(remote)


@twin
def satellite_death_does_not_lose_acked_data(w):
    sched, cluster, db = w.open(n_storage=1, n_tlogs=1, n_satellite_logs=2)
    remote = w.P.multiregion.RemoteDC(sched, cluster.tlog, n_tlogs=1,
                                      n_storage=1)
    remote.start()
    committed = {}
    w.run(sched, _workload(db, committed, b"sd%02d", b"d%d", 0, 8, 6))
    cluster.tlog.kill_satellite(0)
    remote.router._task.cancel()
    remote.router._task = None
    w.run(sched, _workload(db, committed, b"sd%02d", b"d%d", 8, 16, 6))
    cluster.tlog.kill_dc()
    takeover = w.run(sched, remote.failover())
    assert takeover >= max(v for v, _ in committed.values())
    for k, (_vc, v) in committed.items():
        assert w.run(sched, remote.read_at(k, takeover)) == v
    return takeover, committed, _remote_view(remote)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("name", list(TWINS))
def test_twin(name, pair):
    check_twin(TWINS[name], pair)


def test_twins_cover_their_sources():
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).parent / "test_multiregion.py")
                     .read_text())
    names = {n.name.removeprefix("test_") for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    assert names == set(TWINS)


def test_multiregion_probes_fire_in_a_twin():
    """multiregion.failover, .router_caught_up and .satellite_recovery
    fire in the port's run of the satellite twin, as in JAX's."""
    hits = check_twin(TWINS["satellite_logs_rpo_zero_on_primary_dc_death"],
                      PAIRS[0])["probes"]
    want = {"multiregion.failover", "multiregion.router_caught_up",
            "multiregion.satellite_recovery"}
    assert want <= set(hits), hits
