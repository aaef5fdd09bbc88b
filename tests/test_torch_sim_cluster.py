"""The port's simulated cluster (`open_cluster`), held against the JAX
package's on the CPU: one harness, two packages.

Every scenario is written once against a package namespace (`P.database`,
`P.client`, ... from either `foundationdb_tpu` or `foundationdb_tpu_torch`)
and run through both. Each run yields a digest: every client-visible
result (commit versions or error class names, point and range reads,
versionstamps), each storage server's snapshot, each log replica's
durable records and in-memory entries, the sequencer's versions, every
role's counters and the final virtual time. The digests must be equal:
the JAX run on "cpu" (or "tpu-force", its kernels on the CPU) against the
port on "cuda" with device="cpu" (the plain PyTorch versions of the
kernels) and on "cpu". The scenarios are taken from the JAX package's
own tests; each names its source.

Also here: the construction rules of the port's ClusterConfig (a "cuda"
backend on the card raises without one; the default knob route logs
ResolverBackendAutoRouted and resolves on the host oracle), a DR
destination's commit lock (the port's DestinationLockedError where JAX
raises its own), and the status document the client serves.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import json
import random
import types

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

JAX = "foundationdb_tpu"
PORT = "foundationdb_tpu_torch"

_MODULES = {
    "database": "cluster.database",
    "commit_proxy": "cluster.commit_proxy",
    "consistency": "cluster.consistency",
    "locality": "cluster.locality",
    "tss": "cluster.tss",
    "flow": "runtime.flow",
    "trace": "utils.trace",
}


def ns(pkg: str) -> types.SimpleNamespace:
    """The package's modules under one namespace."""
    return types.SimpleNamespace(
        name=pkg,
        **{k: importlib.import_module(f"{pkg}.{m}")
           for k, m in _MODULES.items()},
    )


def norm(x):
    """A package-independent form of a value: dataclasses by class name
    and fields, enums by value, errors by class name."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple(
            (f.name, norm(getattr(x, f.name))) for f in dataclasses.fields(x)
        ))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, BaseException):
        return ("error", type(x).__name__)
    if isinstance(x, dict):
        return ("dict", tuple((norm(k), norm(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(norm(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted((norm(v) for v in x), key=repr)))
    return x


def _log_digest(t):
    dq = t.dq
    return {
        "version": t.version.get(),
        "epoch": t.epoch,
        "durable": None if dq is None else [
            (r.seq, r.is_pop, r.pop_to, r.data) for r in dq._disk
        ],
        "messages": norm(t._messages),
        "spilled": norm(t._spilled),
        "popped": norm(t._popped),
    }


def digest(sched, cluster, results) -> dict:
    """Everything the scenario's run left visible."""
    counters = {"grv_proxy": cluster.grv_proxy.counters.as_dict()}
    for p in cluster.commit_proxies:
        counters[p.proxy_id] = p.counters.as_dict()
    for r in cluster.resolvers:
        counters[f"resolver{r.resolver_id}"] = r.counters.as_dict()
    for name in ("ratekeeper", "balancer", "controller", "data_distributor"):
        counters[name] = getattr(cluster, name).counters.as_dict()
    return {
        "results": norm(results),
        "storage": [norm(ss.snapshot()) for ss in cluster.storage_servers],
        "tss": [norm(ss.snapshot()) for ss in cluster.tss_servers.values()],
        "logs": [_log_digest(t) for t in cluster.tlog.tlogs],
        "satellites": [_log_digest(t) for t in cluster.tlog.satellites],
        "sequencer": (cluster.sequencer.version,
                      cluster.sequencer.committed_version.get(),
                      cluster.sequencer.live_committed.get()),
        "key_servers": norm(list(cluster.key_servers.ranges())),
        "counters": counters,
        "epoch": cluster.controller.epoch,
        "unhandled": sorted((name, type(e).__name__)
                            for name, e in sched.unhandled_errors()),
        "now": sched.now(),
    }


def run(sched, coro):
    return sched.run_until(sched.spawn(coro).done)


async def outcome(coro):
    """A coroutine's result, or its error's class name."""
    try:
        return ("ok", await coro)
    except Exception as e:  # noqa: BLE001 - the class is the result
        return ("err", type(e).__name__)


async def commit(txn):
    """A commit's version, or its error's class name."""
    try:
        await txn.commit()
        return ("committed", txn.committed_version)
    except Exception as e:  # noqa: BLE001
        return ("err", type(e).__name__)


def run_scenario(pkg: str, backend: str, scn) -> tuple[dict, list]:
    """Build the scenario's cluster with `pkg` on `backend`, run it, and
    return its digest and its resolvers' conflict-set class names (over
    every generation)."""
    P = ns(pkg)
    kw = dict(scn.config(P), resolver_backend=backend)
    if pkg == PORT:
        kw["device"] = "cpu"
    sched, cluster, db = P.database.open_cluster(
        P.database.ClusterConfig(**kw))
    sets = [type(r.conflict_set).__name__ for r in cluster.resolvers]
    try:
        results = scn.body(P, sched, cluster, db)
        sets += [type(r.conflict_set).__name__ for r in cluster.resolvers]
        return digest(sched, cluster, results), sets
    finally:
        cluster.stop()


# ---------------------------------------------------------------------------
# The scenarios


@dataclasses.dataclass
class Scenario:
    name: str
    config: object  # P -> ClusterConfig keyword arguments
    body: object    # (P, sched, cluster, db) -> results
    jax_backend: str = "cpu"


SCENARIOS: list[Scenario] = []


def scenario(config, jax_backend="cpu"):
    def deco(fn):
        SCENARIOS.append(Scenario(fn.__name__, config, fn, jax_backend))
        return fn
    return deco


@scenario(lambda P: dict(n_commit_proxies=2, n_resolvers=2, n_storage=2))
def cluster_basics(P, sched, cluster, db):
    """tests/test_cluster.py: set/get across shards, read-your-writes,
    conflicting writers (one aborts), range reads and clears, a snapshot
    read that adds no conflict."""
    async def body():
        out = []
        txn = db.create_transaction()
        txn.set(b"hello", b"world")
        txn.set(b"\xf0zzz", b"far-shard")
        out.append(await commit(txn))
        txn = db.create_transaction()
        out += [await txn.get(b"hello"), await txn.get(b"\xf0zzz"),
                await txn.get(b"nope")]

        txn = db.create_transaction()
        txn.set(b"ryw", b"BEFORE")
        out.append(await commit(txn))
        txn = db.create_transaction()
        out.append(await txn.get(b"ryw"))
        txn.set(b"ryw", b"AFTER")
        out.append(await txn.get(b"ryw"))
        txn.clear(b"ryw")
        out.append(await txn.get(b"ryw"))
        out.append(await commit(txn))

        init = db.create_transaction()
        init.set(b"ctr", b"0")
        out.append(await commit(init))
        t1, t2 = db.create_transaction(), db.create_transaction()
        v1, v2 = await t1.get(b"ctr"), await t2.get(b"ctr")
        t1.set(b"ctr", str(int(v1) + 1).encode())
        t2.set(b"ctr", str(int(v2) + 1).encode())
        out += [await commit(t1), await commit(t2)]

        txn = db.create_transaction()
        for i in range(10):
            txn.set(b"r%03d" % i, b"v%d" % i)
        out.append(await commit(txn))
        txn = db.create_transaction()
        out.append(await txn.get_range(b"r000", b"r005"))
        txn.clear_range(b"r002", b"r008")
        out.append(await txn.get_range(b"r000", b"r010"))
        out.append(await commit(txn))
        out.append(await db.create_transaction().get_range(b"r", b"s"))

        t1 = db.create_transaction()
        out.append(await t1.get(b"ryw", snapshot=True))
        t2 = db.create_transaction()
        t2.set(b"ryw", b"1")
        out.append(await commit(t2))
        t1.set(b"other", b"x")
        out.append(await commit(t1))
        return out

    out = run(sched, body())
    assert out[1:4] == [b"world", b"far-shard", None]
    assert out[11] == ("err", "NotCommitted")
    return out


@scenario(lambda P: dict(n_commit_proxies=2, n_resolvers=2, n_storage=2))
def cycle_workload(P, sched, cluster, db):
    """tests/test_cluster.py::test_cycle_workload_invariant: twelve
    concurrent pointer-rotating transactions through the retry loop keep
    one 8-cycle."""
    n = 8

    def key(i):
        return b"cycle/%02d" % i

    async def swap(txn):
        r = random.Random(sched.now())
        a = r.randrange(n)
        b = int(await txn.get(key(a)))
        c = int(await txn.get(key(b)))
        d = int(await txn.get(key(c)))
        txn.set(key(a), str(c).encode())
        txn.set(key(b), str(d).encode())
        txn.set(key(c), str(b).encode())

    async def body():
        txn = db.create_transaction()
        for i in range(n):
            txn.set(key(i), str((i + 1) % n).encode())
        await txn.commit()
        tasks = [sched.spawn(db.run(swap)) for _ in range(12)]
        await P.flow.all_of([t.done for t in tasks])
        txn = db.create_transaction()
        return [int(await txn.get(key(i))) for i in range(n)]

    ptrs = run(sched, body())
    at, seen = 0, set()
    for _ in range(n):
        assert at not in seen
        seen.add(at)
        at = ptrs[at]
    assert at == 0 and len(seen) == n
    return ptrs


def _break_proxy(cluster):
    p = cluster.commit_proxies[0]
    p.failed = RuntimeError("simulated proxy crash")
    p.stop()


async def _recovered(sched, cluster, before):
    """Wait until the controller has finished a recovery past epoch
    `before` (the source tests wait a fixed virtual second)."""
    while cluster.controller.epoch == before or cluster.controller._recovering:
        await sched.delay(0.02)
    return cluster.controller.epoch


@scenario(lambda P: dict(n_commit_proxies=2, n_resolvers=2, n_storage=2),
          jax_backend="tpu-force")
def recovery_rebuilds_resolvers(P, sched, cluster, db):
    """tests/test_recovery.py: a stale pre-recovery snapshot aborts, the
    new generation's resolvers (built by recovery.py) start empty, and
    three recoveries in a row keep every write."""
    async def body():
        out = []
        init = db.create_transaction()
        init.set(b"stale", b"0")
        out.append(await commit(init))
        t1 = db.create_transaction()
        out.append(await t1.get(b"stale"))
        t1.set(b"other", b"x")
        old = list(cluster.resolvers)
        _break_proxy(cluster)
        out.append(await _recovered(sched, cluster, 1))
        out.append(await commit(t1))
        out.append(all(r not in old for r in cluster.resolvers))

        async def w(txn):
            assert await txn.get(b"stale") == b"0"
            txn.set(b"stale", b"1")

        await db.run(w)
        for round_ in range(3):
            async def wr(txn, round_=round_):
                txn.set(b"r%d" % round_, b"x")

            await db.run(wr)
            before = cluster.controller.epoch
            _break_proxy(cluster)
            await _recovered(sched, cluster, before)
        txn = db.create_transaction()
        out.append(await txn.get_range(b"r", b"s"))
        out.append(await txn.get(b"stale"))
        return out

    out = run(sched, body())
    assert out[2] == 2 and out[3][0] == "err" and out[4] is True
    assert len(out[5]) == 3 and cluster.controller.epoch == 5
    return out


@scenario(lambda P: dict(n_storage=3, replication_factor=2))
def replication_and_repair(P, sched, cluster, db):
    """tests/test_replication.py: mutations reach every replica of their
    team, reads survive a replica's death, and a team repair restores
    replication (check_cluster agrees)."""
    dd = cluster.data_distributor

    async def body():
        out = []
        txn = db.create_transaction()
        for i in range(12):
            txn.set(b"tr%02d" % i, b"v%d" % i)
        out.append(await commit(txn))
        await sched.delay(0.05)
        out.append(P.consistency.check_cluster(cluster))
        victim = cluster.key_servers.team_of(b"tr00")[0]
        cluster.kill_storage(victim)
        txn = db.create_transaction()
        out.append([await txn.get(b"tr%02d" % i) for i in range(12)])
        txn.set(b"tr00", b"after-failure")
        out.append(await commit(txn))
        replacement = next(
            s for s in range(3)
            if s != victim and s not in cluster.key_servers.team_of(b"tr00")
        )
        out.append(await dd.repair(victim, replacement))
        await sched.delay(0.2)
        out.append(P.consistency.check_cluster(cluster))
        out.append(await db.create_transaction().get_range(b"tr", b"ts"))
        return out

    out = run(sched, body())
    assert out[2] == [b"v%d" % i for i in range(12)]
    assert out[4] >= 1 and len(out[6]) == 12
    return out


def _locality_config(P):
    L = {
        s: P.locality.LocalityData(
            process_id=f"p{s}", machine_id=f"m{s}", zone_id=z, dc_id="dc")
        for s, z in {0: "z1", 1: "z1", 2: "z2", 3: "z3"}.items()
    }
    return dict(n_commit_proxies=1, n_storage=4, replication_factor=2,
                storage_localities=L,
                replication_policy=P.locality.PolicyAcross(2, "zone_id"))


@scenario(_locality_config)
def locality_teams(P, sched, cluster, db):
    """tests/test_locality.py::test_cluster_teams_honor_policy_and_repair:
    every team spans two zones; killing the sole z2 server rebuilds each
    affected team across zones from the survivors."""
    L = cluster.config.storage_localities
    policy = cluster.config.replication_policy

    async def body():
        out = [list(cluster.key_servers.owners)]
        t = db.create_transaction()
        t.set(b"k1", b"v1")
        t.set(b"\x90k", b"v2")
        out.append(await commit(t))
        cluster.kill_storage(2)
        out.append(await cluster.data_distributor.repair(2))
        out.append(list(cluster.key_servers.owners))
        t = db.create_transaction()
        out += [await t.get(b"k1"), await t.get(b"\x90k")]
        return out

    out = run(sched, body())
    for team in out[0] + out[3]:
        assert P.locality.validate_team(team, L, policy), team
    assert all(2 not in team for team in out[3])
    return out


@scenario(lambda P: dict(n_commit_proxies=2, n_storage=2))
def shard_move(P, sched, cluster, db):
    """tests/test_data_distribution.py::
    test_move_shard_preserves_data_and_routing: a shard move keeps every
    key readable, drops the moved span from the old owner and routes new
    writes to the new one."""
    dd = cluster.data_distributor

    async def body():
        out = []
        txn = db.create_transaction()
        for i in range(20):
            txn.set(b"mv%02d" % i, b"v%d" % i)
        out.append(await commit(txn))
        await dd.move_shard(b"mv05", b"mv15", 1)
        out.append([cluster.key_servers.shard_of(k)
                    for k in (b"mv04", b"mv07")])
        await sched.delay(0.1)
        out.append([b"mv07" in cluster.storage_servers[1]._data,
                    b"mv07" in cluster.storage_servers[0]._data])
        txn = db.create_transaction()
        out.append(await txn.get_range(b"mv", b"mw"))
        txn.set(b"mv09", b"updated")
        out.append(await commit(txn))
        out.append(await db.create_transaction().get(b"mv09"))
        return out

    out = run(sched, body())
    assert out[1] == [0, 1] and out[2] == [True, False]
    assert out[5] == b"updated"
    return out


@scenario(lambda P: dict(n_tlogs=3, n_storage=2))
def tlog_crash_reboot(P, sched, cluster, db):
    """tests/test_logsystem.py and tests/test_sim_diskqueue.py: commits
    replicate to every log, `crash_reboot_tlog` tears a replica's
    un-fsynced tail (seeded) and its SimDiskQueue recovery scan plus peer
    catch-up return it to service, a killed replica freezes below the
    survivors, and a recovery locks every live log at the new epoch."""
    async def body():
        out = []
        for i in range(6):
            txn = db.create_transaction()
            txn.set(b"lg%d" % i, b"v%d" % i)
            out.append(await commit(txn))
        await sched.delay(0.05)
        out.append([t.version.get() for t in cluster.tlog.tlogs])
        cluster.crash_reboot_tlog(1, np.random.default_rng(3))
        out.append([len(t.dq.recovered) for t in cluster.tlog.tlogs])
        txn = db.create_transaction()
        txn.set(b"after", b"reboot")
        out.append(await commit(txn))
        cluster.kill_tlog(0)
        txn = db.create_transaction()
        txn.set(b"post", b"2")
        out.append(await commit(txn))
        _break_proxy(cluster)
        await _recovered(sched, cluster, 1)

        async def w(txn):
            txn.set(b"rk2", b"2")

        await db.run(w)
        txn = db.create_transaction()
        out += [await txn.get(b"lg0"), await txn.get(b"after"),
                await txn.get(b"rk2")]
        out.append([t.epoch for t in cluster.tlog.tlogs])
        return out

    out = run(sched, body())
    assert len(set(out[6])) == 1 and out[6][0] > 0
    assert cluster.tlog.tlogs[0].version.get() < \
        cluster.tlog.tlogs[1].version.get()
    assert out[-4:-1] == [b"v0", b"reboot", b"2"]
    return out


async def _mixed_workload(db, NotCommitted, rounds, seed):
    """tests/test_sim.py's ConflictRange-style model check."""
    rng = np.random.default_rng(seed)
    model: dict[bytes, bytes] = {}
    log = []
    for i in range(rounds):
        txn = db.create_transaction()
        try:
            for _ in range(int(rng.integers(0, 3))):
                a, b = sorted(rng.integers(0, 40, size=2).tolist())
                got = await txn.get_range(b"k%02d" % a, b"k%02d" % (b + 1))
                want = sorted(
                    (k, v) for k, v in model.items()
                    if b"k%02d" % a <= k < b"k%02d" % (b + 1)
                )
                assert got == want, f"round {i}: read mismatch"
                log.append(got)
            writes = []
            for _ in range(int(rng.integers(1, 4))):
                k = b"k%02d" % int(rng.integers(0, 40))
                if rng.random() < 0.2:
                    txn.clear_range(k, k + b"\xff")
                    writes.append(("clear", k, k + b"\xff"))
                else:
                    txn.set(k, b"v%d" % i)
                    writes.append(("set", k, b"v%d" % i))
            await txn.commit()
            log.append(("committed", txn.committed_version))
            for op in writes:
                if op[0] == "set":
                    model[op[1]] = op[2]
                else:
                    for k in [k for k in model if op[1] <= k < op[2]]:
                        del model[k]
        except NotCommitted:
            log.append("aborted")
    return log, model


@scenario(lambda P: dict(n_commit_proxies=2, n_resolvers=2, n_storage=2,
                         sim_seed=1), jax_backend="tpu-force")
def sim_clogging(P, sched, cluster, db):
    """tests/test_sim.py::test_clogging_slows_but_preserves_correctness:
    the seeded SimNetwork with both proxies' links to resolver 0 clogged;
    every read agrees with the model and the final state is the model."""
    cluster.net.clog_pair("proxy0", "resolver0", 0.5)
    cluster.net.clog_pair("proxy1", "resolver0", 0.8)
    log, model = run(sched, _mixed_workload(
        db, P.commit_proxy.NotCommitted, 20, seed=3))
    got = run(sched, db.create_transaction().get_range(b"k", b"l"))
    assert dict(got) == model
    return [log, got]


@scenario(lambda P: dict(n_commit_proxies=2, n_resolvers=2, n_storage=2,
                         sim_seed=4))
def sim_attrition(P, sched, cluster, db):
    """tests/test_sim.py::test_storage_reboot_resumes_from_durable_state
    and test_attrition_workload_under_load: storage reboots (from their
    durable snapshots) while the model-checked workload runs."""
    async def attrition():
        for i in range(3):
            await sched.delay(0.08)
            cluster.reboot_storage(i % 2)

    async def body():
        att = sched.spawn(attrition())
        log, model = await _mixed_workload(
            db, P.commit_proxy.NotCommitted, 20, seed=9)
        await att
        got = await db.create_transaction().get_range(b"k", b"l")
        assert dict(got) == model
        return [log, got]

    return run(sched, body())


@scenario(lambda P: dict(n_commit_proxies=1, n_storage=2, n_tss=1))
def tss_mirror(P, sched, cluster, db):
    """tests/test_tss.py: a healthy TSS mirror matches on every sampled
    read; once its store diverges, sampled reads flag mismatches and the
    client still reads the truth; a dead TSS never blocks reads."""
    every = P.tss.TSS_SAMPLE_EVERY

    async def body():
        out = []
        txn = db.create_transaction()
        for i in range(8):
            txn.set(b"ts%02d" % i, b"v%d" % i)
        out.append(await commit(txn))
        await sched.delay(0.2)
        txn = db.create_transaction()
        out.append([await txn.get(b"ts00") for _ in range(4 * every)])
        await sched.delay(0.2)
        out.append((db.tss.samples, db.tss.mismatches))
        for hist in cluster.tss_servers[0]._hist.values():
            hist[:] = [(v, b"LIES") for v, _val in hist]
        txn = db.create_transaction()
        out.append({await txn.get(b"ts01") for _ in range(4 * every)})
        await sched.delay(0.2)
        out.append((db.tss.samples, db.tss.mismatches))
        cluster.tss_servers[0].stop()
        txn = db.create_transaction()
        out.append([await txn.get(b"ts02") for _ in range(4 * every)])
        return out

    out = run(sched, body())
    assert out[2][0] >= 3 and out[2][1] == 0
    assert out[3] == {b"v1"} and out[4][1] >= 1
    return out


def _window_1m(P):
    config = importlib.import_module(f"{P.name}.config")
    return dict(n_storage=2, kernel_config=config.TEST_CONFIG.scaled(
        window_versions=1_000_000, max_key_bytes=16))


@scenario(_window_1m)
def versioned_reads(P, sched, cluster, db):
    """tests/test_versioned_reads.py: a read-only snapshot stays stable
    under a later writer, sees a clear only past its version, atomic
    history at each version, and GC past the MVCC window rejects an
    ancient read with TransactionTooOld (a 1M-version window here, so
    the clock passes it in 2.4 virtual seconds, not 12)."""
    async def body():
        out = []
        txn = db.create_transaction()
        txn.set(b"a", b"1")
        txn.set(b"b", b"1")
        txn.set(b"gone", b"x")
        out.append(await commit(txn))
        reader = db.create_transaction()
        out.append(await reader.get(b"a", snapshot=True))
        writer = db.create_transaction()
        writer.set(b"a", b"2")
        writer.set(b"b", b"2")
        writer.clear(b"gone")
        out.append(await commit(writer))
        out.append(await reader.get(b"b", snapshot=True))
        out.append(await reader.get_range(b"a", b"c", snapshot=True))
        out.append(await reader.get(b"gone", snapshot=True))
        fresh = db.create_transaction()
        out += [await fresh.get(b"b"), await fresh.get(b"gone")]

        versions = []
        for _ in range(3):
            txn = db.create_transaction()
            txn.add(b"ctr", 1)
            versions.append(await txn.commit())
        ss = cluster.storage_servers[cluster.key_servers.shard_of(b"ctr")]
        out.append([await ss.get_value(b"ctr", v) for v in versions])

        v_old = versions[0]
        for _ in range(2):
            await sched.delay(1.2)
            txn = db.create_transaction()
            txn.set(b"new", b"1")
            out.append(await commit(txn))
        await sched.delay(0.1)
        out.append(await outcome(ss.get_value(b"ctr", v_old)))
        out.append(await db.create_transaction().get(b"ctr"))
        return out

    out = run(sched, body())
    assert out[3] == b"1" and out[5] == b"x" and out[7] is None
    assert [int.from_bytes(v, "little") for v in out[8]] == [1, 2, 3]
    assert out[11] == ("err", "TransactionTooOld")
    return out


@scenario(lambda P: dict(sim_seed=42))
def idempotency(P, sched, cluster, db):
    """tests/test_idempotency.py: the idempotency record is written and
    detectable, ids are per-client nonces, and an idempotent retry after
    a forced commit_unknown_result does not apply twice."""
    proxy = cluster.commit_proxies[0]
    real_commit = proxy.commit
    fired = []

    def sabotaged_commit(ctr):
        p = real_commit(ctr)
        if not fired:
            fired.append(True)
            broken = P.flow.Promise()

            def relay(f):
                if not broken.is_set:
                    broken.send_error(P.commit_proxy.CommitUnknownResult())

            p.future.add_done_callback(relay)
            return broken
        return p

    async def w(txn):
        txn.add(b"amb", 1)

    async def body():
        out = []
        txn = db.create_transaction()
        ident = txn.set_idempotency_id()
        txn.set(b"idk", b"v")
        out.append(await commit(txn))
        out.append(ident)
        out.append(await db.create_transaction().get(
            b"\xff/idmp/" + ident, snapshot=True))
        db2 = cluster.database()
        out.append([db2.create_transaction().set_idempotency_id()
                    for _ in range(3)])
        proxy.commit = sabotaged_commit
        await db.run(w, idempotent=True)
        await db.run(w, idempotent=True)
        out.append(await db.create_transaction().get(b"amb"))
        return out

    out = run(sched, body())
    assert out[2] == b"\x01"
    assert int.from_bytes(out[4], "little") == 2
    return out


@scenario(lambda P: dict(n_storage=2))
def ratekeeper_throttle(P, sched, cluster, db):
    """tests/test_ratekeeper_throttle.py: a slow storage server forces
    the control law to throttle and the budget recovers once it drains
    (waited for, where the source runs 3 virtual seconds); a tag quota
    delays tagged GRVs and never untagged ones."""
    rk = cluster.ratekeeper
    rk.lag_target = 50_000
    rk.lag_limit = 400_000
    rk.interval = 0.05
    ss = cluster.storage_servers[0]
    ss.slowdown = 0.2
    budgets = []

    async def load():
        out = []
        for i in range(30):
            txn = db.create_transaction()
            txn.set(b"rk%02d" % (i % 8), b"v%d" % i)
            out.append(await commit(txn))
            budgets.append(rk.tps_budget)
            await sched.delay(0.02)
        return out

    async def recovered():
        while rk.tps_budget != rk.max_tps:
            await sched.delay(0.05)
        return sched.now()

    out = [run(sched, load()), list(budgets)]
    ss.slowdown = 0.0
    out.append(run(sched, recovered()))
    out.append((rk.tps_budget, rk.max_tps, rk.counters.get("throttled")))

    rk.set_tag_quota("batch", 5.0)
    done = {"tagged": 0, "untagged": 0}

    async def grvs(tag):
        vs = []
        for _ in range(6):
            txn = db.create_transaction(tag=tag)
            vs.append(await txn.get_read_version())
            done["untagged" if tag is None else "tagged"] += 1
        return vs

    t1 = sched.spawn(grvs("batch"))
    t2 = sched.spawn(grvs(None))
    sched.run_until(t2.done)
    out.append(dict(done))
    sched.run_until(t1.done)
    out += [t1.done.get(), t2.done.get()]
    assert out[3][2] > 0 and min(out[1]) < rk.max_tps
    assert out[4]["untagged"] == 6 and out[4]["tagged"] < 6
    return out


@scenario(lambda P: dict(n_storage=3, replication_factor=2))
def failure_monitor(P, sched, cluster, db):
    """tests/test_failure_monitor.py: a silent kill is found by the ping
    loop, a client read that hits a dead replica reports it and fails
    over, and a reboot marks the server alive again."""
    victim = cluster.key_servers.team_of(b"fm-key")[0]

    async def body():
        out = []
        txn = db.create_transaction()
        txn.set(b"fm-key", b"alive")
        out.append(await commit(txn))
        cluster.kill_storage_silent(victim)
        vals = []
        for _ in range(4):
            vals.append(await db.create_transaction().get(b"fm-key"))
        out.append(vals)
        out.append(cluster.failure_monitor.is_failed(f"storage{victim}"))
        other = (victim + 1) % 3
        cluster.kill_storage_silent(other)
        for _ in range(100):
            await sched.delay(0.05)
            if not cluster.storage_live[other]:
                break
        out.append(list(cluster.storage_live))
        cluster.reboot_storage(victim)
        await sched.delay(0.5)
        out.append(list(cluster.storage_live))
        out.append(await db.create_transaction().get(b"fm-key"))
        return out

    out = run(sched, body())
    assert out[1] == [b"alive"] * 4 and out[2] is True
    assert out[3][victim] is False
    return out


@scenario(lambda P: dict(n_storage=2, replication_factor=2, sim_seed=7))
def partition_until_healed(P, sched, cluster, db):
    """tests/test_failure_monitor.py::
    test_partition_looks_like_failure_until_healed: a partitioned storage
    server looks dead from the controller's vantage until the partition
    heals."""
    async def wait_for(value):
        for _ in range(200):
            await sched.delay(0.05)
            if cluster.storage_live[1] is value:
                return sched.now()
        return None

    cluster.net.partition("cc", "storage1")
    out = [run(sched, wait_for(False))]
    cluster.net.heal("cc", "storage1")
    out.append(run(sched, wait_for(True)))
    assert None not in out
    return out


@scenario(lambda P: dict(n_commit_proxies=1, n_storage=2))
def coordination_quorum(P, sched, cluster, db):
    """tests/test_coordination.py: recovery goes through the coordinators'
    quorum with a minority dead, is blocked without a majority (for 2
    virtual seconds; the source waits 10), and runs once a coordinator is
    revived."""
    async def wait_recovered(epoch_before, n):
        for _ in range(n):
            await sched.delay(0.05)
            if cluster.controller.epoch > epoch_before and \
                    not cluster.controller._recovering:
                break
        return cluster.controller.epoch

    async def body():
        out = []
        cluster.kill_coordinator(0)
        t = db.create_transaction()
        t.set(b"k1", b"v1")
        out.append(await commit(t))
        before = cluster.controller.epoch
        cluster.commit_proxies[0].failed = RuntimeError("test-kill")
        out.append(await wait_recovered(before, 400))
        t = db.create_transaction()
        t.set(b"k2", b"v2")
        out.append(await commit(t))
        cluster.kill_coordinator(1)
        before = cluster.controller.epoch
        cluster.commit_proxies[0].failed = RuntimeError("test-kill")
        await sched.delay(2.0)
        out.append(cluster.controller.epoch)
        cluster.revive_coordinator(0)
        out.append(await wait_recovered(before, 600))
        t = db.create_transaction()
        t.set(b"back", b"alive")
        out.append(await commit(t))
        t = db.create_transaction()
        out.append(await t.get_range(b"", b"\xff"))
        return out

    out = run(sched, body())
    assert out[1] == 2 and out[3] == 2 and out[4] > out[3]
    return out


@scenario(lambda P: dict())
def atomic_ops(P, sched, cluster, db):
    """tests/test_layers_atomic.py::test_atomic_through_cluster, with a
    versionstamped key and value beside it: add (seen by read-your-writes),
    byte_max, compare_and_clear, bit_xor, append_if_fits, versionstamps."""
    async def body():
        out = []
        txn = db.create_transaction()
        txn.add(b"ctr", 5)
        out.append(await txn.get(b"ctr"))
        out.append(await commit(txn))
        txn = db.create_transaction()
        txn.add(b"ctr", -2)
        out.append(await commit(txn))
        txn = db.create_transaction()
        out.append(await txn.get(b"ctr"))
        txn.atomic_op("byte_max", b"m", b"hello")
        txn.atomic_op("compare_and_clear", b"ctr", (3).to_bytes(8, "little"))
        txn.atomic_op("bit_xor", b"x", b"\x0f")
        txn.atomic_op("append_if_fits", b"ap", b"cd")
        out.append(await commit(txn))
        txn = db.create_transaction()
        txn.set_versionstamped_key(b"vs/", b"", b"val")
        txn.set_versionstamped_value(b"vsv", b"pre")
        out.append(await commit(txn))
        out.append(txn.versionstamp)
        txn = db.create_transaction()
        out += [await txn.get(b"ctr"), await txn.get(b"m"),
                await txn.get(b"x"), await txn.get(b"ap"),
                await txn.get_range(b"vs/", b"vs0"), await txn.get(b"vsv")]
        return out

    out = run(sched, body())
    assert out[0] == (5).to_bytes(8, "little")
    assert out[3] == (3).to_bytes(8, "little") and out[7] is None
    return out


def _scenario_ids():
    return [s.name for s in SCENARIOS]


@pytest.mark.parametrize("scn", SCENARIOS, ids=_scenario_ids())
def test_scenario_digests_equal(scn):
    """The JAX run and the port's "cuda" (plain versions on the CPU) and
    "cpu" runs leave the same digest."""
    jax_digest, jax_sets = run_scenario(JAX, scn.jax_backend, scn)
    port_digest, port_sets = run_scenario(PORT, "cuda", scn)
    expect = "TpuConflictSet" if scn.jax_backend == "tpu-force" \
        else "CpuConflictSet"
    assert set(jax_sets) == {expect}
    assert set(port_sets) == {"TorchConflictSet"}
    for key in jax_digest:
        assert port_digest[key] == jax_digest[key], key
    cpu_digest, cpu_sets = run_scenario(PORT, "cpu", scn)
    assert set(cpu_sets) == {"CpuConflictSet"}
    assert cpu_digest == port_digest


def test_scenarios_cover_their_sources():
    """At least twelve scenarios, each naming its source test, at least
    two on the JAX kernels ("tpu-force")."""
    assert len(SCENARIOS) >= 12
    for s in SCENARIOS:
        assert "tests/test_" in (s.body.__doc__ or ""), s.name
    assert sum(s.jax_backend == "tpu-force" for s in SCENARIOS) >= 2


# ---------------------------------------------------------------------------
# Construction rules and the unported branches


def test_cuda_backend_on_the_card_raises_without_one():
    P = ns(PORT)
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the rule is for hosts without")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.database.open_cluster(
            P.database.ClusterConfig(resolver_backend="cuda"))


def test_default_config_resolves_on_the_card():
    """The default config resolves on the card: it asks for "cuda" with
    device None, so a host without one raises, and with device="cpu"
    every resolver holds a TorchConflictSet running the plain versions.
    The knob route is no value of the port's config, and nothing is
    routed to the host oracle behind the caller's back (the JAX
    package's default reads its "tpu" knob instead)."""
    P = ns(PORT)
    cfg = P.database.ClusterConfig()
    assert (cfg.resolver_backend, cfg.device) == ("cuda", None)
    with pytest.raises(ValueError, match="expected 'cuda' or 'cpu'"):
        P.database.ClusterConfig(resolver_backend=None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.database.open_cluster()
    log = P.trace.TraceLog()
    old = P.trace.install(log, P.trace.TraceBatch(enabled=False))
    try:
        sched, cluster, db = P.database.open_cluster(
            P.database.ClusterConfig(device="cpu"))
        try:
            async def body():
                txn = db.create_transaction()
                txn.set(b"k", b"v")
                await txn.commit()
                return await db.create_transaction().get(b"k")

            assert run(sched, body()) == b"v"
            sets = [r.conflict_set for r in cluster.resolvers]
            assert {type(cs).__name__ for cs in sets} == {"TorchConflictSet"}
            assert {cs.device.type for cs in sets} == {"cpu"}
        finally:
            cluster.stop()
    finally:
        P.trace.install(*old)
    assert not [e for e in log.events
                if e.get("Type") == "ResolverBackendAutoRouted"]


def test_unported_branches_raise():
    """A DR destination's commit lock raises the port's
    cluster/dr.DestinationLockedError (a DatabaseLockedError), where the
    JAX client raises its own; \\xff\\xff/status/json serves the status
    document (cluster/status.cluster_status)."""
    for pkg in (JAX, PORT):
        P = ns(pkg)
        dr = importlib.import_module(f"{pkg}.cluster.dr")
        kw = dict(device="cpu") if pkg == PORT else {}
        sched, cluster, db = P.database.open_cluster(
            P.database.ClusterConfig(resolver_backend="cpu", **kw))
        try:
            db.dr_locked = True
            txn = db.create_transaction()
            txn.set(b"k", b"v")
            with pytest.raises(dr.DestinationLockedError,
                               match="writes are locked") as e:
                run(sched, txn.commit())
            assert isinstance(e.value, P.commit_proxy.DatabaseLockedError)
            assert type(e.value).__module__ == f"{pkg}.cluster.dr"
        finally:
            cluster.stop()
    P = ns(PORT)
    sched, cluster, db = P.database.open_cluster(
        P.database.ClusterConfig(device="cpu", resolver_backend="cpu"))
    try:
        doc = json.loads(db.special_key(b"\xff\xff/status/json"))
        conf = doc["cluster"]["configuration"]
        assert (conf["resolver_backend"], conf["resolvers"]) == ("cpu", 1)
        assert doc["cluster"]["qos"]["performance_limited_by"]["name"]
        assert db.special_key(b"\xff\xff/cluster/epoch") == b"1"
    finally:
        cluster.stop()
