"""The port's DR (`cluster/dr.py`: `DrAgent`, `DestinationLockedError`)
held against the JAX package's on the CPU.

Twins (tests/twins.py) of both tests of tests/test_dr.py, written once
against a package namespace and run through both pairs of backends: an
agent snapshots and replicates a source into a locked destination (both
clusters on one scheduler), refuses client writes there through the
client's lock and through a fresh handle's proxy check, switches over
(the source locked, drained, the destination unlocked) and resumes from
the destination's durable watermark after a restart. Also: the port's
client raises its DestinationLockedError, a DatabaseLockedError, where
the JAX client raises its own.
"""

from __future__ import annotations

import pytest

from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from twins import JAX, PAIR_IDS, PAIRS, PORT, check_twin, ns, outcome

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

TWINS = {}


def twin(fn):
    TWINS[fn.__name__] = fn
    return fn


def _pair(w, **src_kw):
    sched = w.scheduler()
    kw = {"n_commit_proxies": 1, "n_storage": 2, **src_kw}
    _s, src_cluster, src_db = w.open(sched, **kw)
    _s, dst_cluster, dst_db = w.open(sched, n_commit_proxies=1, n_storage=2)
    return sched, src_cluster, src_db, dst_cluster, dst_db


@twin
def dr_replicates_and_switches_over(w):
    """tests/test_dr.py: a 2x-replicated source's full stream applies each
    mutation once; the destination is locked until the switchover, the
    retired source after it."""
    sched, src_cluster, src_db, dst_cluster, dst_db = _pair(
        w, replication_factor=2)
    P = w.P
    agent = P.dr.DrAgent(src_cluster, src_db, dst_db)

    async def go():
        out = []
        t = src_db.create_transaction()
        t.set(b"pre-existing", b"data")
        out.append(await t.commit())
        await agent.start()
        t = dst_db.create_transaction()
        t.set(b"rogue", b"write")
        out.append(await outcome(t.commit()))
        fresh = dst_cluster.database()
        t = fresh.create_transaction()
        t.set(b"rogue2", b"write")
        out.append(await outcome(t.commit()))
        for i in range(20):
            t = src_db.create_transaction()
            t.set(b"user%02d" % (i % 7), b"v%d" % i)
            if i % 5 == 0:
                t.atomic_op("add", b"counter", (1).to_bytes(8, "little"))
            out.append(await t.commit())
        t = src_db.create_transaction()
        t.clear_range(b"user03", b"user05")
        out.append(await t.commit())
        final = await agent.switchover()
        assert final >= agent.applied_version
        t = src_db.create_transaction()
        t.set(b"late", b"write")
        out.append(await outcome(t.commit()))
        ts = src_db.create_transaction()
        src_data = dict(await ts.get_range(b"a", b"z"))
        src_ctr = await ts.get(b"counter")
        td = dst_db.create_transaction()
        dst_data = dict(await td.get_range(b"a", b"z"))
        dst_ctr = await td.get(b"counter")
        assert dst_data == src_data and len(src_data) > 0
        assert int.from_bytes(dst_ctr, "little") == 4 and dst_ctr == src_ctr
        assert b"user03" not in dst_data and b"user04" not in dst_data
        assert dst_data[b"pre-existing"] == b"data"
        t = dst_db.create_transaction()
        t.set(b"after", b"switch")
        out.append(await t.commit())
        out.append(await dst_db.create_transaction().get(b"after"))
        return out, final, agent.applied_version, dst_data

    out, final, applied, dst_data = w.run(sched, go())
    assert out[1] == ("err", "DestinationLockedError")
    assert out[2] == ("err", "DatabaseLockedError")
    assert out[-3][1] in ("DestinationLockedError", "DatabaseLockedError")
    assert out[-1] == b"switch"
    return out, final, applied, dst_data


@twin
def dr_agent_restart_resumes_from_watermark(w):
    """tests/test_dr.py: a stopped agent's successor resumes from the
    destination's durable watermark; nothing lost or applied twice."""
    sched, src_cluster, src_db, dst_cluster, dst_db = _pair(w)
    DrAgent = w.P.dr.DrAgent
    agent = DrAgent(src_cluster, src_db, dst_db)

    async def go():
        await agent.start()
        for i in range(8):
            t = src_db.create_transaction()
            t.set(b"k%02d" % i, b"v%d" % i)
            await t.commit()
        await agent.drain_to(src_cluster.tlog.version.get())
        first_mark = agent.applied_version
        agent.stop()
        for i in range(8, 14):
            t = src_db.create_transaction()
            t.set(b"k%02d" % i, b"v%d" % i)
            await t.commit()
        agent2 = DrAgent(src_cluster, src_db, dst_db)
        await agent2.start()
        assert agent2.applied_version == first_mark
        final = await agent2.switchover()
        assert final > first_mark
        got = dict(await dst_db.create_transaction().get_range(b"k", b"l"))
        assert got == {b"k%02d" % i: b"v%d" % i for i in range(14)}
        return first_mark, final, got

    return w.run(sched, go())


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("name", list(TWINS))
def test_twin(name, pair):
    check_twin(TWINS[name], pair)


def test_twins_cover_their_sources():
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).parent / "test_dr.py").read_text())
    names = {n.name.removeprefix("test_") for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    assert names == set(TWINS)


def test_destination_locked_error_is_a_database_locked_error():
    """One logical condition, one catchable type in both packages: the
    port's DestinationLockedError subclasses its DatabaseLockedError and
    the lock keys are the JAX package's."""
    J, P = ns(JAX), ns(PORT)
    assert issubclass(P.dr.DestinationLockedError,
                      P.commit_proxy.DatabaseLockedError)
    assert (P.dr.LOCK_KEY, P.dr.APPLIED_KEY) == (J.dr.LOCK_KEY,
                                                 J.dr.APPLIED_KEY)
    assert P.dr.LOCK_KEY == P.commit_proxy.DB_LOCK_KEY
