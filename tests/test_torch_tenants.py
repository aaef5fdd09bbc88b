"""The port's tenants (`cluster/tenant.py`) and metacluster
(`cluster/metacluster.py`) held against the JAX package's on the CPU.

Twins (tests/twins.py) of every test of tests/test_tenants.py and
tests/test_metacluster.py, each written once against a package
namespace and run through both pairs of backends: tenant isolation,
management errors and the retry loop on one cluster; a management
cluster and two data clusters on one scheduler placing tenants by
capacity, refusing a double registration, a non-empty removal or
tenant delete, serializing racing creates and repairing a create cut
between its stages. Tenant keys reach each resolver as tenant-prefixed
conflict ranges.
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


# ---------------------------------------------------------------------------
# tests/test_tenants.py


@twin
def tenant_isolation(w):
    sched, cluster, db = w.open()
    T = w.P.tenant

    async def body():
        await T.create_tenant(db, b"alpha")
        await T.create_tenant(db, b"beta")
        a, b = T.Tenant(db, b"alpha"), T.Tenant(db, b"beta")
        ta = a.create_transaction()
        await ta.set(b"k", b"from-alpha")
        await ta.commit()
        tb = b.create_transaction()
        await tb.set(b"k", b"from-beta")
        await tb.commit()
        ta, tb = a.create_transaction(), b.create_transaction()
        return (await ta.get(b"k"), await tb.get(b"k"),
                await ta.get_range(b"", b"\xff"),
                await db.create_transaction().get_range(
                    T.TENANT_DATA_PREFIX, T.TENANT_DATA_PREFIX + b"\xff"))

    va, vb, ra, raw = w.run(sched, body())
    assert (va, vb, ra) == (b"from-alpha", b"from-beta",
                            [(b"k", b"from-alpha")])
    assert len(raw) == 2 and all(k.startswith(b"\x1e") for k, _ in raw)
    return va, vb, ra, raw


@twin
def tenant_management_errors(w):
    sched, cluster, db = w.open()
    T = w.P.tenant

    async def body():
        out = [await T.create_tenant(db, b"t1")]
        out.append(await outcome(T.create_tenant(db, b"t1")))
        out.append(await outcome(
            T.Tenant(db, b"missing").create_transaction().get(b"x")))
        t1 = T.Tenant(db, b"t1")
        txn = t1.create_transaction()
        await txn.set(b"data", b"1")
        await txn.commit()
        out.append(await outcome(T.delete_tenant(db, b"t1")))
        txn = t1.create_transaction()
        await txn.clear(b"data")
        await txn.commit()
        await T.delete_tenant(db, b"t1")
        out.append(await T.list_tenants(db))
        return out

    out = w.run(sched, body())
    assert out[1:] == [("err", "TenantExists"), ("err", "TenantNotFound"),
                       ("err", "TenantNotEmpty"), []]
    return out


@twin
def tenant_retry_loop_and_conflicts(w):
    sched, cluster, db = w.open()
    T = w.P.tenant

    async def body():
        await T.create_tenant(db, b"rt")
        t = T.Tenant(db, b"rt")

        async def add(txn):
            await txn.atomic_op("add", b"ctr", (1).to_bytes(8, "little"))

        for _ in range(3):
            await t.run(add)
        return await t.create_transaction().get(b"ctr")

    got = w.run(sched, body())
    assert int.from_bytes(got, "little") == 3
    return got


# ---------------------------------------------------------------------------
# tests/test_metacluster.py


def _meta(w):
    sched = w.scheduler()
    _s, _m, mgmt = w.open(sched, n_commit_proxies=1, n_storage=2)
    _s, _c1, d1 = w.open(sched, n_commit_proxies=1, n_storage=2)
    _s, _c2, d2 = w.open(sched, n_commit_proxies=1, n_storage=2)
    return sched, w.P.metacluster.Metacluster(mgmt), d1, d2


@twin
def assignment_balancing_and_data_isolation(w):
    sched, mc, d1, d2 = _meta(w)

    async def body():
        await mc.register_cluster(b"dc1", d1, capacity=2)
        await mc.register_cluster(b"dc2", d2, capacity=2)
        placed = [await mc.create_tenant(b"t%d" % i) for i in range(4)]
        assert sorted(placed) == [b"dc1", b"dc1", b"dc2", b"dc2"]
        overflow = await outcome(mc.create_tenant(b"overflow"))
        t0 = await mc.open_tenant(b"t0")

        async def wr(txn):
            await txn.set(b"k", b"from-t0")

        await t0.run(wr)
        t1 = await mc.open_tenant(b"t1")
        got = (await t1.create_transaction().get(b"k"),
               await t0.create_transaction().get(b"k"))
        return placed, overflow, got, await mc.list_tenants()

    placed, overflow, got, assignments = out = w.run(sched, body())
    assert overflow == ("err", "MetaclusterCapacityExceeded")
    assert got == (None, b"from-t0") and assignments[b"t0"] in (b"dc1",
                                                                b"dc2")
    return out


@twin
def double_registration_refused(w):
    sched, mc, d1, _d2 = _meta(w)

    async def body():
        await mc.register_cluster(b"dc1", d1)
        mc2 = w.P.metacluster.Metacluster(mc.db)
        return await outcome(mc2.register_cluster(b"other-name", d1))

    got = w.run(sched, body())
    assert got == ("err", "ClusterAlreadyRegistered")
    return got


@twin
def remove_cluster_requires_empty(w):
    sched, mc, d1, _d2 = _meta(w)

    async def body():
        out = []
        await mc.register_cluster(b"dc1", d1, capacity=5)
        await mc.create_tenant(b"occupied")
        out.append(await outcome(mc.remove_cluster(b"dc1")))
        t = await mc.open_tenant(b"occupied")

        async def wr(txn):
            await txn.set(b"x", b"1")

        await t.run(wr)
        out.append(await outcome(mc.delete_tenant(b"occupied")))

        async def clr(txn):
            await txn.clear_range(b"", b"\xff")

        await t.run(clr)
        await mc.delete_tenant(b"occupied")
        await mc.remove_cluster(b"dc1")
        out.append(await mc.list_clusters())
        await mc.register_cluster(b"dc1-again", d1)
        out.append(await mc.list_clusters())
        return out

    out = w.run(sched, body())
    assert out[:3] == [("err", "ClusterNotEmpty"), ("err", "TenantNotEmpty"),
                       {}]
    return out


@twin
def concurrent_creates_never_overcommit(w):
    sched, mc, d1, _d2 = _meta(w)
    full = w.P.metacluster.MetaclusterCapacityExceeded

    async def body():
        await mc.register_cluster(b"dc1", d1, capacity=1)
        results = []

        async def one(i):
            try:
                results.append(await mc.create_tenant(b"race%d" % i))
            except full:
                results.append(None)

        t1, t2 = sched.spawn(one(0)), sched.spawn(one(1))
        await t1.done
        await t2.done
        return results

    results = w.run(sched, body())
    assert sorted(results, key=str) == [None, b"dc1"], results
    return results


@twin
def crash_mid_create_repairs(w):
    sched, mc, d1, _d2 = _meta(w)

    async def body():
        await mc.register_cluster(b"dc1", d1, capacity=5)
        txn = mc.db.create_transaction()
        txn.set(b"\xff/metacluster/tenants/limbo", b"\x00creating/dc1")
        await txn.commit()
        t = await mc.open_tenant(b"limbo")

        async def wr(tx):
            await tx.set(b"k", b"alive")

        await t.run(wr)
        return await mc.list_tenants(), await t.create_transaction().get(b"k")

    assignments, got = w.run(sched, body())
    assert assignments[b"limbo"] == b"dc1" and got == b"alive"
    return assignments, got


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("name", list(TWINS))
def test_twin(name, pair):
    check_twin(TWINS[name], pair)


def test_twins_cover_their_sources():
    import ast
    from pathlib import Path

    names = set()
    for src in ("test_tenants.py", "test_metacluster.py"):
        tree = ast.parse((Path(__file__).parent / src).read_text())
        names |= {n.name.removeprefix("test_") for n in tree.body
                  if isinstance(n, ast.FunctionDef)
                  and n.name.startswith("test_")}
    assert names == set(TWINS)


def test_tenant_keyspace_constants_are_the_jax_ones():
    """The tenant map, counter and data prefix, and the metacluster's
    registry keys, are the JAX package's, and sampling's redeclared
    TENANT_DATA_PREFIX is the tenant layer's."""
    J, P = ns(JAX), ns(PORT)
    for name in ("TENANT_MAP_PREFIX", "TENANT_COUNTER_KEY",
                 "TENANT_DATA_PREFIX"):
        assert getattr(P.tenant, name) == getattr(J.tenant, name), name
    for name in ("_CLUSTERS", "_TENANTS", "_REGISTRATION", "_CREATING"):
        assert getattr(P.metacluster, name) == getattr(J.metacluster, name)
    from foundationdb_tpu_torch.cluster import sampling

    assert sampling._TENANT_DATA_PREFIX == P.tenant.TENANT_DATA_PREFIX
