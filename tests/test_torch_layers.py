"""The port's layers (`layers/tuple.py`, `layers/directory.py`,
`layers/taskbucket.py`) held against the JAX package's on the CPU.

Twins (tests/twins.py) of every test of tests/test_layers_atomic.py,
tests/test_directory_consistency.py and tests/test_taskbucket.py, each
written once against a package namespace and run through both pairs of
backends; the tuple layer's `pack` compared byte for byte with the JAX
one's on a seeded corpus (nested tuples, ints across every length
boundary, +-0.0, NaN, UUIDs, bytes holding \\x00); and the TaskBucket's
declared probes seen firing in a twin.
"""

from __future__ import annotations

import json
import math
import random
import uuid

import numpy as np
import pytest

from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from twins import JAX, PAIR_IDS, PAIRS, PORT, check_packages, check_twin, \
    ns, outcome

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

TWINS = {}


def twin(fn):
    TWINS[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# The tuple layer, byte for byte


TUPLE_CASES = [
    (),
    (None,),
    (b"bytes", b"with\x00null"),
    ("unicode ☃",),
    (0, 1, -1, 255, 256, -255, -256, 2**48, -(2**48)),
    (3.14, -2.5, 0.0),
    (True, False),
    (uuid.UUID(int=0x1234567890ABCDEF1234567890ABCDEF),),
    (b"nested", ("inner", 42, None), b"after"),
]


def _int_boundaries() -> list:
    out = []
    for n in range(9):
        edge = (1 << (8 * n)) - 1
        for v in (edge - 1, edge, edge + 1):
            if v.bit_length() <= 64:
                out += [v, -v]
    return sorted(set(out))


def tuple_corpus(seed: int = 20, n: int = 400) -> list:
    """Seeded tuples of every type the layer encodes, nested to three
    levels: ints across every length boundary, +-0.0, NaN and the
    infinities, UUIDs, bytes and strings holding \\x00 and \\xff."""
    rng = random.Random(seed)
    ints = _int_boundaries()

    def one(depth):
        kind = rng.randrange(10 if depth < 3 else 9)
        if kind == 0:
            return None
        if kind == 1:
            return rng.random() < 0.5
        if kind == 2:
            return rng.choice(ints)
        if kind == 3:
            return rng.randint(-(1 << 63), (1 << 63) - 1)
        if kind == 4:
            return rng.choice([0.0, -0.0, math.nan, math.inf, -math.inf,
                               rng.uniform(-1e9, 1e9), 5e-324, -5e-324])
        if kind == 5:
            return bytes(rng.choice([0, 0, 1, 0x7F, 0xFF, rng.randrange(256)])
                         for _ in range(rng.randrange(8)))
        if kind == 6:
            return "".join(rng.choice(["a", "\x00", "\xff", "☃", "z"])
                           for _ in range(rng.randrange(6)))
        if kind == 7:
            return uuid.UUID(int=rng.getrandbits(128))
        if kind == 8:
            return rng.randrange(-3, 4)
        return tuple(one(depth + 1) for _ in range(rng.randrange(4)))

    return [tuple(one(0) for _ in range(rng.randrange(1, 5)))
            for _ in range(n)] + TUPLE_CASES


def test_tuple_pack_is_byte_identical_on_a_seeded_corpus():
    J, T = ns(JAX).tuple, ns(PORT).tuple
    corpus = tuple_corpus()
    assert any(isinstance(x, float) and math.isnan(x)
               for t in corpus for x in t)
    for t in corpus:
        packed = T.pack(t)
        assert packed == J.pack(t), t
        # repr: NaN is unequal to itself, and -0.0 equal to 0.0
        assert repr(T.unpack(packed)) == repr(J.unpack(packed))
        assert T.pack(T.unpack(packed)) == packed
        assert J.range_of(t) == T.range_of(t)
    # the order of the encodings is the order of the JAX encodings
    keys = sorted(range(len(corpus)), key=lambda i: T.pack(corpus[i]))
    assert keys == sorted(range(len(corpus)), key=lambda i: J.pack(corpus[i]))
    for bad in (1 << 64, -(1 << 64), object()):
        with pytest.raises((ValueError, TypeError)) as e_port:
            T.pack((bad,))
        with pytest.raises(type(e_port.value)):
            J.pack((bad,))


# ---------------------------------------------------------------------------
# tests/test_layers_atomic.py


@pytest.mark.parametrize("t", TUPLE_CASES, ids=range(len(TUPLE_CASES)))
def test_tuple_roundtrip(t):
    def body(w):
        packed = w.P.tuple.pack(t)
        assert w.P.tuple.unpack(packed) == t
        return packed
    check_packages(body)


def test_tuple_order_preserving():
    def body(w):
        rng = random.Random(0)
        vals = []
        for _ in range(200):
            kind = rng.randrange(3)
            if kind == 0:
                vals.append((rng.randint(-2**40, 2**40),))
            elif kind == 1:
                vals.append((bytes(rng.randrange(256)
                                   for _ in range(rng.randrange(6))),))
            else:
                vals.append((rng.random() * 1000 - 500,))
        T = w.P.tuple
        out = []
        for cls in (int, float, bytes):
            group = sorted(v for v in vals if isinstance(v[0], cls))
            got = [T.unpack(p) for p in sorted(T.pack(v) for v in group)]
            assert got == group
            out.append(got)
        return out
    check_packages(body)


def test_subspace():
    def body(w):
        users = w.P.tuple.Subspace(("users",))
        k = users.pack((42, "alice"))
        assert users.contains(k)
        assert users.unpack(k) == (42, "alice")
        b, e = users.range()
        assert b < k < e
        assert users[42].pack(("alice",)) == k
        with pytest.raises(ValueError):
            users.unpack(b"other")
        return k, b, e, users.key
    check_packages(body)


def test_atomic_add_wraps_and_creates():
    def body(w):
        A = w.P.atomic.apply_atomic
        a = A("add", None, (5).to_bytes(8, "little"))
        b = A("add", (250).to_bytes(1, "little"), (10).to_bytes(1, "little"))
        assert a == (5).to_bytes(8, "little")
        assert b == (4).to_bytes(1, "little")
        return a, b
    check_packages(body)


def test_atomic_bitwise_and_minmax():
    def body(w):
        A = w.P.atomic.apply_atomic
        got = [A("bit_and", None, b"\xff"), A("bit_or", b"\x0f", b"\xf0"),
               A("bit_xor", b"\xff", b"\x0f"),
               A("max", b"\x01\x00", b"\x02\x00"),
               A("min", b"\x01\x00", b"\x02\x00"),
               A("byte_max", b"a", b"b"), A("byte_min", b"a", b"b"),
               A("append_if_fits", b"ab", b"cd"),
               A("compare_and_clear", b"x", b"x"),
               A("compare_and_clear", b"y", b"x")]
        assert got == [b"\x00", b"\xff", b"\xf0", b"\x02\x00", b"\x01\x00",
                       b"b", b"a", b"abcd", None, b"y"]
        return got
    check_packages(body)


@twin
def atomic_through_cluster(w):
    sched, cluster, db = w.open()

    async def body():
        txn = db.create_transaction()
        txn.add(b"ctr", 5)
        ryw = await txn.get(b"ctr")
        await txn.commit()
        txn = db.create_transaction()
        txn.add(b"ctr", -2)
        await txn.commit()
        txn = db.create_transaction()
        v = await txn.get(b"ctr")
        txn.atomic_op("byte_max", b"m", b"hello")
        txn.atomic_op("compare_and_clear", b"ctr", (3).to_bytes(8, "little"))
        await txn.commit()
        txn = db.create_transaction()
        return ryw, v, await txn.get(b"ctr"), await txn.get(b"m")

    ryw, v, ctr, m = out = w.run(sched, body())
    assert ryw == (5).to_bytes(8, "little") and v == (3).to_bytes(8, "little")
    assert ctr is None and m == b"hello"
    return out


def _status_view(w, st):
    """The status fields both packages fill alike; the backend's name is
    the package's own ("tpu-force" in JAX where the port says "cuda")."""
    c = st["cluster"]
    conf = dict(c["configuration"])
    backend = conf.pop("resolver_backend")
    assert backend == w.backend
    return (conf, c["workload"]["transactions"]["committed"],
            c["processes"]["resolver0"]["role"],
            c["live_committed_version"])


@twin
def status_json(w):
    sched, cluster, db = w.open(n_commit_proxies=2, n_resolvers=2)

    async def body():
        txn = db.create_transaction()
        txn.set(b"s", b"1")
        await txn.commit()

    w.run(sched, body())
    from importlib import import_module

    st = import_module(f"{w.P.name}.cluster.status").cluster_status(cluster)
    json.dumps(st)
    view = _status_view(w, st)
    assert view[0]["resolvers"] == 2 and view[1] >= 1
    assert view[2] == "resolver" and view[3] > 0
    return view


@twin
def balancer_moves_boundary_toward_hot_shard(w):
    sched, cluster, db = w.open(n_commit_proxies=1, n_resolvers=2)
    (orig,) = list(cluster.key_resolvers.boundaries)

    async def body():
        out = []
        for i in range(30):
            txn = db.create_transaction()
            txn.set(b"\x01hot%02d" % (i % 10), b"x")
            await txn.get(b"\x01hot%02d" % ((i + 1) % 10))
            out.append(await outcome(txn.commit()))
        await sched.delay(2.0)
        return out

    out = w.run(sched, body())
    moves = cluster.balancer.counters.get("moves")
    assert moves >= 1 and cluster.key_resolvers.boundaries[0] != orig

    async def after():
        txn = db.create_transaction()
        txn.set(b"\x01post", b"1")
        await txn.commit()
        return await db.create_transaction().get(b"\x01post")

    assert w.run(sched, after()) == b"1"
    return out, moves, list(cluster.key_resolvers.boundaries)


# ---------------------------------------------------------------------------
# tests/test_directory_consistency.py


@twin
def directory_create_open_list(w):
    sched, cluster, db = w.open(n_storage=2)
    dl = w.P.directory.DirectoryLayer(rng=np.random.default_rng(0))

    async def body():
        txn = db.create_transaction()
        users = await dl.create_or_open(txn, ("app", "users"))
        logs = await dl.create_or_open(txn, ("app", "logs"))
        txn.set(users.pack((42,)), b"alice")
        txn.set(logs.pack((1,)), b"started")
        await txn.commit()
        txn = db.create_transaction()
        users2 = await dl.open(txn, ("app", "users"))
        assert users2.key == users.key
        return (users.key, logs.key, await txn.get(users2.pack((42,))),
                sorted(await dl.list(txn, ("app",))), await dl.list(txn))

    out = w.run(sched, body())
    assert out[2:] == (b"alice", ["logs", "users"], ["app"])
    return out


@twin
def directory_errors_and_move_remove(w):
    sched, cluster, db = w.open(n_storage=2)
    D = w.P.directory
    dl = D.DirectoryLayer(rng=np.random.default_rng(0))

    async def body():
        txn = db.create_transaction()
        d = await dl.create(txn, ("a", "b"))
        txn.set(d.pack(("k",)), b"v")
        await txn.commit()
        txn = db.create_transaction()
        with pytest.raises(D.DirectoryAlreadyExists):
            await dl.create(txn, ("a", "b"))
        with pytest.raises(D.DirectoryDoesNotExist):
            await dl.open(txn, ("nope",))
        moved = await dl.move(txn, ("a", "b"), ("a", "c"))
        assert await txn.get(moved.pack(("k",))) == b"v"
        await txn.commit()
        txn = db.create_transaction()
        assert await dl.find(txn, ("a", "b")) is None
        await dl.remove(txn, ("a",))
        await txn.commit()
        txn = db.create_transaction()
        return (moved.key, await dl.find(txn, ("a", "c")),
                await txn.get(moved.pack(("k",))))

    out = w.run(sched, body())
    assert out[1:] == (None, None)
    return out


@twin
def special_key_space(w):
    sched, cluster, db = w.open(n_storage=2)

    async def body():
        txn = db.create_transaction()
        txn.set(b"x", b"1")
        await txn.commit()
        txn = db.create_transaction()
        return (await txn.get(b"\xff\xff/status/json"),
                await txn.get(b"\xff\xff/cluster/epoch"),
                await txn.get(b"\xff\xff/unknown"))

    status, epoch, missing = w.run(sched, body())
    conf = json.loads(status)["cluster"]["configuration"]
    # JAX names its unset knob "tpu"; the twin sets the backend
    assert conf.pop("resolver_backend") == w.backend
    assert epoch == b"1" and missing is None
    return conf, epoch, missing


@twin
def consistency_check_clean_and_after_moves(w):
    sched, cluster, db = w.open(n_storage=2)
    check = w.P.consistency.check_cluster

    async def body():
        txn = db.create_transaction()
        for i in range(30):
            txn.set(b"cc%02d" % i, b"v")
        await txn.commit()
        await sched.delay(0.05)
        s1 = check(cluster)
        await cluster.data_distributor.move_shard(b"cc10", b"cc20", 1)
        await sched.delay(0.2)
        return s1, check(cluster)

    s1, s2 = w.run(sched, body())
    assert s1["keys_checked"] >= 30 and s2["shards_checked"] >= 3
    return s1, s2


@twin
def consistency_check_detects_corruption(w):
    sched, cluster, db = w.open(n_storage=2)
    check = w.P.consistency.check_cluster

    async def body():
        txn = db.create_transaction()
        txn.set(b"zz", b"v")
        await txn.commit()
        await sched.delay(0.05)

    w.run(sched, body())
    ss = cluster.storage_servers[cluster.key_servers.shard_of(b"zz")]
    ss._live_count += 1
    with pytest.raises(Exception) as e:
        check(cluster)
    ss._live_count -= 1
    return type(e.value).__name__, check(cluster)


@twin
def hca_concurrent_allocations_unique(w):
    sched, cluster, db = w.open(n_commit_proxies=2, n_storage=2)
    hca = w.P.directory.HighContentionAllocator(np.random.default_rng(0))
    allocated, conflicts = [], [0]

    async def worker():
        for _ in range(15):
            while True:
                txn = db.create_transaction()
                n = await hca.allocate(txn)
                try:
                    await txn.commit()
                    allocated.append(n)
                    break
                except w.P.commit_proxy.NotCommitted:
                    conflicts[0] += 1

    tasks = [sched.spawn(worker(), name=f"hca{i}") for i in range(6)]
    sched.run_until(w.P.flow.all_of([t.done for t in tasks]))
    for t in tasks:
        t.done.get()
    assert len(allocated) == 90 and len(set(allocated)) == 90
    return allocated, conflicts[0]


@twin
def hca_window_advances(w):
    sched, cluster, db = w.open(n_commit_proxies=1, n_storage=2)
    hca = w.P.directory.HighContentionAllocator(np.random.default_rng(1))

    async def go():
        got = []
        for _ in range(100):
            txn = db.create_transaction()
            got.append(await hca.allocate(txn))
            await txn.commit()
        return got

    got = w.run(sched, go())
    assert len(set(got)) == 100 and max(got) >= 64
    return got


# ---------------------------------------------------------------------------
# tests/test_taskbucket.py


def _bucket(w):
    sched, cluster, db = w.open()
    return sched, db, w.P.taskbucket.TaskBucket(db)


@twin
def add_claim_finish_roundtrip(w):
    sched, db, tb = _bucket(w)

    async def body():
        await tb.add(b"t1", {"op": "copy", "src": "a"})
        await tb.add(b"t2", {"op": "copy", "src": "b"})
        t = await tb.get_one()
        assert t.key == b"t1" and t.params == {"op": "copy", "src": "a"}
        t2 = await tb.get_one()
        assert t2.key == b"t2"
        assert await tb.get_one() is None
        await tb.finish(t)
        await tb.finish(t2)
        assert await tb.is_empty()
        return t, t2

    return w.run(sched, body())


@twin
def crashed_executor_lease_expires_and_requeues(w):
    sched, db, tb = _bucket(w)
    TB = w.P.taskbucket.TaskBucket

    async def body():
        await tb.add(b"job", {"n": "1"})
        t = await tb.get_one()
        assert t is not None and await tb.get_one() is None
        await sched.delay(TB.LEASE + 0.1)
        assert await tb.check_timeouts() == 1
        t2 = await tb.get_one()
        assert t2.key == b"job" and t2.params == {"n": "1"}
        await tb.finish(t2)
        assert await tb.is_empty()
        return t, t2

    return w.run(sched, body())


@twin
def extend_keeps_lease_alive(w):
    sched, db, tb = _bucket(w)
    TB = w.P.taskbucket.TaskBucket

    async def body():
        await tb.add(b"long", {})
        t = await tb.get_one()
        for _ in range(3):
            await sched.delay(TB.LEASE * 0.6)
            await tb.extend(t)
        assert await tb.check_timeouts() == 0
        await tb.finish(t)
        assert await tb.is_empty()
        return t

    return w.run(sched, body())


@twin
def dependency_unblocks_on_finish(w):
    sched, db, tb = _bucket(w)

    async def body():
        await tb.add(b"parent", {"step": "1"})
        await tb.add(b"child", {"step": "2"}, after=b"parent")
        p = await tb.get_one()
        assert p.key == b"parent" and await tb.get_one() is None
        await tb.finish(p)
        c = await tb.get_one()
        assert c.key == b"child"
        await tb.finish(c)
        assert await tb.is_empty()
        return p, c

    return w.run(sched, body())


@twin
def concurrent_claimers_get_distinct_tasks(w):
    sched, db, tb = _bucket(w)

    async def body():
        for i in range(4):
            await tb.add(b"w%d" % i, {"i": str(i)})

        async def worker():
            got = []
            while True:
                t = await tb.get_one()
                if t is None:
                    return got
                got.append(t.key)
                await tb.finish(t)

        t1, t2 = sched.spawn(worker()), sched.spawn(worker())
        g1, g2 = await t1.done, await t2.done
        assert sorted(g1 + g2) == [b"w0", b"w1", b"w2", b"w3"]
        assert not set(g1) & set(g2)
        return g1, g2

    return w.run(sched, body())


@twin
def after_already_finished_parent_enqueues_immediately(w):
    sched, db, tb = _bucket(w)

    async def body():
        await tb.add(b"p", {})
        await tb.finish(await tb.get_one())
        await tb.add(b"c", {}, after=b"p")
        c = await tb.get_one()
        assert c.key == b"c"
        await tb.finish(c)
        assert await tb.is_empty()
        return c

    return w.run(sched, body())


@twin
def stale_finish_raises_after_requeue(w):
    sched, db, tb = _bucket(w)
    TB = w.P.taskbucket.TaskBucket

    async def body():
        await tb.add(b"t", {})
        await tb.add(b"dep", {}, after=b"t")
        a = await tb.get_one()
        await sched.delay(TB.LEASE + 0.1)
        assert await tb.check_timeouts() == 1
        b = await tb.get_one()
        assert b.key == b"t"
        with pytest.raises(KeyError):
            await tb.finish(a)
        assert (await tb.get_one()) is None
        await tb.finish(b)
        c = await tb.get_one()
        assert c.key == b"dep"
        await tb.finish(c)
        return a, b, c

    return w.run(sched, body())


@twin
def slashed_parent_keys_unambiguous(w):
    sched, db, tb = _bucket(w)

    async def body():
        await tb.add(b"a", {})
        await tb.add(b"a/b", {})
        await tb.add(b"x", {}, after=b"a/b")
        pa, pab = await tb.get_one(), await tb.get_one()
        by_key = {t.key: t for t in (pa, pab)}
        await tb.finish(by_key[b"a"])
        assert (await tb.get_one()) is None
        await tb.finish(by_key[b"a/b"])
        x = await tb.get_one()
        assert x.key == b"x"
        await tb.finish(x)
        assert await tb.is_empty()
        return pa, pab, x

    return w.run(sched, body())


@twin
def blocked_parent_counts_as_live(w):
    sched, db, tb = _bucket(w)

    async def body():
        await tb.add(b"A", {})
        await tb.add(b"B", {}, after=b"A")
        await tb.add(b"C", {}, after=b"B")
        a = await tb.get_one()
        assert a.key == b"A" and (await tb.get_one()) is None
        await tb.finish(a)
        b = await tb.get_one()
        assert b.key == b"B" and (await tb.get_one()) is None
        await tb.finish(b)
        c = await tb.get_one()
        assert c.key == b"C"
        await tb.finish(c)
        assert await tb.is_empty()
        return a, b, c

    return w.run(sched, body())


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("name", list(TWINS))
def test_twin(name, pair):
    check_twin(TWINS[name], pair)


def test_twins_cover_their_sources():
    """Every test of the three reference files has its twin here."""
    import ast
    from pathlib import Path

    here = {n.removeprefix("test_") for n in globals() if
            n.startswith("test_")} | set(TWINS)
    for src in ("test_layers_atomic.py", "test_directory_consistency.py",
                "test_taskbucket.py"):
        tree = ast.parse((Path(__file__).parent / src).read_text())
        names = {n.name.removeprefix("test_") for n in tree.body
                 if isinstance(n, ast.FunctionDef)
                 and n.name.startswith("test_")}
        assert names <= here, sorted(names - here)


def test_taskbucket_probes_fire_in_a_twin():
    """The TaskBucket's declared probes (a claim raced, a lease expired
    and requeued, a parked task unblocked) each fire in the port's run of
    a twin, as in the JAX package's."""
    want = {"taskbucket.claim_raced", "taskbucket.lease_expired_requeued",
            "taskbucket.unblocked"}
    fired = set()
    for name in ("concurrent_claimers_get_distinct_tasks",
                 "stale_finish_raises_after_requeue"):
        fired |= set(check_twin(TWINS[name], PAIRS[0])["probes"])
    assert want <= fired, sorted(want - fired)
