"""The port's parallel restore (`cluster/restore.py`), blob store
(`cluster/blob_store.py`) and the cli's backup and restore held against
the JAX package's on the CPU.

Twins (tests/twins.py) of every test of tests/test_backup_roles.py and
of tests/test_backup_cli.py's snapshot, point-in-time and cli backup
tests, each written once against a package namespace: the object
server's REST surface and its persistence across a restart (no cluster:
both packages' results equal), and on both pairs of backends a backup
and restore through the object store, a log backup across a recovery,
`ParallelRestore` at 4 and 3 appliers (a clear split at applier bounds,
a target version), the snapshot and point-in-time restores and the cli's
`backup` and `restore`. Also: each package's container reads what the
other's server stores.
"""

from __future__ import annotations

import struct

import pytest

from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from twins import JAX, PAIR_IDS, PAIRS, PORT, check_packages, check_twin, \
    ns

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

TWINS = {}


def twin(fn):
    TWINS[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# tests/test_backup_roles.py: the object store


def test_blob_store_object_roundtrip():
    def body(w):
        B = w.P.blob_store
        srv, port = B.serve_blob_store(w.tmp + "/objs")
        try:
            c = B.BlobStoreContainer(f"127.0.0.1:{port}", bucket="b1")
            c.write_file("snapshots/0001/manifest", {"version": 1, "files": 0})
            c.write_file("snapshots/0001/range_000000", [[b"k", b"v"]])
            c.write_file("logs/0002", {"0002": []})
            out = [c.read_file("snapshots/0001/manifest"),
                   c.read_file("snapshots/0001/range_000000"),
                   c.list_files("snapshots/")]
            c.delete_file("logs/0002")
            out.append(c.list_files("logs/"))
            with pytest.raises(FileNotFoundError):
                c.read_file("logs/0002")
            c.close()
        finally:
            srv.shutdown()
            srv.server_close()
        assert out[0]["version"] == 1 and out[1] == [[b"k", b"v"]]
        assert out[2] == ["snapshots/0001/manifest",
                          "snapshots/0001/range_000000"] and out[3] == []
        return out
    check_packages(body)


def test_blob_store_persists_across_server_restart():
    def body(w):
        B = w.P.blob_store
        objdir = w.tmp + "/objs"
        srv, port = B.serve_blob_store(objdir)
        c = B.BlobStoreContainer(f"127.0.0.1:{port}")
        c.write_file("durable/file", {"x": 1})
        c.close()
        srv.shutdown()
        srv.server_close()
        srv2, port2 = B.serve_blob_store(objdir)
        try:
            c2 = B.BlobStoreContainer(f"127.0.0.1:{port2}")
            got = c2.read_file("durable/file")
            c2.close()
        finally:
            srv2.shutdown()
            srv2.server_close()
        assert got == {"x": 1}
        return got
    check_packages(body)


def test_blob_store_across_packages(tmp_path):
    """The REST surface and the object encoding are one protocol: each
    package's container reads and lists what the other's server holds,
    and both servers keep the same files."""
    J, P = ns(JAX).blob_store, ns(PORT).blob_store
    data = {"snapshots/0001/range_000000": [[b"k\x00", b"v\xff"]],
            "logs/0002": {"0002": [["set", b"a", b"b"]]}}
    for serve, client, other in ((J, P, "jax"), (P, J, "port")):
        srv, port = serve.serve_blob_store(str(tmp_path / other))
        try:
            c = client.BlobStoreContainer(f"127.0.0.1:{port}", bucket="x/y")
            for name, v in data.items():
                c.write_file(name, v)
            assert c.list_files("") == sorted(data)
            assert {n: c.read_file(n) for n in data} == data
            c.close()
        finally:
            srv.shutdown()
            srv.server_close()
    files = sorted(p.relative_to(tmp_path / "jax").as_posix()
                   for p in (tmp_path / "jax").rglob("*"))
    assert files == sorted(p.relative_to(tmp_path / "port").as_posix()
                           for p in (tmp_path / "port").rglob("*"))
    for f in files:
        a, b = tmp_path / "jax" / f, tmp_path / "port" / f
        assert a.is_dir() or a.read_bytes() == b.read_bytes()


# ---------------------------------------------------------------------------
# tests/test_backup_roles.py: through a cluster


def _world(w):
    return w.open(n_commit_proxies=2, n_resolvers=1, n_storage=2)


@twin
def backup_restore_through_blob_store(w):
    sched, cluster, db = _world(w)
    B = w.P.blob_store
    srv, port = B.serve_blob_store(w.tmp + "/objs")
    try:
        cont = B.BlobStoreContainer(f"127.0.0.1:{port}")
        agent = w.P.backup.BackupAgent(db, cont)

        async def body():
            t = db.create_transaction()
            for i in range(20):
                t.set(b"bk%02d" % i, b"bv%d" % i)
            await t.commit()
            v = await agent.snapshot()
            t = db.create_transaction()
            t.clear_range(b"", b"\xff")
            await t.commit()
            r = await agent.restore()
            return v, r, await db.create_transaction().get_range(b"bk", b"bl")

        v, r, items = w.run(sched, body())
        files = cont.list_files("")
        cont.close()
    finally:
        srv.shutdown()
        srv.server_close()
    assert len(items) == 20 and items[0] == (b"bk00", b"bv0")
    return v, r, items, files


@twin
def backup_worker_survives_recovery(w):
    sched, cluster, db = _world(w)
    cont = w.P.backup.BackupContainer()
    agent = w.P.backup.BackupAgent(db, cont)

    async def body():
        await agent.snapshot()
        agent.start_log_backup(cluster)
        t = db.create_transaction()
        for i in range(5):
            t.set(b"pre%d" % i, b"v%d" % i)
        await t.commit()
        await sched.delay(0.2)
        p = cluster.commit_proxies[0]
        p.failed = RuntimeError("simulated crash")
        p.stop()
        await sched.delay(1.0)
        assert cluster.controller.epoch >= 2
        t = db.create_transaction()
        for i in range(5):
            t.set(b"post%d" % i, b"w%d" % i)
        await t.commit()
        await sched.delay(0.5)
        agent.stop_log_backup()
        assert w.P.probes.snapshot().get("backup_worker.displaced")
        t = db.create_transaction()
        t.clear_range(b"", b"\xff")
        await t.commit()
        await agent.restore()
        t = db.create_transaction()
        return (await t.get_range(b"pre", b"prf"),
                await t.get_range(b"post", b"posu"))

    pre, post = w.run(sched, body())
    assert len(pre) == 5 and len(post) == 5
    return pre, post, cont.list_files("")


def _agent_with_data(w, sched, db, n=200):
    cont = w.P.backup.BackupContainer()
    agent = w.P.backup.BackupAgent(db, cont)

    async def load():
        t = db.create_transaction()
        for i in range(n):
            t.set(b"pk%06d" % i, b"pv%d" % i)
        await t.commit()

    w.run(sched, load())
    return cont, agent


@twin
def parallel_restore_matches_sequential(w):
    sched, cluster, db = _world(w)
    cont, agent = _agent_with_data(w, sched, db)

    async def body():
        await agent.snapshot()
        agent.start_log_backup(cluster)
        t = db.create_transaction()
        t.set(b"pk000050", b"UPDATED")
        t.clear_range(b"pk000100", b"pk000150")
        t.add(b"counter", 7)
        await t.commit()
        await sched.delay(0.3)
        agent.stop_log_backup()
        t = db.create_transaction()
        t.clear_range(b"", b"\xff")
        await t.commit()
        stats = await w.P.restore.ParallelRestore(db, cont,
                                                  n_appliers=4).run()
        return stats, dict(await db.create_transaction().get_range(
            b"", b"\xff"))

    stats, rows = w.run(sched, body())
    assert stats.appliers >= 2 and stats.mutations_applied > 0
    assert rows[b"pk000050"] == b"UPDATED"
    assert b"pk000100" not in rows and b"pk000149" not in rows
    assert rows[b"pk000151"] == b"pv151"
    assert struct.unpack("<q", rows[b"counter"])[0] == 7
    assert rows[b"pk000000"] == b"pv0" and rows[b"pk000199"] == b"pv199"
    return stats, rows


@twin
def parallel_restore_target_version(w):
    sched, cluster, db = _world(w)
    cont, agent = _agent_with_data(w, sched, db, n=10)

    async def body():
        await agent.snapshot()
        agent.start_log_backup(cluster)
        t = db.create_transaction()
        t.set(b"early", b"1")
        v_early = await t.commit()
        t = db.create_transaction()
        t.set(b"late", b"2")
        await t.commit()
        await sched.delay(0.3)
        agent.stop_log_backup()
        t = db.create_transaction()
        t.clear_range(b"", b"\xff")
        await t.commit()
        stats = await w.P.restore.ParallelRestore(db, cont, n_appliers=3).run(
            target_version=v_early)
        t = db.create_transaction()
        return stats, await t.get(b"early"), await t.get(b"late")

    stats, early, late = w.run(sched, body())
    assert early == b"1" and late is None
    assert stats.restored_version <= stats.snapshot_version + 10**9
    return stats, early, late


def test_partition_splits_at_sampled_keys():
    """`_partition`, the controller's applier shards, as the JAX package
    cuts them (the loader's split of a clear at their bounds is the
    parallel_restore_matches_sequential twin's)."""
    J, P = ns(JAX).restore, ns(PORT).restore
    keys = [b"k%04d" % i for i in range(0, 1000, 7)]
    for n in (1, 2, 3, 4, 7, len(keys), len(keys) + 1):
        assert P._partition(keys, n) == J._partition(keys, n)
    assert P._partition([b"a"] * 8, 4) == J._partition([b"a"] * 8, 4)


# ---------------------------------------------------------------------------
# tests/test_backup_cli.py: snapshot, point in time, the cli's backup


def _cli_world(w):
    return w.open(n_storage=2)


@twin
def snapshot_restore_roundtrip(w):
    sched, cluster, db = _cli_world(w)
    agent = w.P.backup.BackupAgent(db, w.P.backup.BackupContainer())

    async def body():
        txn = db.create_transaction()
        for i in range(20):
            txn.set(b"bk%02d" % i, b"v%d" % i)
        await txn.commit()
        v = await agent.snapshot()
        txn = db.create_transaction()
        txn.clear_range(b"bk00", b"bk99")
        txn.set(b"junk", b"x")
        await txn.commit()
        await agent.restore()
        return v, await db.create_transaction().get_range(b"", b"\xff")

    v, items = w.run(sched, body())
    assert v > 0 and [k for k, _ in items] == [b"bk%02d" % i
                                               for i in range(20)]
    return v, items


@twin
def log_backup_point_in_time(w):
    sched, cluster, db = _cli_world(w)
    agent = w.P.backup.BackupAgent(db, w.P.backup.BackupContainer())

    async def body():
        txn = db.create_transaction()
        txn.set(b"pit", b"one")
        await txn.commit()
        await agent.snapshot()
        agent.start_log_backup(cluster)
        txn = db.create_transaction()
        txn.set(b"pit", b"two")
        txn.add(b"pitctr", 7)
        await txn.commit()
        mid = txn.committed_version
        await sched.delay(0.1)
        txn = db.create_transaction()
        txn.set(b"pit", b"three")
        await txn.commit()
        await sched.delay(0.1)
        agent.stop_log_backup()
        await agent.restore(target_version=mid)
        txn = db.create_transaction()
        return await txn.get(b"pit"), await txn.get(b"pitctr")

    got = w.run(sched, body())
    assert got == (b"two", (7).to_bytes(8, "little"))
    return got


@twin
def cli_backup_restore(w):
    sched, cluster, db = _cli_world(w)
    cli = w.P.cli.CliSession(cluster, db)
    path = w.tmp + "/bk"

    async def body():
        await cli.run_command("writemode on")
        await cli.run_command("set persist me")
        out1 = await cli.run_command(f"backup {path}")
        await cli.run_command("clear persist")
        out2 = await cli.run_command(f"restore {path}")
        return out1, out2, await cli.run_command("get persist")

    out1, out2, out3 = out = w.run(sched, body())
    assert out1.startswith("Snapshot complete") and out2.startswith("Restored")
    assert out3 == "`persist' is `me'"
    return out


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("name", list(TWINS))
def test_twin(name, pair):
    check_twin(TWINS[name], pair)


def test_twins_cover_their_sources():
    import ast
    from pathlib import Path

    here = {n.removeprefix("test_") for n in globals()
            if n.startswith("test_")} | set(TWINS)
    tree = ast.parse((Path(__file__).parent / "test_backup_roles.py")
                     .read_text())
    names = {n.name.removeprefix("test_") for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    assert names <= here, sorted(names - here)
    assert {"snapshot_restore_roundtrip", "log_backup_point_in_time",
            "cli_backup_restore"} <= set(TWINS)
