"""The port's blob granules (`cluster/blob_granules.py`: `Granule`,
`BlobWorker`, `BlobManager`) held against the JAX package's on the CPU.

Twins (tests/twins.py) of every test of tests/test_blob_granules.py,
written once against a package namespace and run through both pairs of
backends: snapshot and delta files written under load, the mapping in
the system keyspace, point-in-time reads, files-only reads equal to the
transactional view, a split by size and time travel across it. The
digest holds every granule's bounds and every file the worker wrote;
the blob probes are seen firing in a twin.
"""

from __future__ import annotations

import numpy as np
import pytest

from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from twins import JAX, PAIR_IDS, PAIRS, PORT, check_twin, ns

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

TWINS = {}


def twin(fn):
    TWINS[fn.__name__] = fn
    return fn


def open_blobbed(w, n_workers=1):
    sched, cluster, db = w.open(n_storage=2)
    BG = w.P.blob_granules
    container = w.P.backup.BackupContainer()
    workers = [BG.BlobWorker(sched, cluster.tlog, container,
                             name=f"blobworker{i}") for i in range(n_workers)]
    for wk in workers:
        wk.start()
    return sched, cluster, db, container, workers, BG.BlobManager(db, workers)


def _files(container):
    return {n: container.read_file(n) for n in container.list_files("")}


def _granules(mgr):
    return sorted((g.gid, g.begin, g.end, tuple(g.snapshot_versions),
                   tuple(g.delta_versions)) for g in mgr.granules.values())


@twin
def granule_files_written_under_load(w):
    sched, cluster, db, container, (wk,), mgr = open_blobbed(w)
    prefix = w.P.blob_granules.MAPPING_PREFIX

    async def body():
        await mgr.blobbify(b"", b"", {}, 0)
        for i in range(64):
            txn = db.create_transaction()
            txn.set(b"bk%03d" % i, b"x" * 128)
            await txn.commit()
        await sched.delay(0.3)
        return await db.create_transaction().get_range(prefix,
                                                       prefix + b"\xff")

    mapping = w.run(sched, body())
    snaps = container.list_files("granules/0/snapshot/")
    deltas = container.list_files("granules/0/delta/")
    assert snaps and deltas and mapping
    return mapping, _files(container), _granules(mgr)


@twin
def point_in_time_granule_read(w):
    sched, cluster, db, container, (wk,), mgr = open_blobbed(w)

    async def body():
        await mgr.blobbify(b"", b"", {}, 0)
        txn = db.create_transaction()
        txn.set(b"k1", b"old")
        await txn.commit()
        v1 = cluster.tlog.version.get()
        await sched.delay(0.1)
        txn = db.create_transaction()
        txn.set(b"k1", b"new")
        txn.set(b"k2", b"v2")
        await txn.commit()
        txn = db.create_transaction()
        txn.clear(b"k2")
        await txn.commit()
        await sched.delay(0.2)
        return v1, mgr.read(b"", b"", v1), mgr.read(b"", b"")

    v1, past, now = w.run(sched, body())
    assert past[b"k1"] == b"old" and b"k2" not in past
    assert now[b"k1"] == b"new" and b"k2" not in now
    return v1, past, now, _files(container)


@twin
def granule_read_matches_database(w):
    sched, cluster, db, container, (wk,), mgr = open_blobbed(w)

    async def body():
        await mgr.blobbify(b"", b"", {}, 0)
        rng = np.random.default_rng(7)
        model = {}
        for i in range(120):
            txn = db.create_transaction()
            k = b"g%02d" % rng.integers(0, 40)
            if rng.random() < 0.2:
                txn.clear(k)
                model.pop(k, None)
            else:
                txn.set(k, b"v%d" % i)
                model[k] = b"v%d" % i
            await txn.commit()
        await sched.delay(0.3)
        stored = dict(await db.create_transaction().get_range(b"g", b"h"))
        return model, mgr.read(b"", b""), stored

    model, got, stored = w.run(sched, body())
    assert got == model == stored
    return got, _granules(mgr)


@twin
def granule_split_on_size(w):
    sched, cluster, db, container, (wk,), mgr = open_blobbed(w)

    async def body():
        await mgr.blobbify(b"", b"", {}, 0)
        val = b"z" * 512
        for i in range(160):
            txn = db.create_transaction()
            txn.set(b"s%04d" % i, val)
            await txn.commit()
        await sched.delay(0.4)
        return mgr.read(b"", b"")

    got = w.run(sched, body())
    assert len(mgr.granules) >= 2
    bounds = sorted((g.begin, g.end) for g in mgr.granules.values())
    for (_b1, e1), (b2, _e2) in zip(bounds, bounds[1:]):
        assert e1 == b2, bounds
    assert len(got) == 160 and got[b"s0000"] == got[b"s0159"] == b"z" * 512
    return sorted(got), _granules(mgr), sorted(container.list_files(""))


@twin
def time_travel_survives_split(w):
    sched, cluster, db, container, (wk,), mgr = open_blobbed(w)

    async def body():
        await mgr.blobbify(b"", b"", {}, 0)
        txn = db.create_transaction()
        txn.set(b"zz-early", b"ancient")
        await txn.commit()
        await sched.delay(0.1)
        v_past = cluster.tlog.version.get()
        for i in range(160):
            txn = db.create_transaction()
            txn.set(b"s%04d" % i, b"z" * 512)
            await txn.commit()
        await sched.delay(0.4)
        assert len(mgr.granules) >= 2
        return v_past, mgr.read(b"", b"", v_past)

    v_past, past = w.run(sched, body())
    assert past.get(b"zz-early") == b"ancient"
    assert not any(k.startswith(b"s0") for k in past)
    return v_past, past, _granules(mgr)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("name", list(TWINS))
def test_twin(name, pair):
    check_twin(TWINS[name], pair)


def test_twins_cover_their_sources():
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).parent / "test_blob_granules.py")
                     .read_text())
    names = {n.name.removeprefix("test_") for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    assert names == set(TWINS)


def test_blob_probes_fire_in_a_twin():
    """blob.delta_flushed, .resnapshotted, .granule_split and
    .time_travel_read fire in the port's run of the time-travel twin, as
    in JAX's."""
    hits = check_twin(TWINS["time_travel_survives_split"], PAIRS[0])["probes"]
    want = {"blob.delta_flushed", "blob.resnapshotted", "blob.granule_split",
            "blob.time_travel_read"}
    assert want <= set(hits), hits


def test_thresholds_are_the_jax_ones():
    J, P = ns(JAX).blob_granules, ns(PORT).blob_granules
    for cls, names in (("BlobWorker", ("DELTA_FLUSH_BYTES",
                                       "SNAPSHOT_AT_DELTA_BYTES")),
                       ("BlobManager", ("SPLIT_BYTES",))):
        for n in names:
            assert getattr(getattr(P, cls), n) == getattr(getattr(J, cls), n)
    assert P.MAPPING_PREFIX == J.MAPPING_PREFIX
