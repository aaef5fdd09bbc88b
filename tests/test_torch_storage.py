"""The port's persistence, held against the JAX package on the CPU.

* The DiskQueue (native/diskqueue.cpp) and the VersionedLsm
  (native/vlsm.cpp), built from byte-identical copies of the JAX
  sources: twins of tests/test_restart.py's DiskQueue cases and of
  tests/test_vlsm.py.
* The Storage role's mutation log: the tail replay after a crash on the
  memory and `lsm` engines, an LSM dataset past its memtable, and a
  save-and-kill restart (the roles served in this process, dropped
  without a clean shutdown, then reopened, storage catching up from the
  recovered tlog) that keeps every acked commit.
* The on-disk formats of earlier rounds: the port's roles open copies
  of tests/fixtures/ondisk_r4 (diskqueue, memory, lsm) to the state its
  EXPECT.json records, as the JAX roles do; ondisk_r5's encrypted store
  is refused by its marker's RuntimeError without encryption, and with
  `default_encryption()` the port's role serves its values at version
  120, as the JAX role does.
* A data dir one package writes, the other opens to the same state (the
  tlog, the memory engine, the LSM).

The tolerance is equality throughout.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import struct
import tempfile

import numpy as np
import pytest

from foundationdb_tpu.cluster import multiprocess as JMP
from foundationdb_tpu.wire import codec as JC
from foundationdb_tpu_torch import native
from foundationdb_tpu_torch.cluster import multiprocess as mp
from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.wire import codec as PC
from foundationdb_tpu_torch.wire import transport
from foundationdb_tpu_torch.wire.codec import Mutation

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
S = native.VersionedLsm.MUT_SET
C = native.VersionedLsm.MUT_CLEAR_RANGE


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def test_sources_are_the_jax_package_s():
    for name in ("diskqueue.cpp", "vlsm.cpp"):
        with open(os.path.join(os.path.dirname(native.__file__), name),
                  "rb") as f, open(os.path.join(
                os.path.dirname(JMP.__file__), "..", "native", name),
                "rb") as g:
            assert f.read() == g.read(), name


# ---------------------------------------------------------------------------
# DiskQueue (twins of tests/test_restart.py)


def test_diskqueue_commit_recover_roundtrip(tmp_path):
    q = native.DiskQueue(str(tmp_path / "log"))
    assert q.recovered == []
    s0 = q.push(b"alpha")
    s1 = q.push(b"beta" * 100)
    assert q.commit() == s1
    q.push(b"NEVER-COMMITTED")
    q.close()
    q2 = native.DiskQueue(str(tmp_path / "log"))
    assert q2.recovered == [(s0, b"alpha"), (s1, b"beta" * 100)]
    s2 = q2.push(b"gamma")
    assert s2 == s1 + 1
    q2.commit()
    q2.close()
    q3 = native.DiskQueue(str(tmp_path / "log"))
    assert [d for _s, d in q3.recovered] == [b"alpha", b"beta" * 100,
                                            b"gamma"]


def test_diskqueue_pop_discards_prefix(tmp_path):
    q = native.DiskQueue(str(tmp_path / "log"))
    for i in range(10):
        q.push(b"rec%d" % i)
    q.commit()
    q.pop(7)
    q.commit()
    q.close()
    q2 = native.DiskQueue(str(tmp_path / "log"))
    assert [d for _s, d in q2.recovered] == [b"rec7", b"rec8", b"rec9"]
    assert q2.pop_floor == 7


def test_diskqueue_torn_tail_truncated(tmp_path):
    q = native.DiskQueue(str(tmp_path / "log"))
    q.push(b"good-one")
    q.push(b"good-two")
    q.commit()
    q.close()
    with open(str(tmp_path / "log") + "-0.dq", "ab") as f:
        f.write(struct.pack("<IQII", 0xD15C0001, 2, 1000, 0xDEAD))
        f.write(b"short")
    q2 = native.DiskQueue(str(tmp_path / "log"))
    assert [d for _s, d in q2.recovered] == [b"good-one", b"good-two"]
    q2.push(b"three")
    q2.commit()
    q2.close()
    q3 = native.DiskQueue(str(tmp_path / "log"))
    assert [d for _s, d in q3.recovered] == [b"good-one", b"good-two",
                                            b"three"]


def test_diskqueue_corrupt_record_ends_recovery(tmp_path):
    q = native.DiskQueue(str(tmp_path / "log"))
    for rec in (b"aaaa", b"bbbb", b"cccc"):
        q.push(rec)
    q.commit()
    q.close()
    path = str(tmp_path / "log") + "-0.dq"
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) - 2)
        f.write(b"\xff")
    q2 = native.DiskQueue(str(tmp_path / "log"))
    assert [d for _s, d in q2.recovered] == [b"aaaa", b"bbbb"]


@pytest.mark.parametrize("older_file", [True, False])
def test_diskqueue_interior_corruption_refuses_open(tmp_path, older_file):
    """Damage inside the log with acked records valid past it is not a
    torn tail: the open fails loudly instead of truncating them away."""
    if older_file:
        q = native.DiskQueue(str(tmp_path / "log"), rotate_bytes=4096)
        for _ in range(8):
            q.push(b"x" * 700)
            q.commit()
        at = 100
    else:
        q = native.DiskQueue(str(tmp_path / "log"))
        for i in range(6):
            q.push(b"rec%d" % i + b"y" * 200)
            q.commit()
        at = 260
    q.close()
    with open(str(tmp_path / "log") + "-0.dq", "r+b") as f:
        f.seek(at)
        f.write(b"\xff\xff")
    with pytest.raises(native.NativeBuildError):
        native.DiskQueue(str(tmp_path / "log"))


def test_diskqueue_rotation_bounds_disk(tmp_path):
    q = native.DiskQueue(str(tmp_path / "log"), rotate_bytes=4096)
    payload = b"x" * 256
    for _ in range(200):
        s = q.push(payload)
        q.commit()
        q.pop(s)
    q.close()
    total = sum(os.path.getsize(str(tmp_path / "log") + suf)
                for suf in ("-0.dq", "-1.dq"))
    assert total < 6 * 4096, total
    q2 = native.DiskQueue(str(tmp_path / "log"), rotate_bytes=4096)
    survivors = [d for _s, d in q2.recovered]
    assert 1 <= len(survivors) <= 2 and all(d == payload for d in survivors)


def test_diskqueue_files_cross_packages(tmp_path):
    """Records one package's DiskQueue commits, the other's recovers, and
    appends after them."""
    from foundationdb_tpu import native as jn

    rng = np.random.default_rng(2)
    recs = [bytes(rng.integers(0, 256, int(rng.integers(0, 900)),
                               dtype=np.uint8)) for _ in range(40)]
    for first, second in ((native, jn), (jn, native)):
        path = str(tmp_path / f"{first.__name__.split('.')[0]}-log")
        q = first.DiskQueue(path)
        seqs = []
        for r in recs:
            seqs.append(q.push(r))
            if len(seqs) % 7 == 0:
                q.commit()
        q.commit()
        q.pop(seqs[5])
        q.commit()
        q.close()
        q2 = second.DiskQueue(path)
        assert q2.recovered == list(zip(seqs, recs))[5:]
        s = q2.push(b"next")
        q2.commit()
        q2.close()
        q3 = first.DiskQueue(path)
        assert q3.recovered[-1] == (s, b"next")
        q3.close()


# ---------------------------------------------------------------------------
# the Storage role's mutation log


def _role_get(role, key, version):
    return run(role.get(mp.StorageGet(key=key, version=version))).value


@pytest.mark.parametrize("engine", ["memory", "lsm"])
def test_storage_mutation_log_tail_replay(tmp_path, engine):
    data_dir = str(tmp_path / "sdata")

    def applies(role, lo, hi):
        async def go():
            for i in range(lo, hi):
                await role.apply(mp.StorageApply(
                    version=(i + 1) * 10,
                    mutations=[Mutation(0, b"k%02d" % i, b"v%d" % i)]))
        run(go())

    role = mp.StorageRole(data_dir, engine=engine)
    applies(role, 0, 5)
    role2 = mp.StorageRole(data_dir, engine=engine)
    assert role2.version == 50 and role2.replayed_on_restart == 5
    assert _role_get(role2, b"k04", 50) == b"v4"
    applies(role2, 5, 5 + mp.StorageRole.CHECKPOINT_INTERVAL)
    role3 = mp.StorageRole(data_dir, engine=engine)
    v3 = (5 + mp.StorageRole.CHECKPOINT_INTERVAL) * 10
    assert role3.version == v3 and role3.replayed_on_restart <= 1
    assert _role_get(role3, b"k00", v3) == b"v0"
    last = 4 + mp.StorageRole.CHECKPOINT_INTERVAL
    assert _role_get(role3, b"k%02d" % last, v3) == b"v%d" % last


def test_storage_lsm_dataset_beyond_memtable_kill9(tmp_path):
    data_dir = str(tmp_path / "sdata")
    role = mp.StorageRole(data_dir, engine="lsm")
    val = b"x" * 4096
    n_versions = 80

    async def load():
        for i in range(n_versions):
            await role.apply(mp.StorageApply(
                version=(i + 1) * 10,
                mutations=[Mutation(0, b"big%05d" % (i * 16 + j), val)
                           for j in range(16)]))

    run(load())
    assert role._lsm.num_runs >= 1
    role2 = mp.StorageRole(data_dir, engine="lsm")
    assert role2.version == n_versions * 10
    assert role2.replayed_on_restart < n_versions / 2
    v = role2.version
    assert _role_get(role2, b"big%05d" % 0, v) == val
    assert _role_get(role2, b"big%05d" % (n_versions * 16 - 1), v) == val
    assert _role_get(role2, b"big%05d" % 0, 9) is None
    snap = run(role2.snapshot(mp.StorageSnapshotReq(version=v)))
    assert len(snap.kvs) == n_versions * 16


@pytest.mark.parametrize("engine", ["memory", "lsm"])
def test_save_and_kill_restart(tmp_path, engine):
    """The SaveAndKill shape with the roles served in this process: a
    persistent tlog and storage take a contended load, are dropped with
    no clean shutdown, and come back from their data dirs on new
    sockets, the storage catching up from the recovered tlog; every
    acked commit is there exactly once, and the cluster commits on."""
    sock = tempfile.mkdtemp(prefix="sk")
    tlog_dir, storage_dir = str(tmp_path / "tl"), str(tmp_path / "sd")
    acked: dict = {}
    rng = np.random.default_rng(5)
    order = [int(k) for k in rng.integers(0, 5, 30)]

    def serve(name, index, **kw):
        address = os.path.join(sock, f"{name}{index}.sock")
        return address, asyncio.ensure_future(
            mp._serve_role(name, address, "cpu", device="cpu", **kw))

    async def phase1():
        r_addr, r_task = serve("resolver", 0)
        t_addr, t_task = serve("tlog", 0, data_dir=tlog_dir)
        s_addr, s_task = serve("storage", 0, data_dir=storage_dir,
                               storage_engine=engine)
        res, tlog, storage = [await mp.connect(a)
                              for a in (r_addr, t_addr, s_addr)]
        pipe = mp.ProxyPipeline([res], tlog, storage, batch_interval=0.001)
        pipe.start()
        for k in order:
            key = b"sk%02d" % k
            kr = (key, key + b"\x00")
            rv = await pipe.get_read_version()
            n = int.from_bytes(await pipe.read(key, rv) or b"\0" * 8,
                               "little")
            await pipe.commit(CommitTransaction(
                read_conflict_ranges=[kr], write_conflict_ranges=[kr],
                read_snapshot=rv,
                mutations=[Mutation(0, key, (n + 1).to_bytes(8, "little"))]))
            acked[key] = acked.get(key, 0) + 1
        await pipe.stop()
        for c in (tlog, storage):
            await c.close()
        # the kill: the tlog and storage stop serving, nothing is closed
        for t in (t_task, s_task):
            t.cancel()
        await asyncio.gather(t_task, s_task, return_exceptions=True)
        return r_addr, r_task, res

    async def phase2(r_addr, r_task, res):
        t_addr, t_task = serve("tlog", 2, data_dir=tlog_dir)
        (tlog,) = [await mp.connect(t_addr)]
        s_addr, s_task = serve("storage", 2, data_dir=storage_dir,
                               storage_engine=engine, tlog_address=t_addr)
        storage = await mp.connect(s_addr)
        tv = (await tlog.call(mp.TOKEN_TLOG_VERSION,
                              mp.RoleVersionReq(pad=0))).version
        sv = (await storage.call(mp.TOKEN_STORAGE_VERSION,
                                 mp.RoleVersionReq(pad=0))).version
        rv_res = (await res.call(mp.TOKEN_RESOLVER_VERSION,
                                 mp.RoleVersionReq(pad=0))).version
        assert sv >= tv >= 0
        snap = await storage.call(mp.TOKEN_STORAGE_SNAPSHOT,
                                  mp.StorageSnapshotReq(version=sv))
        assert {k: int.from_bytes(v, "little") for k, v in snap.kvs} == acked
        start = max(tv, rv_res, sv, 0)
        pipe = mp.ProxyPipeline([res], tlog, storage, batch_interval=0.001,
                                start_version=start)
        pipe.start()
        key = b"post-restart"
        v = await pipe.commit(CommitTransaction(
            write_conflict_ranges=[(key, key + b"\x00")],
            mutations=[Mutation(0, key, b"alive")]))
        assert v > start and await pipe.read(key, v) == b"alive"
        await pipe.stop()
        for c in (res, tlog, storage):
            await c.close()
        for t in (r_task, t_task, s_task):
            t.cancel()
        await asyncio.gather(r_task, t_task, s_task, return_exceptions=True)

    async def both():
        await phase2(*await phase1())

    try:
        run(both())
    finally:
        shutil.rmtree(sock, ignore_errors=True)


def test_tlog_restart_after_full_pop_keeps_its_head(tmp_path):
    async def go():
        tlog = mp.TLogRole(str(tmp_path / "tl"))
        for v in (10, 20, 30):
            await tlog.push(mp.TLogPush(version=v, prev_version=v - 10,
                                        mutations=[Mutation(0, b"k", b"v")]))
        await tlog.pop(mp.TLogPop(version=30))
        assert tlog.entries == []
        again = mp.TLogRole(str(tmp_path / "tl"))
        assert again.version == 30 and again.entries == []
        st = again.status()
        assert st["qos"]["queue_bytes"] == 0 and json.dumps(st)

    run(go())


def test_tlog_record_pre_epoch_layout():
    out = PC.WriteBuffer()
    PC.w_u16(out, 0x0210)
    PC.w_i64(out, 42)
    PC.w_i64(out, 41)
    mp._w_mutlist(out, [Mutation(0, b"k", b"v")])
    legacy = out.getvalue()
    rec = mp._decode_tlog_record(legacy)
    assert (rec.version, rec.prev_version, rec.epoch) == (42, 41, 0)
    assert rec.mutations == [Mutation(0, b"k", b"v")]
    assert JC.encode(JMP._decode_tlog_record(legacy)) == PC.encode(rec)
    cur = PC.encode(mp.TLogPush(version=43, prev_version=42, mutations=[],
                                epoch=7))
    assert mp._decode_tlog_record(cur).epoch == 7
    with pytest.raises(PC.CodecError):
        mp._decode_tlog_record(legacy + b"\x00")


# ---------------------------------------------------------------------------
# the on-disk formats of earlier rounds


def _fixture(round_dir, name, tmp_path):
    dst = str(tmp_path / name)
    shutil.copytree(os.path.join(FIXTURES, round_dir, name), dst)
    with open(os.path.join(FIXTURES, round_dir, "EXPECT.json")) as f:
        return dst, json.load(f)[name]


def test_prior_format_diskqueue_opens(tmp_path):
    d, exp = _fixture("ondisk_r4", "diskqueue", tmp_path)
    q = native.DiskQueue(os.path.join(d, "log"), rotate_bytes=2048)
    assert [rec.hex() for _s, rec in q.recovered] == exp["records_hex"]
    s = q.push(b"new-generation")
    q.commit()
    q.close()
    q2 = native.DiskQueue(os.path.join(d, "log"), rotate_bytes=2048)
    assert q2.recovered[-1] == (s, b"new-generation")


def test_prior_format_storage_memory_opens(tmp_path):
    d, exp = _fixture("ondisk_r4", "memory", tmp_path)
    role = mp.StorageRole(d, engine="memory")
    assert role.version == exp["version"]
    v = role.version
    for key, val in exp["present"].items():
        assert _role_get(role, key.encode(), v) == val.encode(), key
    for key in exp["absent"]:
        assert _role_get(role, key.encode(), v) is None, key
    assert _role_get(role, b"shared", v) == exp["shared"].encode()
    run(role.apply(mp.StorageApply(
        version=v + 10, mutations=[Mutation(0, b"newgen", b"ng")])))
    role2 = mp.StorageRole(d, engine="memory")
    assert role2.version == v + 10
    assert _role_get(role2, b"newgen", v + 10) == b"ng"
    assert _role_get(role2, b"mem005", v + 10) == b"val-5"


def test_prior_format_storage_lsm_opens(tmp_path):
    d, exp = _fixture("ondisk_r4", "lsm", tmp_path)
    role = mp.StorageRole(d, engine="lsm")
    assert role.version == exp["version"]
    v = role.version
    val = b"y" * exp["val_len"]
    assert _role_get(role, b"lsm0002", v) == val
    assert _role_get(role, exp["last_key"].encode(), v) == val
    for key in exp["absent"]:
        assert _role_get(role, key.encode(), v) is None, key
    snap = run(role.snapshot(mp.StorageSnapshotReq(version=v)))
    assert len(snap.kvs) == exp["n_keys"] - len(exp["absent"])
    run(role.apply(mp.StorageApply(
        version=v + 10, mutations=[Mutation(0, b"newgen", b"ng")])))
    role2 = mp.StorageRole(d, engine="lsm")
    assert role2.version == v + 10
    assert _role_get(role2, b"newgen", v + 10) == b"ng"
    assert _role_get(role2, b"lsm0002", v + 10) == val


def test_encrypted_store_refused_plain_and_served_sealed(tmp_path):
    """ondisk_r5's sealed LSM: without encryption the marker refuses it
    (RuntimeError, in both packages); with `default_encryption()` (the
    sim KMS, keys fetched by id in a fresh process) the port's
    StorageRole serves EXPECT.json's values at its version, 120, as the
    JAX role does, and the raw files stay ciphertext."""
    pytest.importorskip("cryptography")
    from foundationdb_tpu.crypto.at_rest import (
        default_encryption as jax_default_encryption,
    )

    from foundationdb_tpu_torch.crypto.at_rest import default_encryption

    d, exp = _fixture("ondisk_r5", "encrypted_lsm", tmp_path)
    before = sorted(os.listdir(d))
    with pytest.raises(RuntimeError, match="encryption"):
        mp.StorageRole(d, engine="lsm")
    with pytest.raises(RuntimeError, match="encryption"):
        JMP.StorageRole(d, engine="lsm")
    with pytest.raises(RuntimeError, match="encryption"):
        mp.TLogRole(d)
    assert sorted(os.listdir(d)) == before
    jd = str(tmp_path / "jax_copy")
    shutil.copytree(d, jd)
    port = mp.StorageRole(d, engine="lsm", encryption=default_encryption())
    jax = JMP.StorageRole(jd, engine="lsm",
                          encryption=jax_default_encryption())
    assert port.version == jax.version == exp["version"] == 120
    for key, val in exp["present"].items():
        got = _role_get(port, key.encode(), port.version)
        assert got == val.encode() == _role_get(jax, key.encode(), 120), key
    snap = run(port.snapshot(mp.StorageSnapshotReq(version=120)))
    assert snap.kvs == sorted((k.encode(), v.encode())
                              for k, v in exp["present"].items())
    needle = exp["plaintext_absent"].encode()
    for root, _dirs, files in os.walk(d):
        for fn in files:
            with open(os.path.join(root, fn), "rb") as fh:
                assert needle not in fh.read(), fn
    port.close_disk()
    jax.close_disk()


# ---------------------------------------------------------------------------
# data dirs across packages


async def _write_roles(pkg_mp, d, engine, seed):
    """A tlog and a storage of one package, on one seeded stream of sets
    and range clears, some through single applies, some in batches."""
    rng = np.random.default_rng(seed)
    M = (Mutation if pkg_mp is mp else JC.Mutation)
    tlog = pkg_mp.TLogRole(os.path.join(d, "tl"))
    st = pkg_mp.StorageRole(os.path.join(d, "sd"), engine=engine)
    batch_v, batch_m = [], []
    for i in range(30):
        v = (i + 1) * 100
        muts = [M(0, b"k%03d" % rng.integers(0, 60),
                  bytes(rng.integers(0, 256, int(rng.integers(0, 300)),
                                     dtype=np.uint8)))
                for _ in range(int(rng.integers(1, 5)))]
        if i % 7 == 6:
            lo = int(rng.integers(0, 50))
            muts.append(M(1, b"k%03d" % lo, b"k%03d" % (lo + 5)))
        await tlog.push(pkg_mp.TLogPush(version=v, prev_version=v - 100,
                                        mutations=muts))
        if i % 3:
            await st.apply(pkg_mp.StorageApply(version=v, mutations=muts))
        else:
            batch_v.append(v)
            batch_m.append(muts)
            await st.apply_batch(pkg_mp.StorageApplyBatch(
                versions=batch_v, groups=batch_m))
            batch_v, batch_m = [], []
    await tlog.pop(pkg_mp.TLogPop(version=1200))


async def _read_state(pkg_mp, d, engine):
    tlog = pkg_mp.TLogRole(os.path.join(d, "tl"))
    st = pkg_mp.StorageRole(os.path.join(d, "sd"), engine=engine)
    peek = await tlog.peek_batch(pkg_mp.TLogPeekBatchReq(after_version=-1,
                                                         max_entries=1000))
    snaps = [await st.snapshot(pkg_mp.StorageSnapshotReq(version=v))
             for v in (st.version, 1850)]
    enc = JC.encode if pkg_mp is JMP else PC.encode
    return dict(tlog_version=tlog.version, storage_version=st.version,
                peek=enc(peek), snaps=[(s.version, s.kvs) for s in snaps],
                get=(await st.get(pkg_mp.StorageGet(key=b"k010",
                                                    version=1550))).value)


@pytest.mark.parametrize("engine", ["memory", "lsm"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_data_dir_written_by_one_package_opens_in_the_other(
        tmp_path, engine, writer, reader):
    mods = {"jax": JMP, "port": mp}
    d = str(tmp_path / "w")
    run(_write_roles(mods[writer], d, engine, seed=8))
    copy = str(tmp_path / "copy")
    shutil.copytree(d, copy)
    got = run(_read_state(mods[reader], d, engine))
    want = run(_read_state(mods[writer], copy, engine))
    assert got == want
    assert got["storage_version"] == 3000 and got["tlog_version"] == 3000


# ---------------------------------------------------------------------------
# VersionedLsm (twins of tests/test_vlsm.py)


def _db(tmp_path):
    return native.VersionedLsm(str(tmp_path / "db"))


def test_vlsm_versioned_point_reads(tmp_path):
    db = _db(tmp_path)
    db.apply(10, [(S, b"a", b"v10")])
    db.apply(20, [(S, b"a", b"v20"), (S, b"b", b"bee")])
    for probe in (lambda: None, db.flush):
        probe()
        assert db.get(b"a", 9) is None
        assert db.get(b"a", 10) == b"v10" and db.get(b"a", 19) == b"v10"
        assert db.get(b"a", 20) == b"v20"
        assert db.get(b"b", 15) is None and db.get(b"b", 25) == b"bee"


def test_vlsm_clear_range_versions(tmp_path):
    db = _db(tmp_path)
    db.apply(10, [(S, b"k1", b"a"), (S, b"k2", b"b"), (S, b"k3", b"c")])
    db.apply(20, [(C, b"k1", b"k3")])
    db.apply(30, [(S, b"k2", b"reborn")])
    for probe in (lambda: None, db.flush):
        probe()
        assert db.get(b"k1", 15) == b"a" and db.get(b"k1", 25) is None
        assert db.get(b"k2", 25) is None and db.get(b"k2", 30) == b"reborn"
        assert db.get(b"k3", 25) == b"c"


def test_vlsm_within_version_order(tmp_path):
    db = _db(tmp_path)
    db.apply(5, [(S, b"x", b"old"), (S, b"y", b"old")])
    db.apply(10, [(C, b"a", b"z"), (S, b"x", b"new")])
    db.apply(11, [(S, b"k", b"val"), (C, b"a", b"z")])
    for probe in (lambda: None, db.flush):
        probe()
        assert db.get(b"x", 10) == b"new" and db.get(b"y", 10) is None
        assert db.get(b"k", 11) is None
    db.set_floor(20)
    db.compact()
    assert db.get(b"k", 20) is None and db.range(b"", b"", 20) == []


def test_vlsm_key_versions_straddle_index_boundary(tmp_path):
    db = _db(tmp_path)
    muts = [(S, b"fill%04d" % i, b"x") for i in range(15)]
    db.apply(100, muts + [(S, b"kk", b"v0")])
    for i in range(1, 6):
        db.apply(100 + i, [(S, b"kk", b"v%d" % i)])
    db.flush()
    for i in range(6):
        assert db.get(b"kk", 100 + i) == b"v%d" % i, i


def test_vlsm_restart_recovers_runs_not_memtable(tmp_path):
    db = _db(tmp_path)
    db.apply(10, [(S, b"durable", b"yes")])
    assert db.flush() == 10
    db.apply(20, [(S, b"volatile", b"lost")])
    db.close()
    db2 = _db(tmp_path)
    assert db2.durable_version == 10
    assert db2.get(b"durable", 10) == b"yes"
    assert db2.get(b"volatile", 20) is None


def test_vlsm_range_scan_merges_sources(tmp_path):
    db = _db(tmp_path)
    db.apply(10, [(S, b"a", b"1"), (S, b"c", b"3")])
    db.flush()
    db.apply(20, [(S, b"b", b"2"), (C, b"c", b"d")])
    assert db.range(b"", b"\xff", 10) == [(b"a", b"1"), (b"c", b"3")]
    assert db.range(b"", b"\xff", 20) == [(b"a", b"1"), (b"b", b"2")]
    db.flush()
    assert db.range(b"a", b"c", 20) == [(b"a", b"1"), (b"b", b"2")]
    assert db.range(b"b", b"\xff", 10) == [(b"c", b"3")]


def test_vlsm_floor_gc(tmp_path):
    db = _db(tmp_path)
    for v in range(1, 11):
        db.apply(v, [(S, b"k", b"v%d" % v)])
        db.flush()
    db.set_floor(5)
    db.compact()
    assert db.num_runs == 1
    for v in range(5, 11):
        assert db.get(b"k", v) == b"v%d" % v
    db2 = native.VersionedLsm(str(tmp_path / "db2"))
    db2.apply(1, [(S, b"dead", b"x"), (S, b"live", b"y")])
    db2.apply(2, [(C, b"dead", b"dead\x00")])
    db2.flush()
    db2.set_floor(10)
    db2.compact()
    assert db2.get(b"dead", 10) is None
    assert db2.range(b"", b"\xff", 10) == [(b"live", b"y")]


def test_vlsm_data_larger_than_memtable_budget(tmp_path):
    db = _db(tmp_path)
    n, version = 20_000, 0
    for i in range(0, n, 500):
        version += 1
        db.apply(version, [(S, b"key%08d" % j, b"val%08d" % j)
                           for j in range(i, i + 500)])
        if db.mem_bytes > 64 * 1024:
            db.flush()
    db.flush()
    assert db.mem_bytes == 0 and db.num_runs <= 9
    for j in (0, 1, 499, 500, 12345, n - 1):
        assert db.get(b"key%08d" % j, version) == b"val%08d" % j
    db.close()
    db2 = _db(tmp_path)
    assert db2.durable_version == version
    assert len(db2.range(b"", b"\xff", version)) == n


def test_vlsm_orphan_run_swept_and_reopens(tmp_path):
    d = str(tmp_path / "db")
    for cycle in range(5):
        db = native.VersionedLsm(d)
        db.apply(cycle + 1, [(S, b"cycle", b"%d" % cycle)])
        db.flush()
        db.close()
    orphan = os.path.join(d, "999999.sst")
    with open(orphan, "wb") as f:
        f.write(b"garbage that is not a run")
    db = native.VersionedLsm(d)
    assert not os.path.exists(orphan)
    assert db.get(b"cycle", 10) == b"4" and db.durable_version == 5


def test_vlsm_files_cross_packages(tmp_path):
    from foundationdb_tpu import native as jn

    rng = np.random.default_rng(6)
    for first, second in ((native, jn), (jn, native)):
        d = str(tmp_path / first.__name__.split(".")[0])
        db = first.VersionedLsm(d)
        for v in range(1, 40):
            lo = int(rng.integers(0, 90))
            db.apply(v, [(S, b"k%02d" % rng.integers(0, 100), b"v%d" % v),
                         (C, b"k%02d" % lo, b"k%02d" % (lo + 3))])
            if v % 9 == 0:
                db.flush()
        want = [db.range(b"", b"", v) for v in (9, 27, 36)]
        db.close()
        other = second.VersionedLsm(d)
        assert other.durable_version == 36
        assert [other.range(b"", b"", v) for v in (9, 27, 36)] == want


def test_storage_role_failure_surfaces(tmp_path):
    """A store that cannot write its log refuses the ack (no fsync, no
    durable_version): the DiskQueue's commit failing raises RemoteError."""
    role = mp.StorageRole(str(tmp_path / "sd"))

    class _Broken:
        def push(self, _blob):
            return 0

        def commit(self):
            return None

    role._dq = _Broken()
    with pytest.raises(transport.RemoteError, match="commit failed"):
        run(role.apply(mp.StorageApply(version=5,
                                       mutations=[Mutation(0, b"k", b"v")])))
    assert role.version == 0
