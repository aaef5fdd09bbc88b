"""Encryption at rest through the port's roles (`cluster/multiprocess.py`'s
TLogRole and StorageRole with `crypto/at_rest.StorageEncryption`) held
against the JAX package's on the CPU.

* Every case of tests/test_encrypted_storage.py on the port's roles:
  ciphertext on disk and a kill -9 recovery through the KMS's by-id path
  (memory and `lsm` engines), plaintext records of a store written
  before encryption still readable, a decrypted snapshot, a sealed
  storage child (`spawn_role(..., encrypt=True)`) under the port's
  ProxyPipeline with a "cuda" resolver child (device="cpu", a small
  RESOLVER_KERNEL), the refused mode flip, a plaintext value that starts
  with the header's magic, an expired key not brought back, and the
  sealed tlog.
* Across the packages: sealed tlog and storage data dirs written by the
  JAX roles open in the port's roles with the same values and entries,
  and the reverse.
* The switches: the ENABLE_ENCRYPTION knob and `encrypt` reach a role
  process as `--encrypt`; the monitor's `encrypt = true` starts and
  restarts a sealed tlog; a KMS that does not answer, or a host without
  `cryptography`, fails a sealed role before it writes anything.
* chip_smoke.py phase 20's raw disk scan passes sealed dirs and fails a
  dir without its marker or with plaintext behind one.

Children run at one intra-op thread; sockets live in a short
`tempfile.mkdtemp` directory.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import pytest

pytest.importorskip("cryptography")

from foundationdb_tpu.cluster import encrypt_key_proxy as JEKP
from foundationdb_tpu.cluster import kms as JKMS
from foundationdb_tpu.cluster import multiprocess as JMP
from foundationdb_tpu.crypto import at_rest as JAR
from foundationdb_tpu_torch.cluster import monitor as PMON
from foundationdb_tpu_torch.cluster import multiprocess as mp
from foundationdb_tpu_torch.cluster.encrypt_key_proxy import EncryptKeyProxy
from foundationdb_tpu_torch.cluster.kms import SimKmsConnector
from foundationdb_tpu_torch.crypto.at_rest import (
    StorageEncryption,
    default_encryption,
)
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.wire.codec import Mutation
from time_limit import limit_each_test

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

_limit = limit_each_test(120)

SENTINEL = b"TOP-SECRET-PLAINTEXT-VALUE"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _get(role, key, version, pkg=mp):
    return run(role.get(pkg.StorageGet(key=key, version=version))).value


def _enc():
    return StorageEncryption(
        EncryptKeyProxy(SimKmsConnector(), refresh_interval=600))


def _jax_enc():
    return JAR.StorageEncryption(
        JEKP.EncryptKeyProxy(JKMS.SimKmsConnector(), refresh_interval=600))


def _scan_dir_for(data_dir: str, needle: bytes) -> list[str]:
    hits = []
    for root, _dirs, files in os.walk(data_dir):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                if needle in fh.read():
                    hits.append(p)
    return hits


@pytest.fixture
def sock_dir():
    # a short path: a Unix socket's holds at most 107 bytes
    d = tempfile.mkdtemp(prefix="es")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def one_thread_children(monkeypatch):
    """The spawned children inherit one intra-op thread."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


# ---------------------------------------------------------------------------
# tests/test_encrypted_storage.py on the port's roles


@pytest.mark.parametrize("engine", ["memory", "lsm"])
def test_no_plaintext_on_disk_and_kill9_recovery(tmp_path, engine):
    data_dir = str(tmp_path / "sdata")
    role = mp.StorageRole(data_dir, engine=engine, encryption=_enc())

    async def load(r, lo, hi):
        for i in range(lo, hi):
            await r.apply(mp.StorageApply(
                version=(i + 1) * 10,
                mutations=[Mutation(0, b"k%03d" % i, SENTINEL + b"%d" % i)]))

    # a checkpoint (or flush) and a WAL tail past it
    n = mp.StorageRole.CHECKPOINT_INTERVAL + 5
    run(load(role, 0, n))
    assert _get(role, b"k000", n * 10) == SENTINEL + b"0"
    assert _scan_dir_for(data_dir, SENTINEL) == []
    # kill -9: a fresh role with a fresh key cache recovers through the
    # KMS's by-id path (the derived keys' salts live only in the headers)
    role2 = mp.StorageRole(data_dir, engine=engine, encryption=_enc())
    assert role2.version == n * 10
    assert _get(role2, b"k000", n * 10) == SENTINEL + b"0"
    assert _get(role2, b"k%03d" % (n - 1), n * 10) == \
        SENTINEL + b"%d" % (n - 1)
    st = role2.status()["encryption"]
    assert st["opens"] == 2 and st["kms_fetches"] >= 4


def test_mixed_mode_legacy_plaintext_readable(tmp_path):
    """Records written before encryption was enabled stay readable after
    it is turned on."""
    data_dir = str(tmp_path / "sdata")
    role = mp.StorageRole(data_dir, engine="lsm")

    async def one(r, version, key, val):
        await r.apply(mp.StorageApply(version=version,
                                      mutations=[Mutation(0, key, val)]))

    run(one(role, 10, b"old", b"legacy-plain"))
    role.close_disk()
    role2 = mp.StorageRole(data_dir, engine="lsm", encryption=_enc())
    run(one(role2, 20, b"new", b"sealed-value"))
    assert _get(role2, b"old", 20) == b"legacy-plain"
    assert _get(role2, b"new", 20) == b"sealed-value"


@pytest.mark.parametrize("engine", ["memory", "lsm"])
def test_snapshot_decrypts(tmp_path, engine):
    role = mp.StorageRole(str(tmp_path / "sdata"), engine=engine,
                          encryption=_enc())

    async def go():
        await role.apply(mp.StorageApply(
            version=10,
            mutations=[Mutation(0, b"a", SENTINEL), Mutation(0, b"b", b"v2")]))
        snap = await role.snapshot(mp.StorageSnapshotReq(version=10))
        batch = await role.get_batch(mp.StorageGetBatch(
            versions=[10, 10, 10], keys=[b"a", b"b", b"c"]))
        return snap, batch

    snap, batch = run(go())
    assert dict(snap.kvs) == {b"a": SENTINEL, b"b": b"v2"}
    assert batch.values == [SENTINEL, b"v2", None]


def test_encrypted_cluster_end_to_end(sock_dir, one_thread_children):
    """The port's pipeline over a tlog child, a sealed storage child
    (`encrypt=True`, `lsm`) and a "cuda" resolver child on the CPU:
    commits land, reads come back, and the storage's data dir holds no
    plaintext."""
    from foundationdb_tpu_torch.models.types import CommitTransaction

    data_dir = os.path.join(sock_dir, "sd")
    kernel = ("KernelConfig(max_key_bytes=16, max_txns=64, max_reads=256, "
              "max_writes=256, history_capacity=4096)")
    procs = [
        mp.spawn_role("tlog", sock_dir),
        mp.spawn_role("storage", sock_dir, data_dir=data_dir,
                      storage_engine="lsm", encrypt=True),
        mp.spawn_role("resolver", sock_dir, backend="cuda", device="cpu",
                      env={"RESOLVER_KERNEL": kernel}),
    ]
    try:
        async def go():
            tconn, sconn, rconn = [await mp.connect(p.address, proc=p)
                                   for p in procs]
            pipe = mp.ProxyPipeline([rconn], tconn, sconn)
            pipe.start()
            try:
                v = await pipe.commit(CommitTransaction(
                    read_conflict_ranges=[], write_conflict_ranges=[],
                    mutations=[Mutation(0, b"ek", SENTINEL)],
                    read_snapshot=0))
                rep = await sconn.call(mp.TOKEN_STORAGE_GET,
                                       mp.StorageGet(key=b"ek", version=v))
                assert rep.value == SENTINEL
                assert await pipe.read(b"ek", v) == SENTINEL
            finally:
                await pipe.stop()
            st = json.loads((await sconn.call(
                mp.TOKEN_STATUS, mp.StatusRequest(pad=0))).payload)
            assert st["encryption"]["seals"] == 1
            assert st["encryption"]["opens"] == 2
            for c in (rconn, tconn, sconn):
                await c.close()

        run(go())
        assert os.path.exists(os.path.join(data_dir, "ENCRYPTION_MODE"))
        assert _scan_dir_for(data_dir, SENTINEL) == []
    finally:
        for p in procs:
            p.stop()


def test_mode_flip_refused(tmp_path):
    """A store written sealed refuses an unsealed open."""
    data_dir = str(tmp_path / "sdata")
    role = mp.StorageRole(data_dir, engine="lsm", encryption=_enc())
    run(role.apply(mp.StorageApply(version=10,
                                   mutations=[Mutation(0, b"k", SENTINEL)])))
    role.close_disk()
    with pytest.raises(RuntimeError, match="encryption"):
        mp.StorageRole(data_dir, engine="lsm")
    with pytest.raises(RuntimeError, match="encryption"):
        JMP.StorageRole(data_dir, engine="lsm")


def test_magic_collision_legacy_value_readable(tmp_path):
    """A plaintext value that starts with the header's magic reads back
    in both modes (StorageEncryption.open tells it apart by parsing)."""
    from foundationdb_tpu_torch.crypto.blob_cipher import ENCRYPT_HEADER_MAGIC

    weird = ENCRYPT_HEADER_MAGIC + b"\xff" + b"z" * 120
    data_dir = str(tmp_path / "sdata")
    role = mp.StorageRole(data_dir, engine="lsm")
    run(role.apply(mp.StorageApply(version=10,
                                   mutations=[Mutation(0, b"weird", weird)])))
    assert _get(role, b"weird", 10) == weird
    role.close_disk()
    role2 = mp.StorageRole(data_dir, engine="lsm", encryption=_enc())
    assert _get(role2, b"weird", 10) == weird


def test_expired_key_not_resurrected():
    """A record whose key generation passed its expire deadline refuses
    to open though the KMS could derive it again."""
    from foundationdb_tpu_torch.crypto import encrypt
    from foundationdb_tpu_torch.crypto.blob_cipher import (
        SYSTEM_DOMAIN_ID,
        CipherKeyExpiredError,
    )

    proxy = EncryptKeyProxy(SimKmsConnector(), refresh_interval=600,
                            expire_interval=0.05)
    enc = StorageEncryption(proxy)
    blob = encrypt(SENTINEL, proxy.get_latest_cipher(enc.domain_id),
                   proxy.get_latest_cipher(SYSTEM_DOMAIN_ID))
    assert enc.open(blob) == SENTINEL
    time.sleep(0.06)
    with pytest.raises(CipherKeyExpiredError):
        enc.open(blob)


def test_tlog_disk_sealed_and_recovers(tmp_path):
    """The tlog's DiskQueue is ciphertext, and a fresh role recovers its
    entries through the KMS."""
    data_dir = str(tmp_path / "tdata")
    role = mp.TLogRole(data_dir=data_dir, encryption=_enc())

    async def pushes(r, lo, hi):
        for i in range(lo, hi):
            await r.push(mp.TLogPush(
                version=(i + 1) * 10, prev_version=i * 10,
                mutations=[Mutation(0, b"tk%02d" % i, SENTINEL)]))

    run(pushes(role, 0, 10))
    assert _scan_dir_for(data_dir, SENTINEL) == []
    assert role.status()["encryption"]["seals"] == 10
    role2 = mp.TLogRole(data_dir=data_dir, encryption=_enc())
    assert role2.version == 100
    rep = run(role2.peek(mp.TLogPeek(after_version=95)))
    assert rep.mutations[0].param2 == SENTINEL
    assert role2.status()["encryption"]["opens"] == 10
    with pytest.raises(RuntimeError, match="encryption"):
        mp.TLogRole(data_dir=data_dir)


# ---------------------------------------------------------------------------
# data dirs across packages

PKG = {"jax": (JMP, _jax_enc), "port": (mp, _enc)}


@pytest.mark.parametrize("engine", ["memory", "lsm"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_sealed_storage_dir_across_packages(tmp_path, writer, reader,
                                            engine):
    wmp, wenc = PKG[writer]
    rmp, renc = PKG[reader]
    data_dir = str(tmp_path / "sdata")
    role = wmp.StorageRole(data_dir, engine=engine, encryption=wenc())
    n = wmp.StorageRole.CHECKPOINT_INTERVAL + 3

    async def load():
        for i in range(n):
            await role.apply(wmp.StorageApply(
                version=(i + 1) * 10,
                mutations=[Mutation(0, b"x%03d" % i, SENTINEL + b"%d" % i),
                           Mutation(1, b"x%03d" % (i // 2),
                                    b"x%03d" % (i // 2))]))

    run(load())
    want = run(role.snapshot(wmp.StorageSnapshotReq(version=n * 10))).kvs
    role.close_disk()
    assert _scan_dir_for(data_dir, SENTINEL) == []
    other = rmp.StorageRole(data_dir, engine=engine, encryption=renc())
    assert other.version == n * 10
    got = run(other.snapshot(rmp.StorageSnapshotReq(version=n * 10))).kvs
    assert got == want and len(got) == n
    assert _get(other, b"x%03d" % (n - 1), n * 10, rmp) == \
        SENTINEL + b"%d" % (n - 1)
    other.close_disk()
    with pytest.raises(RuntimeError, match="encryption"):
        rmp.StorageRole(data_dir, engine=engine)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_sealed_tlog_dir_across_packages(tmp_path, writer, reader):
    wmp, wenc = PKG[writer]
    rmp, renc = PKG[reader]
    data_dir = str(tmp_path / "tdata")
    role = wmp.TLogRole(data_dir=data_dir, encryption=wenc())

    async def pushes():
        for i in range(12):
            await role.push(wmp.TLogPush(
                version=(i + 1) * 10, prev_version=i * 10,
                mutations=[Mutation(0, b"t%02d" % i, SENTINEL + b"%d" % i)]))

    run(pushes())
    assert _scan_dir_for(data_dir, SENTINEL) == []
    other = rmp.TLogRole(data_dir=data_dir, encryption=renc())
    assert other.version == 120
    assert [(v, [(m.op, m.param1, m.param2) for m in ms])
            for v, ms in other.entries] == \
        [(v, [(m.op, m.param1, m.param2) for m in ms])
         for v, ms in role.entries]
    with pytest.raises(RuntimeError, match="encryption"):
        rmp.TLogRole(data_dir=data_dir)


# ---------------------------------------------------------------------------
# the switches and the refusals


def test_knob_and_flag_reach_the_child(monkeypatch, tmp_path):
    """spawn_role turns `encrypt` and the launcher's ENABLE_ENCRYPTION
    into the child's --encrypt, as the JAX launcher does."""
    from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS

    cmds = []

    class FakePopen:
        def __init__(self, cmd, env=None):
            cmds.append(cmd)

    monkeypatch.setattr(mp.subprocess, "Popen", FakePopen)
    d = str(tmp_path)
    mp.spawn_role("tlog", d, data_dir=d)
    mp.spawn_role("tlog", d, data_dir=d, encrypt=True)
    monkeypatch.setattr(SERVER_KNOBS, "ENABLE_ENCRYPTION", True)
    mp.spawn_role("storage", d, data_dir=d)
    assert ["--encrypt" in c for c in cmds] == [False, True, True]
    assert SERVER_KNOBS.ENCRYPT_KEY_REFRESH_INTERVAL == 600.0
    assert EncryptKeyProxy(SimKmsConnector()).refresh_interval == 600.0


def test_kms_that_does_not_answer_fails_before_writing(tmp_path):
    """A sealed role whose KMS does not answer raises before it makes its
    data dir: a sealed store never falls back to plaintext."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens there now
    for make in (
            lambda d: mp.StorageRole(d, engine="lsm", encryption=(
                default_encryption(kms_endpoint=f"127.0.0.1:{port}"))),
            lambda d: mp.TLogRole(d, encryption=(
                default_encryption(kms_endpoint=f"127.0.0.1:{port}")))):
        d = str(tmp_path / "never")
        with pytest.raises(OSError):
            make(d)
        assert not os.path.exists(d)


def test_no_cryptography_refuses_encryption(tmp_path):
    """Without the `cryptography` package every port module imports and
    plain roles work, but asking for encryption raises ImportError before
    a file is written (and the CLI's --encrypt exits non-zero)."""
    code = f"""
import importlib.abc, os, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "cryptography":
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
from foundationdb_tpu_torch.cluster import multiprocess as mp
from foundationdb_tpu_torch.crypto import at_rest, token_sign, tls
from foundationdb_tpu_torch.crypto.blob_cipher import is_encrypted
d = {str(tmp_path / "d")!r}
mp.TLogRole(d + "-plain")
try:
    at_rest.default_encryption()
except ImportError:
    print("refused")
assert not os.path.exists(d)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=100,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["refused"]


def test_monitor_starts_and_restarts_a_sealed_tlog(sock_dir,
                                                   one_thread_children):
    """A conf section's `encrypt = true` starts the tlog sealed, and the
    monitor's restart after a SIGKILL opens the sealed records again."""
    conf = os.path.join(sock_dir, "cluster.conf")
    socks = os.path.join(sock_dir, "s")
    os.makedirs(socks)
    tlog_dir = os.path.join(sock_dir, "td")
    with open(conf, "w") as f:
        f.write(f"""
[role.t0]
kind = tlog
socket_dir = {socks}
data_dir = {tlog_dir}
encrypt = true
""")
    assert PMON.parse_conf(conf)["t0"].encrypt
    mon = PMON.Monitor(conf, log=lambda *a: None)
    mon.start_all()
    try:
        addr = mon.children["t0"].spec.address

        async def call(token, msg):
            c = await mp.connect(addr, proc=mon.children["t0"].proc)
            try:
                return await c.call(token, msg)
            finally:
                await c.close()

        rep = run(call(mp.TOKEN_TLOG_PUSH, mp.TLogPush(
            version=10, prev_version=-1,
            mutations=[Mutation(0, b"k", SENTINEL)])))
        assert rep.durable_version == 10
        assert os.path.exists(os.path.join(tlog_dir, "ENCRYPTION_MODE"))
        assert _scan_dir_for(tlog_dir, SENTINEL) == []
        pid = mon.children["t0"].proc.proc.pid
        mon.children["t0"].proc.proc.kill()
        mon.children["t0"].proc.proc.wait()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            mon.poll_once()
            p = mon.children["t0"].proc.proc
            if p.poll() is None and p.pid != pid:
                break
            time.sleep(0.1)
        assert mon.restarts.get("t0") == 1
        rep = run(call(mp.TOKEN_TLOG_PEEK, mp.TLogPeek(after_version=5)))
        assert rep.mutations[0].param2 == SENTINEL
        st = json.loads(run(call(mp.TOKEN_STATUS,
                                 mp.StatusRequest(pad=0))).payload)
        assert st["encryption"]["opens"] == 1
    finally:
        for child in mon.children.values():
            child.proc.stop()


def test_chip_smoke_disk_scan(tmp_path):
    """chip_smoke.py phase 20's raw scan (`sealed_disk_checks`) passes
    sealed tlog and storage dirs and fails a dir holding plaintext behind
    a marker, or one without a marker."""
    import chip_smoke as C

    def write(dirs, enc):
        store = mp.StorageRole(dirs["storage"], encryption=enc())
        log = mp.TLogRole(dirs["tlog"], encryption=enc())
        run(store.apply(mp.StorageApply(
            version=10, mutations=[Mutation(0, b"k", C.SE_SENTINEL)])))
        run(log.push(mp.TLogPush(version=10, prev_version=-1, mutations=[
            Mutation(0, b"k", C.SE_SENTINEL + b"-loaded")])))
        store.close_disk()

    sealed = {n: str(tmp_path / "sealed" / n) for n in ("storage", "tlog")}
    write(sealed, _enc)
    out = C.sealed_disk_checks("t", sealed, [C.SE_SENTINEL + b"-loaded"])
    assert out["mode_flip_refused"] and out["needles"] == 2
    assert out["files"] >= 2 and out["bytes"] > 0
    plain = {n: str(tmp_path / "plain" / n) for n in ("storage", "tlog")}
    write(plain, lambda: None)
    with pytest.raises(SystemExit):  # no marker
        C.sealed_disk_checks("t", plain, [])
    for d in plain.values():
        with open(os.path.join(d, "ENCRYPTION_MODE"), "w") as f:
            f.write("aes-256-ctr\n")
    with pytest.raises(SystemExit):  # the plaintext behind the marker
        C.sealed_disk_checks("t", plain, [])
