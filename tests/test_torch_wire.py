"""The port's wire: codec, transport, the ResolverRole, its processes and
the C++ skip list, held against the JAX package on the CPU.

* Codec: for every message the port registers, its `encode` writes the
  same bytes as the JAX `encode` of the equal message, and each package
  decodes the other's bytes back to them. Every truncation of a columnar
  frame raises CodecError, and so do frames whose header counts, key
  lengths or length disagree (tests/test_wire_pipeline.py's cases).
* Transport, across packages in one event loop, both ways (a JAX
  RpcConnection to a port RpcServer and the other way round): echo and
  concurrent calls, an unknown token and a handler error, a protocol
  version mismatch, a corrupt frame, and mutual TLS with certificates
  from the port's `crypto.tls.make_test_tls` (skipped without
  `cryptography`).
* ResolverRole in-process: the port's "cuda" (device="cpu"), "cpu",
  "native" and None (the knob) against the JAX role's "tpu-force",
  "cpu", "native" and "tpu", on one seeded stream of object and
  columnar frames: the replies, a duplicate's replay, the "already
  resolved and expired" error, the stale-epoch rejection, `path_stats`
  and the deterministic keys of `status()` (which must `json.dumps`);
  and a role built from RESOLVER_KERNEL at n_shards = 2 against the
  MultiResolverOracle.
* Processes: two port resolver children (backend "cuda", device "cpu")
  under the JAX ProxyPipeline with the JAX tlog and storage roles served
  on sockets from this process (min-combine, a conflict that is not
  committed, the read back); a
  "cuda" child without a card exits non-zero before it binds, and
  `connect(proc=...)` fails at once; the ratekeeper, worker and
  controller roles are served.
* The port's NativeSkipListConflictSet and NativeConflictSet give the
  JAX ones' verdicts on seeded streams; a failed build raises.

The tolerance is equality throughout.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import struct
import time
import types
import zlib

import numpy as np
import pytest

from foundationdb_tpu.cluster import multiprocess as JMP
from foundationdb_tpu.models import types as JT
from foundationdb_tpu.utils import packing as JPK
from foundationdb_tpu.wire import codec as JC
from foundationdb_tpu.wire import transport as JTR
from foundationdb_tpu_torch.cluster import generation as PG
from foundationdb_tpu_torch.cluster import multiprocess as PMP
from foundationdb_tpu_torch.models import types as PT
from foundationdb_tpu_torch.testing.oracle import (
    MultiResolverOracle,
    OracleTxn,
)
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import packing as PPK
from foundationdb_tpu_torch.wire import codec as PC
from foundationdb_tpu_torch.wire import transport as PTR

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

PKG = {
    "port": types.SimpleNamespace(types=PT, codec=PC, transport=PTR,
                                  mp=PMP, packing=PPK),
    "jax": types.SimpleNamespace(types=JT, codec=JC, transport=JTR,
                                 mp=JMP, packing=JPK),
}


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# ---------------------------------------------------------------------------
# codec


def _txn(p, i: int, full: bool):
    M = p.codec.Mutation
    if not full:
        return p.types.CommitTransaction()
    return p.types.CommitTransaction(
        read_conflict_ranges=[(b"a%d" % i, b"b"), (b"", b"\xff" * 30)],
        write_conflict_ranges=[(b"k%d" % i, b"k%d\x00" % i)],
        read_snapshot=-5 + 1_000_003 * i,
        report_conflicting_keys=bool(i % 2),
        lock_aware=True,
        debug_id=f"dbg{i}",
        span=(2**63 + i, 7),
        mutations=[M(0, b"k", b"v" * i), M(2, b"\x00", b"")],
    )


def _txns(p):
    return [_txn(p, i, full=i != 1) for i in range(4)]


def _muts(p):
    M = p.codec.Mutation
    return [M(0, b"k", b"v" * 40), M(1, b"a", b"b\x00"), M(0, b"", b"")]


def _columnar(p, epoch):
    return p.codec.ResolveBatchColumnar(
        prev_version=7, version=11, last_received_version=3,
        cols=p.packing.pack_columnar(_txns(p)), proxy_id="proxy1",
        debug_id=None if epoch else "batch9", span=None if epoch else (1, 2),
        epoch=epoch)


CASES = {
    "txn full": (0x0101, lambda p: _txn(p, 3, True)),
    "txn empty": (0x0101, lambda p: _txn(p, 0, False)),
    "request": (0x0102, lambda p: p.types.ResolveTransactionBatchRequest(
        prev_version=-1, version=1000, last_received_version=-1,
        transactions=_txns(p), txn_state_transactions=[0, 3],
        proxy_id="p0", debug_id="d", epoch=4, span=(9, 10))),
    "request bare": (0x0102, lambda p: p.types.ResolveTransactionBatchRequest(
        prev_version=5, version=6, last_received_version=5)),
    "reply": (0x0103, lambda p: p.types.ResolveTransactionBatchReply(
        committed=[p.types.TransactionResult(v) for v in (0, 1, 2, 3, 3)],
        conflicting_key_range_map={0: [1, 0], 4: [2]},
        state_mutations=[(17, [p.codec.Mutation(1, b"\xff/x", b"1")])],
        private_mutations={2: [p.codec.Mutation(0, b"\xffk", b"v")]},
        debug_id="r")),
    "reply bare": (0x0103, lambda p: p.types.ResolveTransactionBatchReply()),
    "columnar": (0x0104, lambda p: _columnar(p, 0)),
    "columnar fenced": (0x0104, lambda p: _columnar(p, 12)),
    "columnar empty": (0x0104, lambda p: p.codec.ResolveBatchColumnar(
        -1, 1, -1, p.packing.pack_columnar([]))),
    "ping": (0x0201, lambda p: p.mp.Ping(payload=b"\x00\xffping")),
    "pong": (0x0202, lambda p: p.mp.Pong(payload=b"")),
    "role version req": (0x0230, lambda p: p.mp.RoleVersionReq(pad=0)),
    "role version reply": (0x0231,
                           lambda p: p.mp.RoleVersionReply(version=-1)),
    "status request": (0x0240, lambda p: p.mp.StatusRequest(pad=0)),
    "status reply": (0x0241, lambda p: p.mp.StatusReply(
        payload=json.dumps({"role": "resolver", "ü": [1, 2.5]}))),
    # the commit path's messages (the tlog, storage and sequencer roles)
    "tlog push": (0x0210, lambda p: p.mp.TLogPush(
        version=7, prev_version=3, mutations=_muts(p), epoch=2)),
    "tlog push unfenced": (0x0210, lambda p: p.mp.TLogPush(
        version=7, prev_version=-1, mutations=[])),
    "tlog push reply": (0x0211,
                        lambda p: p.mp.TLogPushReply(durable_version=-1)),
    "tlog peek": (0x0212, lambda p: p.mp.TLogPeek(after_version=2**40)),
    "tlog peek reply": (0x0213, lambda p: p.mp.TLogPeekReply(
        version=5, mutations=_muts(p))),
    "tlog peek batch": (0x0214, lambda p: p.mp.TLogPeekBatchReq(
        after_version=-1, max_entries=2**32 - 1)),
    "tlog peek batch reply": (0x0215, lambda p: p.mp.TLogPeekBatchReply(
        versions=[1, -2, 2**62], groups=[_muts(p), [], _muts(p)[:1]])),
    "storage apply": (0x0220, lambda p: p.mp.StorageApply(
        version=11, mutations=_muts(p))),
    "storage apply reply": (0x0221, lambda p: p.mp.StorageApplyReply(
        durable_version=11, durable=1)),
    "storage apply reply volatile": (0x0221, lambda p: p.mp.StorageApplyReply(
        durable_version=0)),
    "storage get": (0x0222, lambda p: p.mp.StorageGet(key=b"\x00k\xff",
                                                      version=9)),
    "storage get reply": (0x0223, lambda p: p.mp.StorageGetReply(
        value=b"v" * 300)),
    "storage get reply absent": (0x0223,
                                 lambda p: p.mp.StorageGetReply(value=None)),
    "storage snapshot": (0x0224,
                         lambda p: p.mp.StorageSnapshotReq(version=12)),
    "storage snapshot reply": (0x0225, lambda p: p.mp.StorageSnapshotReply(
        version=12, kvs=[(b"", b""), (b"a", b"1" * 70), (b"\xff", b"z")])),
    "storage get batch": (0x0226, lambda p: p.mp.StorageGetBatch(
        versions=[3, 4, 3], keys=[b"a", b"", b"a"])),
    "storage get batch reply": (0x0227, lambda p: p.mp.StorageGetBatchReply(
        values=[None, b"", b"x"])),
    "storage apply batch": (0x0228, lambda p: p.mp.StorageApplyBatch(
        versions=[20, 30], groups=[_muts(p), []], prev_versions=[10, 20])),
    "storage apply batch unchained": (0x0228,
                                      lambda p: p.mp.StorageApplyBatch(
                                          versions=[5], groups=[[]])),
    "rate info request": (0x0242, lambda p: p.mp.GetRateInfoRequest(pad=0)),
    "rate info reply": (0x0243, lambda p: p.mp.GetRateInfoReply(
        payload=json.dumps({"transactions_per_second_limit": 1e6}))),
    "tlog lock": (0x0256, lambda p: p.mp.TLogLock(
        epoch=4, recovery_version=2_000_000, partitioned=1)),
    "tlog lock phase one": (0x0256, lambda p: p.mp.TLogLock(epoch=4)),
    "tlog lock reply": (0x0257, lambda p: p.mp.TLogLockReply(
        epoch=4, durable_version=77)),
    "storage catch up": (0x025E, lambda p: p.mp.StorageCatchUp(
        tlog_address="/s/tlog0.sock", tlog_addresses=["/s/tlog1.sock", "t2"],
        recovery_version=5)),
    "storage catch up one": (0x025E, lambda p: p.mp.StorageCatchUp(
        tlog_address="/s/tlog0.sock")),
    "storage catch up reply": (0x025F,
                               lambda p: p.mp.StorageCatchUpReply(version=6)),
    "tlog pop": (0x0260, lambda p: p.mp.TLogPop(version=50, epoch=3)),
    "tlog pop unfenced": (0x0260, lambda p: p.mp.TLogPop(version=50)),
    "tlog pop reply": (0x0261,
                       lambda p: p.mp.TLogPopReply(durable_version=60)),
    "get commit version": (0x0266, lambda p: p.mp.GetCommitVersionRequest(
        proxy_id="proxy1", request_num=9, most_recent_processed=8, epoch=2,
        tags=[0, 3])),
    "get commit version untagged": (0x0266,
                                    lambda p: p.mp.GetCommitVersionRequest(
                                        proxy_id="p", request_num=1,
                                        most_recent_processed=0, epoch=0)),
    "get commit version reply": (0x0267, lambda p: p.mp.GetCommitVersionReply(
        version=2000, prev_version=1000, request_num=9,
        tag_prevs=[1000, 0])),
    "report committed": (0x0268,
                         lambda p: p.mp.ReportRawCommittedVersionRequest(
                             version=-1, epoch=1)),
    "report committed reply": (0x0269,
                               lambda p: p.mp.ReportRawCommittedVersionReply(
                                   live_version=2000)),
}


def test_tokens_match_jax():
    # the commit path's 21 and the lifecycle control plane's 8
    tokens = {n: v for n, v in vars(PMP).items() if n.startswith("TOKEN_")}
    assert len(tokens) == 29
    for name, value in tokens.items():
        assert getattr(JMP, name) == value, name


def test_every_registered_message_is_compared():
    # the lifecycle messages are compared in test_torch_wire_cluster.py
    from test_torch_wire_cluster import LIFECYCLE_CASES

    assert set(PC._REGISTRY) == {tid for tid, _ in CASES.values()} | {
        tid for tid, _tok, _m in LIFECYCLE_CASES.values()}
    assert PC.PROTOCOL_VERSION == JC.PROTOCOL_VERSION


@pytest.mark.parametrize("name", list(CASES))
def test_codec_frames_are_byte_identical(name):
    tid, make = CASES[name]
    port_msg, jax_msg = make(PKG["port"]), make(PKG["jax"])
    pb, jb = PC.encode(port_msg), JC.encode(jax_msg)
    assert pb == jb
    assert struct.unpack_from("<H", pb)[0] == tid
    from_jax, from_port = PC.decode(jb), JC.decode(pb)
    assert type(from_jax) is type(port_msg)
    assert type(from_port) is type(jax_msg)
    assert from_jax == port_msg
    assert from_port == jax_msg
    assert PC.encode(from_jax) == jb and JC.encode(from_port) == pb


def test_columnar_truncation_always_codec_error():
    raw = PC.encode(_columnar(PKG["port"], 0))
    assert PC.decode(raw) == _columnar(PKG["port"], 0)
    for cut in range(0, len(raw) - 1):
        with pytest.raises(PC.CodecError):
            PC.decode(raw[:cut])


def test_columnar_inconsistent_frames_rejected():
    txns = _txns(PKG["port"])
    msg = PC.ResolveBatchColumnar(prev_version=-1, version=100,
                                  last_received_version=-1,
                                  cols=PPK.pack_columnar(txns))
    raw = bytearray(PC.encode(msg))
    assert bytes(raw) == JC.encode(JC.decode(bytes(raw)))
    # u16 type id, 4 x i64 (prev, version, last, epoch), then n_txns,
    # n_reads and n_writes as u32
    off_ntxns, off_nreads, off_nwrites = 34, 38, 42
    for off, delta in [(off_ntxns, 1), (off_ntxns, -1), (off_nreads, 1),
                       (off_nreads, -1), (off_nwrites, 1), (off_nwrites, 7)]:
        bad = bytearray(raw)
        struct.pack_into("<I", bad, off,
                         struct.unpack_from("<I", bad, off)[0] + delta)
        with pytest.raises(PC.CodecError):
            PC.decode(bytes(bad))
        with pytest.raises(JC.CodecError):
            JC.decode(bytes(bad))
    n = msg.cols.n_txns
    off_lens = 46 + 8 * n + 4 * n + 4 * n + n  # the first key length
    bad = bytearray(raw)
    struct.pack_into("<I", bad, off_lens,
                     struct.unpack_from("<I", bad, off_lens)[0] + 1)
    with pytest.raises(PC.CodecError):
        PC.decode(bytes(bad))
    with pytest.raises(PC.CodecError):
        PC.decode(bytes(raw) + b"\x00")
    with pytest.raises(PC.CodecError, match="unknown wire type"):
        PC.decode(b"\xff\xff")


# ---------------------------------------------------------------------------
# transport, across packages

#: (client package, server package)
DIRECTIONS = [("jax", "port"), ("port", "jax")]
TOKEN = 0x7777


async def _serve(srv, address, handler=None, **kw):
    server = srv.transport.RpcServer(address, **kw)

    async def ping(msg):
        await asyncio.sleep(0.01 if msg.payload == b"slow" else 0)
        return srv.mp.Pong(payload=msg.payload)

    server.register(TOKEN, handler or ping)
    await server.start()
    return server


@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_transport_echo_and_concurrency(tmp_path, client, server):
    cli, srv = PKG[client], PKG[server]
    sock = str(tmp_path / "role.sock")

    async def go():
        s = await _serve(srv, sock)
        conn = cli.transport.RpcConnection(sock)
        await conn.connect()
        payloads = [b"slow", b"fast"] + [b"%d" % i for i in range(30)]
        replies = await asyncio.gather(
            *(conn.call(TOKEN, cli.mp.Ping(payload=p)) for p in payloads))
        assert [r.payload for r in replies] == payloads
        assert all(type(r) is cli.mp.Pong for r in replies)
        await conn.close()
        await s.close()

    run(go())


@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_transport_unknown_token_and_handler_error(tmp_path, client, server):
    cli, srv = PKG[client], PKG[server]
    sock = str(tmp_path / "role.sock")

    async def boom(msg):
        raise ValueError("kaboom")

    async def go():
        s = await _serve(srv, sock, boom)
        conn = cli.transport.RpcConnection(sock)
        await conn.connect()
        with pytest.raises(cli.transport.RemoteError, match="kaboom"):
            await conn.call(TOKEN, cli.mp.Ping(payload=b"x"))
        with pytest.raises(cli.transport.RemoteError,
                           match="UnknownEndpointError"):
            await conn.call(0xDEAD, cli.mp.Ping(payload=b"x"))
        await conn.close()
        await s.close()

    run(go())


@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_transport_protocol_version_mismatch(tmp_path, client, server):
    cli, srv = PKG[client], PKG[server]
    sock = str(tmp_path / "role.sock")

    async def go():
        s = await _serve(srv, sock)
        conn = cli.transport.RpcConnection(
            sock, protocol_version=PC.PROTOCOL_VERSION + 1)
        with pytest.raises(cli.transport.TransportError):
            await conn.connect(retries=1)
        await conn.close()
        # a server on another version refuses a current client the same
        s2 = await _serve(srv, sock + "2",
                          protocol_version=PC.PROTOCOL_VERSION - 1)
        conn = cli.transport.RpcConnection(sock + "2")
        with pytest.raises(cli.transport.TransportError):
            await conn.connect(retries=1)
        await conn.close()
        await s.close()
        await s2.close()

    run(go())


@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_transport_corrupt_frame_dropped(tmp_path, client, server):
    """A frame whose CRC does not match (built with the client package's
    codec) makes the other package's server drop the connection without
    an answer; a good frame on a new connection is served."""
    cli, srv = PKG[client], PKG[server]
    sock = str(tmp_path / "role.sock")

    async def go():
        s = await _serve(srv, sock)
        reader, writer = await asyncio.open_unix_connection(path=sock)
        writer.write(cli.transport.MAGIC
                     + struct.pack("<Q", cli.codec.PROTOCOL_VERSION))
        await writer.drain()
        assert (await reader.readexactly(len(srv.transport.MAGIC) + 8)
                )[:8] == srv.transport.MAGIC
        body = (cli.transport._REQ.pack(cli.transport.KIND_REQUEST, 1, TOKEN)
                + cli.codec.encode(cli.mp.Ping(payload=b"x")))
        bad = bytearray(body)
        bad[-1] ^= 0x40
        writer.write(cli.transport._HDR.pack(len(bad),
                                             zlib.crc32(body) & 0xFFFFFFFF))
        writer.write(bytes(bad))
        await writer.drain()
        assert await reader.read(1024) == b""
        writer.close()
        conn = cli.transport.RpcConnection(sock)
        await conn.connect()
        assert (await conn.call(TOKEN, cli.mp.Ping(payload=b"ok"))
                ).payload == b"ok"
        await conn.close()
        await s.close()

    run(go())


@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_transport_mutual_tls(tmp_path, client, server):
    pytest.importorskip("cryptography")
    from foundationdb_tpu.crypto.tls import TLSConfig as JaxTLS

    from foundationdb_tpu_torch.crypto.tls import TLSConfig as PortTLS
    from foundationdb_tpu_torch.crypto.tls import make_test_tls

    made = make_test_tls(str(tmp_path / "pki"), organization="good-org")

    def cfg(pkg, name, org=None):
        cls = PortTLS if pkg == "port" else JaxTLS
        m = made[name]
        return cls(ca_file=m.ca_file, cert_file=m.cert_file,
                   key_file=m.key_file, verify_peer_organization=org)

    cli, srv = PKG[client], PKG[server]
    sock = str(tmp_path / "tls.sock")

    async def go():
        s = await _serve(srv, sock, tls=cfg(server, "server", "good-org"))
        conn = cli.transport.RpcConnection(
            sock, tls=cfg(client, "client", "good-org"))
        await conn.connect()
        assert (await conn.call(TOKEN, cli.mp.Ping(payload=b"tls"))
                ).payload == b"tls"
        await conn.close()
        # a client that asks for another organization refuses the server
        conn = cli.transport.RpcConnection(
            sock, tls=cfg(client, "client", "other-org"))
        with pytest.raises(cli.transport.TransportError):
            await conn.connect(retries=1, delay=0.01)
        await conn.close()
        # a plaintext client never gets a frame served
        conn = cli.transport.RpcConnection(sock)
        with pytest.raises(cli.transport.TransportError):
            await conn.connect(retries=1, delay=0.01)
        await conn.close()
        await s.close()

    run(go())


# ---------------------------------------------------------------------------
# ResolverRole in-process, against the JAX role

#: port backend -> JAX backend
BACKENDS = {"cuda": "tpu-force", "cpu": "cpu", "native": "native",
            None: "tpu"}
WINDOW = 2000
STEP = 500
SMALL_KERNEL = ("KernelConfig(max_key_bytes=16, max_txns=64, max_reads=256,"
                f" max_writes=256, history_capacity=4096,"
                f" window_versions={WINDOW})")


def role_stream(seed: int, n: int = 8):
    """Port requests, alternately object and columnar frames, chained;
    15-byte keys with a shared prefix, report flags, blind writes."""
    rng = np.random.default_rng(seed)

    def key(i):
        return b"\x02tbl/" + int(i).to_bytes(10, "big")

    reqs, prev = [], -1
    for b in range(n):
        version = 10_000 + (b + 1) * STEP
        txns = []
        for t in range(40):
            reads = [] if t % 9 == 4 else [
                (key(k), key(k + int(rng.integers(1, 6))))
                for k in rng.integers(0, 300, int(rng.integers(1, 3)))]
            writes = [(key(k), key(k) + b"\x00")
                      for k in rng.integers(0, 300, int(rng.integers(0, 3)))]
            txns.append(PT.CommitTransaction(
                read_conflict_ranges=reads, write_conflict_ranges=writes,
                read_snapshot=version - int(rng.integers(1, 4)) * STEP,
                report_conflicting_keys=bool(t % 3 == 0)))
        if b % 2:
            req = PC.ResolveBatchColumnar(prev, version, prev,
                                          PPK.pack_columnar(txns),
                                          proxy_id="p0")
        else:
            req = PT.ResolveTransactionBatchRequest(prev, version, prev,
                                                    txns, proxy_id="p0")
        reqs.append(req)
        prev = version
    return reqs


def over_wire(req):
    """The request as each package's role receives it: the port frame
    decoded by the port and by the JAX codec."""
    raw = PC.encode(req)
    return PC.decode(raw), JC.decode(raw)


def deterministic(st: dict) -> dict:
    q, k = st["qos"], st["qos"]["kernel"]
    return dict(
        role=st["role"], version=st["version"], epoch=st["epoch"],
        keys=sorted(st), qos_keys=sorted(set(q) - {"kernel_stages"}),
        kernel_keys=sorted(k),
        queue_depth=q["queue_depth"], resolve_path=q["resolve_path"],
        stale=q["stale_epoch_rejects"], key_sample=q["key_sample"],
        computes=q["compute_time_dist"]["count"],
        latencies=q["resolver_latency_dist"]["count"],
        kernel={n: k[n] for n in ("batches", "compactions", "spills",
                                  "sweep_groups", "fallbacks", "shards")})


@pytest.mark.parametrize("backend", list(BACKENDS), ids=str)
def test_resolver_role_matches_jax(monkeypatch, backend):
    monkeypatch.setenv("RESOLVER_KERNEL", SMALL_KERNEL)
    port = PMP.ResolverRole(backend=backend, window=WINDOW, device="cpu")
    jax = JMP.ResolverRole(backend=BACKENDS[backend], window=WINDOW)
    reqs = role_stream(seed=5)

    async def go():
        conflicts = 0
        for i, req in enumerate(reqs):
            p_req, j_req = over_wire(req)
            got, want = await port.resolve(p_req), await jax.resolve(j_req)
            assert PC.encode(got) == JC.encode(want), i
            conflicts += sum(int(v) == 0 for v in got.committed)
            if i == 4:
                # a proxy's retry is answered from the reply cache
                p_again, j_again = over_wire(req)
                assert await port.resolve(p_again) is got
                assert JC.encode(await jax.resolve(j_again)) == PC.encode(got)
        assert conflicts
        # past the replay window: the same error from both
        for role, r in ((port, over_wire(reqs[0])[0]),
                        (jax, over_wire(reqs[0])[1])):
            with pytest.raises(Exception,
                               match="already resolved and expired"):
                await role.resolve(r)
        # a request of another generation bounces before the chain wait
        fenced = PT.ResolveTransactionBatchRequest(
            reqs[-1].version, reqs[-1].version + STEP, -1, [], epoch=3)
        p_f, j_f = over_wire(fenced)
        with pytest.raises(PTR.RemoteError) as pe:
            await port.resolve(p_f)
        with pytest.raises(JTR.RemoteError) as je:
            await jax.resolve(j_f)
        assert str(pe.value) == str(je.value)
        assert PG.is_stale_epoch(pe.value)

    run(go())
    assert port.path_stats == jax.path_stats
    assert port.path_stats["columnar_batches"] == 4
    p_st, j_st = port.status(), jax.status()
    json.dumps(p_st)
    assert p_st["backend"] == backend
    assert deterministic(p_st) == deterministic(j_st)
    kernel_set = hasattr(port._cs, "pack_columnar_batch")
    assert kernel_set == (backend == "cuda")
    if kernel_set:
        stages = p_st["qos"]["kernel_stages"]
        assert stages["columnarBatches"] == 4 and stages["warmCompiles"] == 1
        assert stages["resolveBatches"] == len(reqs)
        assert stages["compileSeconds"]["count"] == 1
    if backend != "native":
        from foundationdb_tpu_torch.utils import compile_cache

        label = "knob" if backend is None else backend
        warm = compile_cache.stats()["per_signature_compile_seconds"]
        assert warm[f"resolver_warm/{label}/txns=64"] > 0.0


def test_resolver_role_sharded_from_env(monkeypatch):
    """A role built from RESOLVER_KERNEL at n_shards = 2 (two shards on
    one device, split at default_resolver_boundaries(2)) against the
    MultiResolverOracle over the same split."""
    monkeypatch.setenv("RESOLVER_KERNEL", (
        "KernelConfig(max_key_bytes=16, max_txns=64, max_reads=256, "
        "max_writes=256, history_capacity=4096, delta_capacity=1024, "
        f"n_shards=2, window_versions={WINDOW})"))
    role = PMP.ResolverRole(backend="cuda", window=WINDOW, device="cpu")
    assert role._cs.sharded
    bounds = PMP.default_resolver_boundaries(2)
    assert role._cs.shard_boundaries == bounds
    oracle = MultiResolverOracle(bounds, window=WINDOW)
    rng = np.random.default_rng(9)

    def key(i):
        return int(i).to_bytes(8, "big")

    async def go():
        prev, straddles, conflicts = -1, 0, 0
        for b in range(6):
            version = 10_000 + (b + 1) * STEP
            txns = []
            for t in range(48):
                k = int(rng.integers(0, 2**62)) * 3
                reads = [(key(k), key(k + int(rng.integers(1, 2**59))))]
                straddles += reads[0][0] < bounds[0] <= reads[0][1]
                w = key(int(rng.integers(0, 2**62)) * 4)
                txns.append(PT.CommitTransaction(
                    read_conflict_ranges=reads,
                    write_conflict_ranges=[(w, w + b"\x00")],
                    read_snapshot=version - int(rng.integers(1, 4)) * STEP,
                    report_conflicting_keys=bool(t % 2)))
            req = PC.ResolveBatchColumnar(prev, version, prev,
                                          PPK.pack_columnar(txns))
            got = await role.resolve(PC.decode(PC.encode(req)))
            want = oracle.resolve([OracleTxn(t.read_conflict_ranges,
                                             t.write_conflict_ranges,
                                             t.read_snapshot,
                                             t.report_conflicting_keys)
                                   for t in txns], version)
            assert [int(v) for v in got.committed] == list(want.verdicts), b
            assert got.conflicting_key_range_map == want.conflicting_ranges
            conflicts += sum(int(v) == 0 for v in got.committed)
            prev = version
        assert straddles and conflicts

    run(go())
    json.dumps(role.status())
    assert role.status()["qos"]["kernel"]["shards"] == 2


def test_clip_and_ranges_match_jax():
    for n in (1, 2, 3, 4, 7):
        b = PMP.default_resolver_boundaries(n)
        assert b == JMP.default_resolver_boundaries(n)
        assert PMP.resolver_key_ranges(b) == JMP.resolver_key_ranges(b)
    txns = _txns(PKG["port"])
    jtxns = _txns(PKG["jax"])
    for lo, hi in PMP.resolver_key_ranges(PMP.default_resolver_boundaries(3)):
        got = PMP.clip_transactions(txns, lo, hi)
        want = JMP.clip_transactions(jtxns, lo, hi)
        assert [PC.encode(t) for t in got] == [JC.encode(t) for t in want]
    assert (PMP._decode_alloc_count(txns)
            == JMP._decode_alloc_count(jtxns) > 0)


def test_unported_roles_raise(tmp_path):
    """The ratekeeper, worker and controller roles, once refused, are
    served: each answers StatusRequest as its role; an unknown role and
    an unknown resolver backend still raise."""
    assert not hasattr(PMP, "UNPORTED_ROLES")

    async def serve(role, **kw):
        address = str(tmp_path / f"{role}.sock")
        task = asyncio.ensure_future(
            PMP._serve_role(role, address, "cuda", **kw))
        try:
            conn = await PMP.connect(address)
            st = json.loads((await conn.call(
                PMP.TOKEN_STATUS, PMP.StatusRequest(pad=0))).payload)
            await conn.close()
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        return st

    assert run(serve("ratekeeper"))["role"] == "ratekeeper"
    st = run(serve("worker", worker_id="w7", device="cpu"))
    assert (st["role"], st["worker_id"], st["idle"]) == ("worker", "w7", True)
    assert run(serve("controller"))["role"] == "cluster_controller"
    with pytest.raises(ValueError, match="unknown role"):
        run(PMP._serve_role("oracle", str(tmp_path / "x.sock"), "native"))
    with pytest.raises(ValueError, match="unknown resolver backend"):
        PMP.ResolverRole(backend="tpu")


# ---------------------------------------------------------------------------
# processes


PIPELINE_KERNEL = ("KernelConfig(max_key_bytes=16, max_txns=512, "
                   "max_reads=1024, max_writes=1024, "
                   "history_capacity=4096)")


def test_port_resolvers_under_the_jax_pipeline(tmp_path):
    """The scenario of tests/test_multiprocess.py's min-combine test, with
    both resolvers port processes: the JAX proxy's frames, the port's
    replies, on the real wire. The JAX tlog and storage roles serve their
    sockets from this process's event loop, so the module spawns three
    children in all."""
    from foundationdb_tpu.wire.codec import Mutation

    # a small tier: the CPU plain path pays for the padded shape in every
    # batch, and the pipeline sends batches on a 2 ms cadence
    env = {"RESOLVER_KERNEL": PIPELINE_KERNEL}
    procs = [
        PMP.spawn_role("resolver", str(tmp_path), backend="cuda",
                       device="cpu", index=0, env=env),
        PMP.spawn_role("resolver", str(tmp_path), backend="cuda",
                       device="cpu", index=1, env=env),
    ]
    served = [str(tmp_path / f"{name}.sock") for name in ("tlog", "storage")]
    try:
        async def scenario():
            roles = [asyncio.ensure_future(JMP._serve_role(name, address,
                                                           "native"))
                     for name, address in zip(("tlog", "storage"), served)]
            # the port's launcher: up, or failed at once if a child died
            for p in procs[:2]:
                c = await PMP.connect(p.address, proc=p)
                pong = await c.call(PMP.TOKEN_PING, PMP.Ping(payload=b"up"))
                assert pong.payload == b"up"
                await c.close()
            r0 = await JMP.connect(procs[0].address)
            r1 = await JMP.connect(procs[1].address)
            tlog = await JMP.connect(served[0])
            storage = await JMP.connect(served[1])
            pipe = JMP.ProxyPipeline([r0, r1], tlog, storage)
            pipe.start()
            v1 = await pipe.commit(JT.CommitTransaction(
                write_conflict_ranges=[(b"k", b"k\x00")],
                mutations=[Mutation(0, b"k", b"v")]))
            with pytest.raises(JMP.NotCommittedError):
                await pipe.commit(JT.CommitTransaction(
                    read_conflict_ranges=[(b"k", b"k\x00")],
                    read_snapshot=0))
            assert await pipe.read(b"k", v1) == b"v"
            await pipe.stop()
            # the children's own view: every batch resolved, reachable by
            # either package's client
            for r in (r0, r1):
                st = json.loads((await r.call(
                    JMP.TOKEN_STATUS, JMP.StatusRequest(pad=0))).payload)
                assert st["backend"] == "cuda" and st["version"] >= v1
                path = st["qos"]["resolve_path"]
                assert path["columnar_batches"] + path["object_batches"] >= 2
                assert set(st["kernel_launches"].values()) == {0}
                assert st["qos"]["kernel"]["batches"] >= 2
            for c in (r0, r1, tlog, storage):
                await c.close()
            for task in roles:
                task.cancel()
            await asyncio.gather(*roles, return_exceptions=True)

        run(scenario())
    finally:
        for p in procs:
            p.stop()


def test_cuda_child_without_a_card_exits_before_it_binds(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    t0 = time.monotonic()
    p = PMP.spawn_role("resolver", str(tmp_path), backend="cuda", index=5)
    try:
        with pytest.raises(PMP.RoleExitedError, match="exited with code"):
            run(PMP.connect(p.address, proc=p))
        assert time.monotonic() - t0 < 60
        assert p.proc.wait(timeout=60) != 0
        assert not os.path.exists(p.address)
    finally:
        p.stop()


# ---------------------------------------------------------------------------
# the C++ conflict sets


def _native_pair(cls_name):
    from foundationdb_tpu import native as jn

    from foundationdb_tpu_torch import native as pn

    try:
        return getattr(pn, cls_name)(window=WINDOW), getattr(jn, cls_name)(
            window=WINDOW)
    except (pn.NativeBuildError, jn.NativeBuildError) as e:
        pytest.skip(f"native build unavailable: {e}")


@pytest.mark.parametrize("cls_name", ["NativeSkipListConflictSet",
                                      "NativeConflictSet"])
@pytest.mark.parametrize("seed", [0, 1])
def test_native_sets_match_jax(cls_name, seed):
    port, jax = _native_pair(cls_name)
    rng = np.random.default_rng(seed)
    conflicts = 0
    for b in range(12):
        version = 10_000 + (b + 1) * STEP
        txns = []
        for t in range(80):
            reads = []
            for _ in range(int(rng.integers(0, 3))):
                a = bytes(rng.integers(0, 3, int(rng.integers(0, 5)),
                                       dtype=np.uint8))
                reads.append((a, a + bytes(rng.integers(
                    0, 3, int(rng.integers(1, 4)), dtype=np.uint8))))
            w = bytes(rng.integers(0, 3, int(rng.integers(0, 5)),
                                   dtype=np.uint8))
            txns.append(PT.CommitTransaction(
                read_conflict_ranges=reads,
                write_conflict_ranges=[(w, w + b"\x00")] if t % 4 else [],
                read_snapshot=version - int(rng.integers(1, 6)) * STEP))
        got = port.resolve(txns, version)
        want = jax.resolve(txns, version)
        assert got.dtype == want.dtype and np.array_equal(got, want), b
        conflicts += int((got == 0).sum())
    assert conflicts and port.history_size == jax.history_size


def test_native_build_failure_raises(tmp_path, monkeypatch):
    from foundationdb_tpu_torch import native as pn

    if shutil.which("g++") is None:
        pytest.skip("no g++")
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(pn.NativeBuildError, match="g\\+\\+ failed"):
        pn.build_shared(str(bad), "libbroken")
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ to be found
    with pytest.raises(pn.NativeBuildError, match="could not run"):
        pn.build_shared(str(bad), "libbroken")


def test_knob_overrides_from_the_environment(monkeypatch):
    """The role process's main applies FDBTPU_KNOB_OVERRIDES; the port's
    parsing is the JAX package's (booleans spelled out, anything else a
    config error)."""
    from foundationdb_tpu_torch.utils.knobs import make_server_knobs

    knobs = make_server_knobs()
    monkeypatch.setenv("FDBTPU_KNOB_OVERRIDES",
                       " RESOLVER_CUDA_MIN_BATCH=128 ; "
                       "ENABLE_VERSION_VECTOR_TLOG_UNICAST=on;;")
    assert knobs.apply_env_overrides() == {
        "RESOLVER_CUDA_MIN_BATCH": 128,
        "ENABLE_VERSION_VECTOR_TLOG_UNICAST": True}
    assert knobs.RESOLVER_CUDA_MIN_BATCH == 128
    monkeypatch.setenv("FDBTPU_KNOB_OVERRIDES",
                       "PROXY_USE_RESOLVER_PRIVATE_MUTATIONS=False")
    assert knobs.apply_env_overrides() == {
        "PROXY_USE_RESOLVER_PRIVATE_MUTATIONS": False}
    monkeypatch.setenv("FDBTPU_KNOB_OVERRIDES",
                       "ENABLE_VERSION_VECTOR_TLOG_UNICAST=maybe")
    with pytest.raises(ValueError, match="not a boolean"):
        knobs.apply_env_overrides()
    monkeypatch.setenv("OTHER", "NO_SUCH_KNOB=1")
    with pytest.raises(KeyError):
        knobs.apply_env_overrides("OTHER")
