"""Mutual TLS on the port's wire transport, with the port's certificate
tooling (`crypto/tls.py`: `generate_ca`, `issue_cert`, `make_test_tls`,
`TLSConfig`), held against the JAX package's on the CPU.

* Every case of tests/test_tls.py on the port: a round trip over a Unix
  socket and over TCP, a plaintext client refused, a client without a
  certificate dropped, a certificate of another CA refused, the
  client's and the server's organization checks, and a cluster of port
  role processes under FDB_TPU_TLS_DIR (a "cuda" resolver on the CPU, a
  tlog, a storage) committing and reading through the port's pipeline
  while a plaintext client is refused.
* Across the packages: certificates made by the port's tooling are
  accepted by the JAX TLSConfig and transport (as server, as client, or
  both), and the JAX tooling's by the port's, organization checks
  included; the files, subjects, issuers and extensions are the same.
"""

from __future__ import annotations

import asyncio
import os
import shutil
import ssl
import tempfile

import pytest

pytest.importorskip("cryptography")

from foundationdb_tpu.crypto import tls as JTLS
from foundationdb_tpu.wire import transport as JTR
from foundationdb_tpu_torch.cluster import multiprocess as mp
from foundationdb_tpu_torch.crypto import tls as PTLS
from foundationdb_tpu_torch.crypto.tls import TLSConfig, make_test_tls
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.wire import transport
from time_limit import limit_each_test

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

_limit = limit_each_test(120)

TOKEN = 0x7777


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def _serve(address, tls, tr=transport, ping_cls=mp):
    server = tr.RpcServer(address, tls=tls)

    async def ping(msg):
        return ping_cls.Pong(payload=msg.payload)

    server.register(TOKEN, ping)
    await server.start()
    return server


@pytest.fixture
def short_dir():
    # a short path: a Unix socket's holds at most 107 bytes
    d = tempfile.mkdtemp(prefix="tl")
    yield d
    shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# tests/test_tls.py on the port


@pytest.mark.parametrize("kind", ["uds", "tcp"])
def test_mutual_tls_roundtrip(tmp_path, short_dir, kind):
    tls = make_test_tls(str(tmp_path / "pki"))
    address = (os.path.join(short_dir, "tls.sock") if kind == "uds"
               else ("127.0.0.1", 0))

    async def go():
        server = await _serve(address, tls["server"])
        addr = (address if kind == "uds"
                else ("127.0.0.1", server._server.sockets[0].getsockname()[1]))
        conn = transport.RpcConnection(addr, tls=tls["client"])
        await conn.connect()
        rep = await conn.call(TOKEN, mp.Ping(payload=b"over-tls"))
        assert rep.payload == b"over-tls"
        await conn.close()
        await server.close()

    run(go())


def test_plaintext_client_rejected(tmp_path, short_dir):
    tls = make_test_tls(str(tmp_path / "pki"))
    address = os.path.join(short_dir, "tls.sock")

    async def go():
        server = await _serve(address, tls["server"])
        conn = transport.RpcConnection(address)  # no TLS
        with pytest.raises(transport.TransportError):
            await conn.connect(retries=2, delay=0.01)
        await conn.close()
        await server.close()

    run(go())


def test_client_without_cert_rejected(tmp_path, short_dir):
    """The server requires a CA-chained client certificate: a client that
    trusts the CA but presents none is dropped."""
    tls = make_test_tls(str(tmp_path / "pki"))
    address = os.path.join(short_dir, "tls.sock")

    async def go():
        server = await _serve(address, tls["server"])
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(tls["client"].ca_file)
        ctx.check_hostname = False
        try:
            reader, writer = await asyncio.open_unix_connection(
                path=address, ssl=ctx, server_hostname="")
            # the server may see the missing certificate at the first read
            writer.write(b"x" * 64)
            await writer.drain()
            data = await asyncio.wait_for(reader.read(16), timeout=2)
            assert data == b""  # it hung up without serving
        except (ssl.SSLError, ConnectionError, asyncio.IncompleteReadError):
            pass  # or dropped during the handshake
        await server.close()

    run(go())


def test_wrong_ca_rejected(tmp_path, short_dir):
    tls_a = make_test_tls(str(tmp_path / "pki_a"))
    tls_b = make_test_tls(str(tmp_path / "pki_b"))
    address = os.path.join(short_dir, "tls.sock")

    async def go():
        server = await _serve(address, tls_a["server"])
        mixed = TLSConfig(ca_file=tls_a["client"].ca_file,
                          cert_file=tls_b["client"].cert_file,
                          key_file=tls_b["client"].key_file)
        conn = transport.RpcConnection(address, tls=mixed)
        with pytest.raises(transport.TransportError):
            await conn.connect(retries=2, delay=0.01)
        await conn.close()
        await server.close()

    run(go())


def test_verify_peer_organization(tmp_path, short_dir):
    """A CA-valid server of another organization is refused after the
    handshake, before any frame."""
    tls = make_test_tls(str(tmp_path / "pki"), organization="good-org")
    address = os.path.join(short_dir, "tls.sock")

    def client(org):
        c = tls["client"]
        return TLSConfig(ca_file=c.ca_file, cert_file=c.cert_file,
                         key_file=c.key_file, verify_peer_organization=org)

    async def go():
        server = await _serve(address, tls["server"])
        conn = transport.RpcConnection(address, tls=client("good-org"))
        await conn.connect()
        assert (await conn.call(TOKEN, mp.Ping(payload=b"x"))).payload == b"x"
        await conn.close()
        conn2 = transport.RpcConnection(address, tls=client("other-org"))
        with pytest.raises(transport.TransportError):
            await conn2.connect(retries=1, delay=0.01)
        await conn2.close()
        await server.close()

    run(go())


def test_server_side_verify_peers_rejects_wrong_org(tmp_path, short_dir):
    pki = str(tmp_path / "pki")
    ca_cert, ca_key = PTLS.generate_ca(pki, organization="good-org")
    s_cert, s_key = PTLS.issue_cert(pki, ca_cert, ca_key, "server",
                                    organization="good-org")
    c_cert, c_key = PTLS.issue_cert(pki, ca_cert, ca_key, "rogue",
                                    organization="rogue-org")
    address = os.path.join(short_dir, "tls.sock")

    async def go():
        server = await _serve(address, TLSConfig(
            ca_file=ca_cert, cert_file=s_cert, key_file=s_key,
            verify_peer_organization="good-org"))
        conn = transport.RpcConnection(address, tls=TLSConfig(
            ca_file=ca_cert, cert_file=c_cert, key_file=c_key))
        # the handshake succeeds (a CA-valid certificate); the server's
        # subject check then drops the connection
        try:
            await conn.connect(retries=1, delay=0.01)
            with pytest.raises((transport.TransportError,
                                asyncio.TimeoutError)):
                await conn.call(TOKEN, mp.Ping(payload=b"x"), timeout=1.0)
        except (transport.TransportError, ConnectionError):
            pass
        await conn.close()
        await server.close()

    run(go())


def test_multiprocess_cluster_over_tls(short_dir, monkeypatch):
    """Port role processes under FDB_TPU_TLS_DIR serve mutual TLS; the
    port's pipeline commits and reads through them, and a plaintext
    client is refused."""
    from foundationdb_tpu_torch.models.types import CommitTransaction
    from foundationdb_tpu_torch.wire.codec import Mutation

    pki = os.path.join(short_dir, "pki")
    make_test_tls(pki, names=("node",))
    assert os.path.exists(os.path.join(pki, "ca.crt"))
    monkeypatch.setenv("FDB_TPU_TLS_DIR", pki)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert mp._tls_from_env().cert_file == os.path.join(pki, "node.crt")
    kernel = ("KernelConfig(max_key_bytes=16, max_txns=64, max_reads=256, "
              "max_writes=256, history_capacity=4096)")
    procs = [mp.spawn_role("tlog", short_dir),
             mp.spawn_role("storage", short_dir),
             mp.spawn_role("resolver", short_dir, backend="cuda",
                           device="cpu", env={"RESOLVER_KERNEL": kernel})]
    try:
        async def go():
            tc, sc, rc = [await mp.connect(p.address, proc=p)
                          for p in procs]
            pipe = mp.ProxyPipeline([rc], tc, sc)
            pipe.start()
            try:
                v = await pipe.commit(CommitTransaction(
                    read_conflict_ranges=[], write_conflict_ranges=[],
                    mutations=[Mutation(0, b"tlsk", b"tlsv")],
                    read_snapshot=0))
                assert await pipe.read(b"tlsk", v) == b"tlsv"
            finally:
                await pipe.stop()
                for c in (rc, tc, sc):
                    await c.close()
            plain = transport.RpcConnection(procs[1].address)  # no TLS
            with pytest.raises(transport.TransportError):
                await plain.connect(retries=2, delay=0.01)
            await plain.close()

        run(go())
    finally:
        for p in procs:
            p.stop()


# ---------------------------------------------------------------------------
# certificates across the packages

def _jax_mp():
    from foundationdb_tpu.cluster import multiprocess as JMP

    return JMP


#: a package's certificate tooling and TLSConfig, transport and messages
PKGS = {"port": lambda: (PTLS, transport, mp),
        "jax": lambda: (JTLS, JTR, _jax_mp())}


@pytest.mark.parametrize("maker", ["port", "jax"])
@pytest.mark.parametrize("server,client", [("jax", "jax"), ("jax", "port"),
                                           ("port", "jax")])
def test_certificates_across_packages(tmp_path, short_dir, maker, server,
                                      client):
    """One package's tooling makes the PKI; a server and a client of
    either package (the other's at least once) take it through their own
    TLSConfig, with the organization check on both ends, and a client
    certificate of another CA is refused."""
    made = PKGS[maker]()[0].make_test_tls(str(tmp_path / "pki"),
                                          organization="good-org")
    other = PKGS[maker]()[0].make_test_tls(str(tmp_path / "other"))
    s_tls, s_tr, s_mp = PKGS[server]()
    c_tls, c_tr, c_mp = PKGS[client]()

    def cfg(tls_mod, name, org=None, certs=made):
        return tls_mod.TLSConfig(ca_file=made[name].ca_file,
                                 cert_file=certs[name].cert_file,
                                 key_file=certs[name].key_file,
                                 verify_peer_organization=org)

    address = os.path.join(short_dir, "x.sock")

    async def go():
        srv = await _serve(address, cfg(s_tls, "server", "good-org"), s_tr,
                           s_mp)
        conn = c_tr.RpcConnection(address,
                                  tls=cfg(c_tls, "client", "good-org"))
        await conn.connect()
        rep = await conn.call(TOKEN, c_mp.Ping(payload=b"pem"))
        assert rep.payload == b"pem"
        await conn.close()
        bad = c_tr.RpcConnection(address,
                                 tls=cfg(c_tls, "client", certs=other))
        with pytest.raises(c_tr.TransportError):
            await bad.connect(retries=1, delay=0.01)
        await bad.close()
        await srv.close()

    run(go())


def test_tooling_layout_and_subjects_match(tmp_path):
    """The same file names, the CA's basic constraints, each node
    certificate's subject (CN, O), issuer and SANs, in both packages."""
    from cryptography import x509

    def describe(directory, names):
        out = {}
        for n in ("ca",) + names:
            with open(os.path.join(directory, f"{n}.crt"), "rb") as f:
                c = x509.load_pem_x509_certificate(f.read())
            exts = {e.oid.dotted_string: e.critical for e in c.extensions}
            out[n] = (c.subject.rfc4514_string(), c.issuer.rfc4514_string(),
                      exts, (c.not_valid_after_utc
                             - c.not_valid_before_utc).days)
        return sorted(os.listdir(directory)), out

    names = ("node", "client")
    PTLS.make_test_tls(str(tmp_path / "p"), names=names, organization="o1")
    JTLS.make_test_tls(str(tmp_path / "j"), names=names, organization="o1")
    assert describe(str(tmp_path / "p"), names) == \
        describe(str(tmp_path / "j"), names)
