"""The port's multiversion client (`cluster/multiversion.py`:
`MultiVersionClient`, `ClusterVersionChangedError`) held against the
JAX package's on the CPU.

Twins of every test of tests/test_multiversion.py, written once against
a package namespace (the client, the transport's RpcServer and the Ping
frames of one package): probing down to an older cluster, an upgrade
raising cluster_version_changed before the retry rides the new client,
a same-version restart raising (at most once) and no common version
failing loudly. No cluster runs, so no pair of backends: both packages'
results must be equal. Also: the port's client against a JAX server,
and the JAX client against a port server, across the same upgrade.
"""

from __future__ import annotations

import asyncio
import os

import pytest

from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from twins import JAX, PORT, World, check_packages, norm, outcome

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

TOKEN = 0x5151
PV_OLD = 0x0FDB_7E50_0004
PV_NEW = 0x0FDB_7E50_0005

TWINS = {}


def twin(fn):
    TWINS[fn.__name__] = fn
    return fn


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def _serve(S, address, pv):
    """A Ping server of namespace `S` speaking protocol `pv`."""
    server = S.transport.RpcServer(address, protocol_version=pv)

    async def ping(msg):
        return S.multiprocess.Pong(payload=msg.payload + b"@%x" % pv)

    server.register(TOKEN, ping)
    await server.start()
    return server


async def _upgrade(S, C, address):
    """A cluster of `S` restarting on a newer protocol under a client of
    `C`: the in-flight call raises, the retry rides the new client."""
    server = await _serve(S, address, PV_OLD)
    mv = C.multiversion.MultiVersionClient(address, [PV_NEW, PV_OLD])
    out = [(await mv.call(TOKEN, C.multiprocess.Ping(payload=b"a"))).payload,
           mv.protocol_version]
    await server.close()
    os.unlink(address)
    server2 = await _serve(S, address, PV_NEW)
    out.append(await outcome(mv.call(TOKEN, C.multiprocess.Ping(payload=b"b"))))
    out.append(mv.swaps)
    out.append((await mv.call(TOKEN, C.multiprocess.Ping(payload=b"c")))
               .payload)
    out.append(mv.protocol_version)
    await mv.close()
    await server2.close()
    return out


@twin
def probes_down_to_older_cluster(w):
    P, address = w.P, w.tmp + "/mv.sock"

    async def go():
        server = await _serve(P, address, PV_OLD)
        mv = P.multiversion.MultiVersionClient(address, [PV_NEW, PV_OLD])
        rep = await mv.call(TOKEN, P.multiprocess.Ping(payload=b"x"))
        pv = mv.protocol_version
        await mv.close()
        await server.close()
        return rep.payload, pv

    got = run(go())
    assert got == (b"x@%x" % PV_OLD, PV_OLD)
    return got


@twin
def upgrade_raises_cluster_version_changed_then_works(w):
    out = run(_upgrade(w.P, w.P, w.tmp + "/mv.sock"))
    assert out[1] == PV_OLD
    assert out[2] == ("err", "ClusterVersionChangedError") and out[3] == 1
    assert out[4:] == [b"c@%x" % PV_NEW, PV_NEW]
    return out


@twin
def same_version_restart_is_at_most_once(w):
    P, address = w.P, w.tmp + "/mv.sock"

    async def go():
        server = await _serve(P, address, PV_NEW)
        mv = P.multiversion.MultiVersionClient(address, [PV_NEW, PV_OLD])
        await mv.call(TOKEN, P.multiprocess.Ping(payload=b"a"))
        await server.close()
        os.unlink(address)
        server2 = await _serve(P, address, PV_NEW)
        with pytest.raises(P.transport.TransportError) as e:
            await mv.call(TOKEN, P.multiprocess.Ping(payload=b"b"))
        out = [type(e.value).__name__, mv.swaps]
        out.append((await mv.call(TOKEN, P.multiprocess.Ping(payload=b"b")))
                   .payload)
        await mv.close()
        await server2.close()
        return out

    out = run(go())
    assert out == ["TransportError", 0, b"b@%x" % PV_NEW]
    return out


@twin
def no_common_version_fails_loudly(w):
    P, address = w.P, w.tmp + "/mv.sock"

    async def go():
        server = await _serve(P, address, 0x0FDB_7E50_0001)
        mv = P.multiversion.MultiVersionClient(address, [PV_NEW, PV_OLD])
        with pytest.raises(P.transport.TransportError, match="protocol") as e:
            await mv.connect(retries=2, delay=0.01)
        await server.close()
        return type(e.value).__name__, mv.conn, mv.protocol_version

    got = run(go())
    assert got == ("TransportError", None, None)
    return got


@pytest.mark.parametrize("name", list(TWINS))
def test_twin(name):
    check_packages(TWINS[name])


def test_twins_cover_their_sources():
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).parent / "test_multiversion.py")
                     .read_text())
    names = {n.name.removeprefix("test_") for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    assert names == set(TWINS)


@pytest.mark.parametrize("server,client", [(JAX, PORT), (PORT, JAX)])
def test_upgrade_across_packages(server, client):
    """The handshake is one protocol: a client of either package follows
    a server of the other across the upgrade, as it follows its own."""
    S, C = World(server, None), World(client, None)
    try:
        out = run(_upgrade(S.P, C.P, S.tmp + "/mv.sock"))
    finally:
        S.close()
        C.close()
    want = check_packages(TWINS[
        "upgrade_raises_cluster_version_changed_then_works"])
    assert norm(out) == want
