"""The port's wire cluster as processes on the CPU: its controller, workers,
ratekeeper and monitor, twins of the JAX package's tests.

* `test_controller_recruits_and_recovers_from_kill`: a port controller
  and five port workers (resolvers "cuda" with device="cpu", the plain
  versions) recruit the transaction system; a kill -9 of the resolver's
  worker recovers it into a strictly newer generation, durable data
  survives, and a pre-recovery snapshot aborts (the twin of
  tests/test_lifecycle.py::test_controller_recruits_and_recovers_from_kill,
  asserting what it asserts).
* `test_ratekeeper_peers_follow_topology`: the port's RatekeeperRole
  re-resolves its peers from the controller's topology (the twin of
  tests/test_lifecycle.py::test_ratekeeper_peers_follow_topology; no
  process).
* `test_restart_on_death_and_reload`: the port's monitor restarts a
  SIGKILLed tlog on its data dir and reloads its conf (the twin of
  tests/test_monitor.py::test_restart_on_death_and_reload).
* `test_parse_conf_matches_jax`: `parse_conf` of one file in both
  packages (no process).

Two tests here spawn processes. Their children run with one intra-op
thread (OMP_NUM_THREADS=1): several torch processes share the host's
cores.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import shutil
import signal
import tempfile
import time

import pytest

from foundationdb_tpu.cluster import monitor as JMON
from foundationdb_tpu_torch.cluster import generation as gen
from foundationdb_tpu_torch.cluster import monitor as PMON
from foundationdb_tpu_torch.cluster import multiprocess as mp
from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.wire import transport
from foundationdb_tpu_torch.wire.codec import Mutation

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

#: a small kernel: the CPU plain path pays the padded shape every batch
SMALL_KERNEL = ("KernelConfig(max_key_bytes=16, max_txns=64, max_reads=256,"
                " max_writes=256, history_capacity=4096)")


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@pytest.fixture
def sock_dir():
    # a short path: a Unix socket's holds at most 107 bytes
    d = tempfile.mkdtemp(prefix="lc")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def one_thread_children(monkeypatch):
    """The spawned children inherit one intra-op thread."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


# ---------------------------------------------------------------------------
# controller + worker recruitment and kill -9 recovery


def test_controller_recruits_and_recovers_from_kill(sock_dir,
                                                   one_thread_children):
    d = sock_dir
    conf = {
        "resolvers": 1,
        "backend": "cuda",
        "device": "cpu",
        "resolver_kernel": SMALL_KERNEL,
        "tlog_data_dir": os.path.join(d, "tlog-data"),
        "storage_data_dir": os.path.join(d, "storage-data"),
        "ratekeeper": False,  # keep the test cluster minimal and fast
    }
    conf_path = os.path.join(d, "cluster.json")
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    ctrl = mp.spawn_role("controller", d, cluster_conf=conf_path,
                         state_file=os.path.join(d, "epoch.json"))
    workers = [
        mp.spawn_role("worker", d, index=i, controller=ctrl.address,
                      worker_id=f"w{i}", device="cpu")
        for i in range(5)
    ]
    try:
        async def scenario():
            client = mp.ClusterClient(ctrl.address, recovery_timeout=90)
            await client.connect()
            assert client.epoch >= 1
            epoch0 = client.epoch

            # pre-recovery commits
            for i in range(3):
                rv = await client.get_read_version()
                v = await client.commit(CommitTransaction(
                    write_conflict_ranges=[(b"k%d" % i, b"k%d\x00" % i)],
                    read_snapshot=rv,
                    mutations=[Mutation(0, b"k%d" % i, b"v%d" % i)],
                ))
            assert await client.read(b"k1", v) == b"v1"
            stale_rv = await client.get_read_version()

            # the recruited resolver is the port's TorchConflictSet on the
            # device the conf named
            topo = await client.topology()
            res = next(e for e in topo["roles"].values()
                       if e["kind"] == "resolver")
            conn = transport.RpcConnection(res["address"])
            await conn.connect()
            st = json.loads((await conn.call(
                mp.TOKEN_STATUS, mp.StatusRequest(pad=0))).payload)
            await conn.close()
            assert st["role"] == "resolver" and st["backend"] == "cuda"
            assert st["conflict_set"] == {"class": "TorchConflictSet",
                                          "device": "cpu"}
            assert "kernel_launches" in st

            # kill -9 the resolver's worker process
            os.kill(res["pid"], signal.SIGKILL)

            # the controller recovers into a strictly newer generation
            deadline = time.monotonic() + 90
            while time.monotonic() < deadline:
                try:
                    topo = await client.topology()
                    if (topo["epoch"] > epoch0
                            and topo["state"] == gen.FULLY_RECOVERED):
                        break
                except Exception:
                    pass
                await asyncio.sleep(0.2)
            else:
                raise AssertionError(f"no recovery observed: {topo}")
            assert topo["recovery_version"] > v

            # post-recovery: commits flow (riding through unknowns: the
            # client may still hold the fenced generation's connection)
            for _ in range(10):
                try:
                    rv = await client.get_read_version()
                    v2 = await client.commit(CommitTransaction(
                        write_conflict_ranges=[(b"post", b"post\x00")],
                        read_snapshot=rv,
                        mutations=[Mutation(0, b"post", b"yes")],
                    ))
                    break
                except mp.CommitUnknownError:
                    await asyncio.sleep(0.1)
            else:
                raise AssertionError("no post-recovery commit landed")
            # durable data survived the recovery
            assert await client.read(b"k1", v2) == b"v1"
            # conservative abort: a pre-recovery snapshot with a read
            # conflict range does not commit
            with pytest.raises(mp.NotCommittedError):
                await client.commit(CommitTransaction(
                    read_conflict_ranges=[(b"k0", b"k0\x00")],
                    write_conflict_ranges=[(b"k0", b"k0\x00")],
                    read_snapshot=stale_rv,
                    mutations=[Mutation(0, b"k0", b"stale")],
                ))

            # the recovery timeline from the controller's status
            conn = transport.RpcConnection(ctrl.address)
            await conn.connect()
            st = json.loads((await conn.call(
                mp.TOKEN_STATUS, mp.StatusRequest(pad=0)
            )).payload)
            await conn.close()
            q = st["qos"]
            assert q["recovery_state"] == gen.FULLY_RECOVERED
            assert q["recoveries_completed"] >= 2  # recruitment + kill
            walk = [r["status"] for r in q["recovery_timeline"]
                    if r["epoch"] == q["epoch"]]
            assert walk[-len(gen.RECOVERY_STATES):] == list(
                gen.RECOVERY_STATES
            )
            await client.close()

        run(scenario())
    finally:
        for p in [ctrl, *workers]:
            p.stop()
    assert all(p.proc.poll() is not None for p in [ctrl, *workers])


# ---------------------------------------------------------------------------
# the ratekeeper's peers follow the controller's topology


def test_ratekeeper_peers_follow_topology(sock_dir):
    """A RatekeeperRole with a controller re-resolves its peers every
    control cycle: after the topology swaps the resolver's address, the
    budget recovers from the saturated old resolver's clamp, because the
    new resolver's idle occupancy feed replaces it."""

    async def scenario():
        busy = {"occupancy": 1.5}

        async def topo_payload(state):
            return mp.TopologyReply(payload=json.dumps(state))

        # stub resolver servers: one saturated, one idle
        async def resolver_status(occ):
            return mp.StatusReply(payload=json.dumps({
                "role": "resolver",
                "qos": {"occupancy": occ, "queue_depth": 0},
            }))

        sock_a = os.path.join(sock_dir, "resA.sock")
        sock_b = os.path.join(sock_dir, "resB.sock")
        ctrl_sock = os.path.join(sock_dir, "ctrl.sock")
        srv_a = transport.RpcServer(sock_a)
        srv_a.register(
            mp.TOKEN_STATUS, lambda _r: resolver_status(busy["occupancy"])
        )
        srv_b = transport.RpcServer(sock_b)
        srv_b.register(mp.TOKEN_STATUS, lambda _r: resolver_status(0.0))
        topo_state = {
            "epoch": 1,
            "roles": {"resolver0": {"kind": "resolver", "address": sock_a}},
        }
        ctrl = transport.RpcServer(ctrl_sock)
        ctrl.register(mp.TOKEN_TOPOLOGY, lambda _r: topo_payload(topo_state))
        for s in (srv_a, srv_b, ctrl):
            await s.start()

        rk = mp.RatekeeperRole([], interval=0.05, controller=ctrl_sock)
        await rk.start()
        try:
            # the peers resolve from the topology; the saturated resolver
            # clamps the budget
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                info = rk.law.rate_info()
                by = info.get("budget_limited_by") or {}
                if rk.peers == [sock_a] and "resolver" in str(
                    by.get("name", "")
                ):
                    break
                await asyncio.sleep(0.05)
            assert rk.peers == [sock_a]
            clamped = rk.law.rate_info()["transactions_per_second_limit"]

            # recovery: the topology swaps in a re-recruited resolver
            topo_state["epoch"] = 2
            topo_state["roles"] = {
                "resolver0": {"kind": "resolver", "address": sock_b}
            }
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                if rk.peers == [sock_b] and rk.topology_epoch == 2:
                    budget = rk.law.rate_info()[
                        "transactions_per_second_limit"
                    ]
                    if budget > clamped * 1.5:
                        break
                await asyncio.sleep(0.05)
            assert rk.peers == [sock_b], "peer list did not re-resolve"
            assert rk.peer_refreshes >= 1
            budget = rk.law.rate_info()["transactions_per_second_limit"]
            assert budget > clamped * 1.5, (
                f"budget did not recover: {clamped} -> {budget}"
            )
        finally:
            await rk.stop()
            assert not rk._conns and not rk._controller_conns
            for s in (srv_a, srv_b, ctrl):
                await s.close()

    run(scenario())


# ---------------------------------------------------------------------------
# the monitor


def write_conf(path, socket_dir, tlog_dir, extra=""):
    with open(path, "w") as f:
        f.write(f"""
[role.r0]
kind = resolver
socket_dir = {socket_dir}
device = cpu

[role.t0]
kind = tlog
socket_dir = {socket_dir}
data_dir = {tlog_dir}
{extra}
""")


def test_parse_conf_matches_jax(tmp_path):
    """One conf file, both packages' parse_conf: equal specs but for the
    port's two differences, `device` (JAX has none) and `backend`'s
    default ("cuda"; JAX "native")."""
    conf = tmp_path / "cluster.conf"
    write_conf(conf, str(tmp_path), str(tmp_path / "td"), extra="""
[role.w0]
kind = worker
socket_dir = %s
index = 3
backend = native
controller = %s/controller0.sock

[role.c0]
kind = controller
socket_dir = %s
cluster_conf = %s/cluster.json
state_file = %s/state.json
""" % ((str(tmp_path),) * 5))
    port, jax = PMON.parse_conf(str(conf)), JMON.parse_conf(str(conf))
    assert set(port) == set(jax) == {"r0", "t0", "w0", "c0"}
    for name in port:
        p = dataclasses.asdict(port[name])
        j = dataclasses.asdict(jax[name])
        assert port[name].address == jax[name].address
        # the differences, named
        assert p.pop("device") == ("cpu" if name == "r0" else None)
        if name == "w0":
            assert p["backend"] == j["backend"] == "native"
        else:
            assert (p.pop("backend"), j.pop("backend")) == ("cuda", "native")
        assert p == j, name
    # two sections on one socket are refused in both
    clash = tmp_path / "clash.conf"
    clash.write_text(f"""
[role.a]
kind = tlog
socket_dir = {tmp_path}

[role.b]
kind = tlog
socket_dir = {tmp_path}
""")
    for mon in (PMON, JMON):
        with pytest.raises(ValueError, match="share"):
            mon.parse_conf(str(clash))


def test_restart_on_death_and_reload(sock_dir, one_thread_children):
    conf = os.path.join(sock_dir, "cluster.conf")
    socks = os.path.join(sock_dir, "s")
    os.makedirs(socks)
    tlog_dir = os.path.join(sock_dir, "tlog-data")
    write_conf(conf, socks, tlog_dir)
    mon = PMON.Monitor(conf, log=lambda *a: None)
    mon.start_all()
    try:
        tlog_addr = mon.children["t0"].spec.address

        async def push_one(version, prev):
            c = await mp.connect(tlog_addr)
            try:
                rep = await c.call(
                    mp.TOKEN_TLOG_PUSH,
                    mp.TLogPush(version=version, prev_version=prev,
                                mutations=[Mutation(0, b"k", b"v")]),
                )
                return rep.durable_version
            finally:
                await c.close()

        assert run(push_one(10, -1)) == 10

        # SIGKILL the tlog: the monitor relaunches it on the same data
        # dir, and the DiskQueue's recovery restores version 10
        pid = mon.children["t0"].proc.proc.pid
        mon.children["t0"].proc.proc.kill()
        mon.children["t0"].proc.proc.wait()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            mon.poll_once()
            if mon.children["t0"].proc.proc.poll() is None and \
                    mon.children["t0"].proc.proc.pid != pid:
                break
            time.sleep(0.1)
        assert mon.restarts.get("t0") == 1

        async def get_version():
            c = await mp.connect(tlog_addr)
            try:
                rep = await c.call(
                    mp.TOKEN_TLOG_VERSION, mp.RoleVersionReq(pad=0))
                return rep.version
            finally:
                await c.close()

        assert run(get_version()) == 10  # recovered from disk
        assert run(push_one(20, 10)) == 20  # and accepting new pushes

        # the resolver the monitor started is the port's, on the CPU
        async def resolver_status():
            c = await mp.connect(mon.children["r0"].spec.address,
                                 proc=mon.children["r0"].proc)
            try:
                rep = await c.call(mp.TOKEN_STATUS, mp.StatusRequest(pad=0))
                return json.loads(rep.payload)
            finally:
                await c.close()

        st = run(resolver_status())
        assert st["conflict_set"] == {"class": "TorchConflictSet",
                                      "device": "cpu"}

        # conf reload: add a storage role, drop the resolver
        with open(conf, "w") as f:
            f.write(f"""
[role.t0]
kind = tlog
socket_dir = {socks}
data_dir = {tlog_dir}

[role.s0]
kind = storage
socket_dir = {socks}
""")
        r0 = mon.children["r0"].proc
        mon.reload()
        assert set(mon.children) == {"t0", "s0"}
        assert r0.proc.poll() is not None  # the removed section stopped

        async def storage_up():
            c = await mp.connect(mon.children["s0"].spec.address)
            try:
                rep = await c.call(
                    mp.TOKEN_STORAGE_VERSION, mp.RoleVersionReq(pad=0))
                return rep.version
            finally:
                await c.close()

        assert run(storage_up()) == 0
    finally:
        procs = [c.proc for c in mon.children.values()]
        mon.stop_all()
    assert all(p.proc.poll() is not None for p in procs)
