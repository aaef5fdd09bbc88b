"""The port's wire cluster under a controller: the codecs and the
deterministic pieces, held against the JAX package on the CPU, with no
processes.

* The 16 lifecycle messages (RegisterWorker, InitializeRole,
  TopologyRequest, WorkerDeath, RateUpdate and the client front door's
  ClientGrv, ClientCommit and ClientRead, each with its reply) encode
  byte-identically in both packages, and each decodes the other's
  bytes; their tokens are JAX's.
* The controller's logic through both packages' classes on the same
  inputs: worker registration, `_plan`, the topology document,
  `worker_death`'s push path and the miss budget, the heartbeat's miss
  count, the elastic trigger, scale-down and their gates, the recovery
  walk (`_recover` with its worker calls stubbed: the same frames,
  recruits, state and topology), the ratekeeper's `_push_due`
  hysteresis, the rate push's epoch fence, and the persisted topology
  across a restart. Each test names its source test; outputs and state
  are equal.
* A controller state file written by either package loads in the other.
* `ResolverRole(compute_cost_per_txn=...)`: `_local_txns` equals JAX's
  on clipped multi-resolver requests, and 0.0 awaits nothing.
* A worker's roles: `init_role` replies and status equal JAX's for each
  kind, and a "cuda" resolver with no device on a host without a card
  fails its recruit.
* The sim / wire recovery parity of tests/test_lifecycle.py: the JAX sim
  recovery's decisions on an in-flight set against the port's
  ResolverRole at "cuda" (device="cpu"), "native" and "cpu".

The tolerance is equality throughout.
"""

from __future__ import annotations

import asyncio
import json
import os
import struct
import time
import types

import pytest
import torch

from foundationdb_tpu.cluster import multiprocess as JMP
from foundationdb_tpu.cluster.ratekeeper import AdmissionController as JAC
from foundationdb_tpu.models import types as JT
from foundationdb_tpu.utils import packing as JPK
from foundationdb_tpu.wire import codec as JC
from foundationdb_tpu_torch.cluster import generation as PG
from foundationdb_tpu_torch.cluster import multiprocess as PMP
from foundationdb_tpu_torch.cluster.ratekeeper import AdmissionController as PAC
from foundationdb_tpu_torch.models import types as PT
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import packing as PPK
from foundationdb_tpu_torch.wire import codec as PC

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

PKG = {
    "port": types.SimpleNamespace(types=PT, codec=PC, mp=PMP, packing=PPK,
                                  law=PAC),
    "jax": types.SimpleNamespace(types=JT, codec=JC, mp=JMP, packing=JPK,
                                 law=JAC),
}

SMALL_KERNEL = ("KernelConfig(max_key_bytes=16, max_txns=64, max_reads=256,"
                " max_writes=256, history_capacity=65536, "
                "window_versions=5000000)")


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# ---------------------------------------------------------------------------
# the lifecycle messages


def _txn(p, i):
    M = p.codec.Mutation
    return p.types.CommitTransaction(
        read_conflict_ranges=[(b"r%d" % i, b"s")],
        write_conflict_ranges=[(b"k%d" % i, b"k%d\x00" % i)],
        read_snapshot=1_000 * i, report_conflicting_keys=bool(i % 2),
        mutations=[M(0, b"k%d" % i, b"v" * i)])


def _doc(**kw):
    return json.dumps(kw)


#: name -> (type id, token, constructor over a package namespace)
LIFECYCLE_CASES = {
    "register worker": (0x0250, 0x0601, lambda p: p.mp.RegisterWorker(
        payload=_doc(worker_id="w3", address="/s/worker3.sock", pid=77,
                     roles={"resolver": 4}))),
    "register worker reply": (0x0251, 0x0601,
                              lambda p: p.mp.RegisterWorkerReply(
                                  payload=_doc(ok=True, epoch=4))),
    "initialize role": (0x0252, 0x0602, lambda p: p.mp.InitializeRole(
        payload=_doc(kind="resolver", epoch=5, backend="cuda",
                     resolver_kernel=SMALL_KERNEL, device="cpu"))),
    "initialize role reply": (0x0253, 0x0602,
                              lambda p: p.mp.InitializeRoleReply(
                                  payload=_doc(ok=True, kind="tlog",
                                               durable_version=12))),
    "topology request": (0x0254, 0x0603,
                         lambda p: p.mp.TopologyRequest(pad=0)),
    "topology reply": (0x0255, 0x0603, lambda p: p.mp.TopologyReply(
        payload=_doc(epoch=3, state="fully_recovered",
                     roles={"proxy0": {"kind": "proxy", "pid": None}}))),
    "client grv": (0x0258, 0x0701, lambda p: p.mp.ClientGrvRequest(pad=0)),
    "client grv reply": (0x0259, 0x0701,
                         lambda p: p.mp.ClientGrvReply(version=2**40 + 3)),
    "client commit": (0x025A, 0x0702,
                      lambda p: p.mp.ClientCommitRequest(txn=_txn(p, 3))),
    "client commit empty": (0x025A, 0x0702, lambda p: p.mp.ClientCommitRequest(
        txn=p.types.CommitTransaction())),
    "client commit reply": (0x025B, 0x0702,
                            lambda p: p.mp.ClientCommitReply(version=-1)),
    "client read": (0x025C, 0x0703, lambda p: p.mp.ClientReadRequest(
        key=b"\x00user\xff", version=9)),
    "client read reply": (0x025D, 0x0703,
                          lambda p: p.mp.ClientReadReply(value=b"v" * 1000)),
    "client read reply absent": (0x025D, 0x0703,
                                 lambda p: p.mp.ClientReadReply(value=None)),
    "worker death": (0x0262, 0x0604, lambda p: p.mp.WorkerDeath(
        payload=_doc(worker_id="w1", kind="worker", rc=-9))),
    "worker death reply": (0x0263, 0x0604, lambda p: p.mp.WorkerDeathReply(
        payload=_doc(ok=True, roles=["resolver1"]))),
    "rate update": (0x0264, 0x0605, lambda p: p.mp.RateUpdate(
        payload=_doc(transactions_per_second_limit=1e6, epoch=2))),
    "rate update reply": (0x0265, 0x0605, lambda p: p.mp.RateUpdateReply(
        payload=_doc(ok=True))),
}

LIFECYCLE_TOKENS = ("TOKEN_REGISTER_WORKER", "TOKEN_INIT_ROLE",
                    "TOKEN_TOPOLOGY", "TOKEN_WORKER_DEATH",
                    "TOKEN_RATE_UPDATE", "TOKEN_CLIENT_GRV",
                    "TOKEN_CLIENT_COMMIT", "TOKEN_CLIENT_READ")


def test_sixteen_message_types_and_their_tokens():
    ids = {tid for tid, _tok, _m in LIFECYCLE_CASES.values()}
    assert len(ids) == 16
    assert ids <= set(PC._REGISTRY)
    names = {type(make(PKG["port"])).__name__
             for _t, _k, make in LIFECYCLE_CASES.values()}
    assert names == {
        f"{base}{suffix}" for base in ("RegisterWorker", "InitializeRole",
                                       "WorkerDeath", "RateUpdate")
        for suffix in ("", "Reply")} | {
        f"{base}{suffix}" for base in ("Topology", "ClientGrv",
                                       "ClientCommit", "ClientRead")
        for suffix in ("Request", "Reply")}
    tokens = {getattr(PMP, n) for n in LIFECYCLE_TOKENS}
    assert tokens == {tok for _t, tok, _m in LIFECYCLE_CASES.values()}
    for n in LIFECYCLE_TOKENS:
        assert getattr(PMP, n) == getattr(JMP, n), n


@pytest.mark.parametrize("name", list(LIFECYCLE_CASES))
def test_lifecycle_frames_are_byte_identical(name):
    tid, _tok, make = LIFECYCLE_CASES[name]
    port_msg, jax_msg = make(PKG["port"]), make(PKG["jax"])
    pb, jb = PC.encode(port_msg), JC.encode(jax_msg)
    assert pb == jb
    assert struct.unpack_from("<H", pb)[0] == tid
    from_jax, from_port = PC.decode(jb), JC.decode(pb)
    assert type(from_jax) is type(port_msg)
    assert type(from_port) is type(jax_msg)
    assert from_jax == port_msg and from_port == jax_msg
    assert PC.encode(from_jax) == jb and JC.encode(from_port) == pb


# ---------------------------------------------------------------------------
# the controller's logic, both packages on the same inputs


def controllers(conf: dict, **kw):
    return {k: PKG[k].mp.ClusterControllerRole(dict(conf), **kw)
            for k in PKG}


def ctrl_state(c) -> dict:
    """Everything the controller's decisions leave behind (the wall
    clock's `last_seen` set apart)."""
    return {
        "epoch": c.gen.epoch,
        "conf": dict(c.conf),
        "workers": {w: {k: v for k, v in info.items() if k != "last_seen"}
                    for w, info in c.workers.items()},
        "assignments": c.assignments,
        "needs_recovery": c._needs_recovery,
        "reason": c._recovery_reason,
        "miss_counts": dict(c._miss_counts),
        "death_notifications": c.death_notifications,
        "wake": c._wake.is_set(),
        "rk_qos": c._rk_qos,
        "elastic": (c.elastic_enabled, c.elastic_recruits,
                    c.elastic_scale_downs, c.elastic_last_streak,
                    c.elastic_last_limiter, c._elastic_gate,
                    c._elastic_last_observed, c._workload_gate,
                    c._workload_streak_observed, dict(c._elastic_baseline)),
        "partitioned": c._partitioned(),
        "role_names": c._role_names(),
        "constants": (c.HEARTBEAT_MISSES, c.WORKER_TTL,
                      c.ELASTIC_RESOLVER_REASONS, c.ELASTIC_PROXY_REASONS),
    }


def beacon(c, wid, roles=None, age=0.0, pid=None):
    c.workers[wid] = {"worker_id": wid, "address": f"/s/{wid}.sock",
                      "pid": pid or 1000 + int(wid[1:]),
                      "roles": roles or {},
                      "last_seen": time.monotonic() - age}


def test_register_worker_and_topology_document():
    """tests/test_lifecycle.py::test_controller_recruits_and_recovers_from_kill
    (the registration and topology the client reads), in-process."""
    cs = controllers({"resolvers": 2, "tlogs": 2, "proxies": 2})
    replies = {}
    for k, c in cs.items():
        mp = PKG[k].mp
        out = []
        for i in range(10):
            rep = run(c.register_worker(mp.RegisterWorker(payload=json.dumps(
                {"worker_id": f"w{i}", "address": f"/s/w{i}.sock",
                 "pid": 100 + i, "roles": {"tlog": 2} if i == 3 else {}}))))
            out.append(rep.payload)
        c.assignments = c._plan()
        out.append(json.dumps(c.topology_doc(), sort_keys=True))
        out.append(run(c.topology(mp.TopologyRequest(pad=0))).payload)
        replies[k] = out
    assert replies["port"] == replies["jax"]
    assert ctrl_state(cs["port"]) == ctrl_state(cs["jax"])
    doc = json.loads(replies["port"][-1])
    assert {r["kind"] for r in doc["roles"].values()} == {
        "tlog", "storage", "sequencer", "resolver", "ratekeeper", "proxy"}
    # re-adoption: the beacon reporting a tlog keeps it
    assert doc["roles"]["tlog0"]["worker"] == "w3"


@pytest.mark.parametrize("case", ["fresh", "keep", "readopt", "stale",
                                  "short"])
def test_plan_matches_jax(case):
    """tests/test_lifecycle.py:376-426 and the controller-kill re-adoption:
    placement preference (the current assignment, a beacon hosting the
    kind, an idle worker, any worker), live-worker TTL, and not enough
    workers."""
    conf = {"resolvers": 2, "tlogs": 2, "proxies": 2, "ratekeeper": True}
    out = {}
    for k, c in controllers(conf).items():
        n = {"short": 5}.get(case, 11)
        for i in range(n):
            roles = {}
            if case == "readopt" and i in (7, 8):
                roles = {"storage": 1} if i == 7 else {"tlog": 1}
            if case == "keep" and i == 9:
                roles = {"resolver": 2}
            beacon(c, f"w{i}", roles,
                   age=10.0 if (case == "stale" and i % 3 == 0) else 0.0)
        if case == "keep":
            c.assignments = {"resolver0": {"kind": "resolver",
                                           "worker_id": "w9",
                                           "address": "/s/w9.sock",
                                           "epoch": 2}}
        try:
            got = ("plan", c._plan())
        except RuntimeError as e:
            got = ("error", str(e))
        out[k] = (got, ctrl_state(c))
    assert out["port"] == out["jax"]
    kind, plan = out["port"][0]
    if case in ("short", "stale"):
        assert kind == "error" and "not enough live workers" in plan
    else:
        assert kind == "plan" and len(plan) == 9
    if case == "keep":
        assert plan["resolver0"]["worker_id"] == "w9"
    if case == "readopt":
        assert plan["storage0"]["worker_id"] == "w7"


def _death_setup(c):
    c._needs_recovery = False  # steady state after the recruitment
    c.assignments = {
        "resolver0": {"kind": "resolver", "worker_id": "w1",
                      "address": "/tmp/x1.sock", "epoch": 3},
        "storage0": {"kind": "storage", "worker_id": "w2",
                     "address": "/tmp/x2.sock", "epoch": 3},
    }
    for w in ("w1", "w2"):
        beacon(c, w)


@pytest.mark.parametrize("dead", ["w1", "w2", "w9"])
def test_worker_death_push_matches_jax(dead):
    """tests/test_lifecycle.py::test_worker_death_push_flags_recovery_
    immediately and ::test_worker_death_push_singleton_preloads_miss_
    budget: a transaction-path death flags the recovery walk at once, a
    singleton's pre-loads its miss budget, an unknown worker only
    counts."""
    out = {}
    for k, c in controllers({"resolvers": 1}).items():
        _death_setup(c)
        rep = run(c.worker_death(PKG[k].mp.WorkerDeath(payload=json.dumps(
            {"worker_id": dead, "kind": "worker", "rc": -9}))))
        out[k] = (rep.payload, ctrl_state(c))
    assert out["port"] == out["jax"]
    state = out["port"][1]
    assert state["death_notifications"] == 1 and state["wake"]
    if dead == "w1":
        assert state["needs_recovery"] and state["reason"] == "push:resolver0"
    if dead == "w2":
        assert not state["needs_recovery"]
        assert state["miss_counts"]["storage0"] == 3


def test_heartbeat_miss_budget_matches_jax():
    """ClusterControllerRole._heartbeat (the source of the miss budget
    the worker_death tests pre-load): polls that fail or answer with the
    wrong epoch count misses, HEARTBEAT_MISSES of them declare the role
    dead, a good poll resets, and the ratekeeper's qos is kept."""
    script = [  # per pass: role -> hosted epoch (None: the poll fails)
        {"resolver0": 3, "storage0": None, "ratekeeper0": 3},
        {"resolver0": 2, "storage0": None, "ratekeeper0": 3},
        {"resolver0": None, "storage0": None, "ratekeeper0": 3},
        {"resolver0": 3, "storage0": 3, "ratekeeper0": None},
        {"resolver0": None, "storage0": None, "ratekeeper0": None},
    ]
    out = {}
    for k, c in controllers({"resolvers": 1}).items():
        mp = PKG[k].mp
        c._needs_recovery = False
        c.assignments = {
            n: {"kind": n[:-1], "worker_id": f"w{i}",
                "address": f"/s/{n}.sock", "epoch": 3}
            for i, n in enumerate(("resolver0", "storage0", "ratekeeper0"))
        }
        step = {}

        async def fake_call(address, token, msg, *, timeout=30.0,
                            _mp=mp, _step=step):
            name = os.path.basename(address)[:-len(".sock")]
            epoch = _step["now"][name]
            if epoch is None:
                raise ConnectionError("refused")
            kind = name[:-1]
            return _mp.StatusReply(payload=json.dumps({
                "role": kind, "role_epochs": {kind: epoch},
                "qos": {"binding_streak": {"name": "workload",
                                           "intervals": epoch}}}))

        c._worker_call = fake_call
        passes = []
        for now in script:
            step["now"] = now
            passes.append((run(c._heartbeat()), dict(c._miss_counts),
                           c._rk_qos))
        out[k] = passes
    assert out["port"] == out["jax"]
    assert [p[0] for p in out["port"]] == [[], [], ["storage0"], [], []]


def _armed(c, *, name="resolver_busy", intervals=5, stale=False):
    c._needs_recovery = False
    c._rk_qos = {"binding_streak": {"name": name, "intervals": intervals},
                 "budget_stale": stale}


#: tests/test_elasticity.py's trigger tests as steps: (conf overrides,
#: steps), a step an `_armed` keyword dict, or ("recovering", reason)
ELASTIC = {
    "fires_and_re_derives_topology": ({}, [{}]),
    "requires_streak": ({}, [{"intervals": 2}]),
    "ignores_stale_feed": ({}, [{"stale": True}]),
    "ignores_unrelated_limiters": ({}, [
        {"name": n} for n in ("workload", "log_server_write_queue",
                              "ratekeeper_failsafe")]),
    "proxy_queue_limiter_recruits_a_proxy": ({}, [
        {"name": "commit_proxy_queue"},
        {"name": "commit_proxy_queue", "intervals": 50}]),
    "workload_streak_scales_down_elastic_role": (
        {"elastic_scale_down_streak": 3}, [
            {"name": "commit_proxy_queue"},
            {"name": "workload", "intervals": 2},
            {"name": "workload", "intervals": 3}]),
    "scale_down_never_cuts_below_declared_baseline": (
        {"resolvers": 2, "proxies": 2, "elastic_scale_down_streak": 2},
        [{"name": "workload", "intervals": 10}]),
    "scale_down_gate_cannot_chain_retires": (
        {"elastic_max_resolvers": 3, "elastic_scale_down_streak": 2}, [
            {"intervals": 3}, {"intervals": 6},
            {"name": "workload", "intervals": 2},
            {"name": "workload", "intervals": 3},
            {"name": "workload", "intervals": 4}]),
    "capped": ({"resolvers": 2}, [{}]),
    "disabled": ({"elastic": False}, [{}]),
    "skipped_during_recovery": ({}, [("recovering", "proxy0")]),
    "resolver_queue_limiter_also_triggers": ({}, [
        {"name": "resolver_queue"}]),
    "surviving_streak_cannot_chain_recruits": (
        {"elastic_max_resolvers": 3}, [
            {"intervals": 5}, {"intervals": 6}, {"intervals": 7},
            {"intervals": 8}]),
    "streak_reset_restores_normal_gate": (
        {"elastic_max_resolvers": 3}, [
            {"intervals": 10}, {"intervals": 1}, {"intervals": 3}]),
}


@pytest.mark.parametrize("name", list(ELASTIC))
def test_elastic_trigger_matches_jax(name):
    """tests/test_elasticity.py::test_elastic_* and ::test_*scale_down*
    (each case named after its source test): the same armed snapshots
    through both controllers, the state equal after every check."""
    overrides, steps = ELASTIC[name]
    conf = {"resolvers": 1, "elastic": True, "elastic_streak": 3,
            "elastic_max_resolvers": 2, **overrides}
    out = {}
    for k, c in controllers(conf).items():
        states = []
        for step in steps:
            if isinstance(step, tuple):
                _armed(c)
                c._needs_recovery = True
                c._recovery_reason = step[1]
            else:
                _armed(c, **step)
            c._elastic_check()
            states.append(ctrl_state(c))
        out[k] = states
    assert out["port"] == out["jax"]
    last = out["port"][-1]
    if name == "fires_and_re_derives_topology":
        assert last["reason"] == "elastic:resolver->2" and last["wake"]
    if name == "surviving_streak_cannot_chain_recruits":
        assert [s["elastic"][1] for s in out["port"]] == [1, 1, 1, 2]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_state_file_loads_across_packages(tmp_path, writer, reader):
    """tests/test_elasticity.py::test_persisted_topology_survives_
    controller_restart, the state file written by one package and loaded
    by the other: the persisted counts re-apply over the declared conf,
    the epoch is at least the persisted one, the baseline the declared."""
    sf = str(tmp_path / "controller_state.json")
    conf = {"resolvers": 1, "elastic": True, "elastic_streak": 3,
            "elastic_max_resolvers": 2}
    c = PKG[writer].mp.ClusterControllerRole(dict(conf), state_file=sf)
    _armed(c, name="commit_proxy_queue")
    c._elastic_check()
    c._persist_epoch(7)  # what the recovery walk does first
    with open(sf, "rb") as f:
        written = f.read()
    c2 = PKG[reader].mp.ClusterControllerRole(
        {"resolvers": 1, "elastic": True}, state_file=sf)
    assert c2.conf["proxies"] == 2
    assert c2._elastic_baseline["proxies"] == 1
    assert c2.gen.epoch >= 7
    assert c2._load_epoch() == 7
    # the other package writes the same bytes from the same state
    other = PKG["jax" if writer == "port" else "port"].mp
    c3 = other.ClusterControllerRole(dict(c.conf), state_file=sf + ".b")
    c3._persist_epoch(7)
    with open(sf + ".b", "rb") as f:
        assert f.read() == written
    # both begin the recovery walk above the persisted epoch
    assert c2.gen.begin_recovery(floor=c2._load_epoch()) == 8


def test_push_due_hysteresis_matches_jax():
    """tests/test_elasticity.py::test_push_due_hysteresis."""
    out = {}
    for k in PKG:
        rk = PKG[k].mp.RatekeeperRole([])
        seq = [rk._push_due()]
        info = rk.law.rate_info()
        rk._last_pushed = {
            "budget": info["transactions_per_second_limit"],
            "limiter": info["budget_limited_by"]["name"],
            "stale": bool(info["budget_stale"]),
        }
        seq.append(rk._push_due())
        b = rk._last_pushed["budget"]
        for factor in (1.0 - rk.push_threshold / 2, 0.5, 1.0):
            rk.law.tps_budget = b * factor
            seq.append(rk._push_due())
        rk.law.limited_by = dict(rk.law.limited_by, name="resolver_busy")
        seq.append(rk._push_due())
        out[k] = (seq, rk.push_threshold, rk.status()["qos"]["peers"])
    assert out["port"] == out["jax"]
    assert out["port"][0] == [True, False, False, True, False, True]


class _Conn:  # enough of an RpcConnection for construction
    pass


@pytest.mark.parametrize("push_epoch", [2, 3])
def test_rate_push_epoch_fence_matches_jax(push_epoch):
    """tests/test_elasticity.py::test_rate_push_epoch_fenced and
    ::test_proxy_rate_update_applies_and_clears_staleness."""
    out = {}
    for k in PKG:
        mp = PKG[k].mp
        pipe = mp.ProxyPipeline([_Conn()], _Conn(), _Conn(),
                                ratekeeper=_Conn(), epoch=3)
        pipe._rate_stale = True
        role = mp.ProxyRole.__new__(mp.ProxyRole)
        role.pipeline, role.epoch, role.stale_rate_pushes = pipe, 3, 0
        law = PKG[k].law(clock=time.monotonic, max_tps=5000.0)
        law.tps_budget = 42.0
        payload = json.dumps({**law.rate_info(), "epoch": push_epoch})
        try:
            got = run(role.rate_update(mp.RateUpdate(payload=payload)))
            got = ("ok", got.payload)
        except Exception as e:  # noqa: BLE001 - the class is the result
            got = (type(e).__name__, str(e))
        out[k] = (got, pipe._rate_limit, pipe._rate_stale,
                  role.stale_rate_pushes, pipe.rate_pushes_applied)
    assert out["port"] == out["jax"]
    if push_epoch == 2:
        assert out["port"][0][0] == "RemoteError"
        assert PG.is_stale_epoch(out["port"][0][1])
    else:
        assert out["port"][1:] == (42.0, False, 0, 1)


# ---------------------------------------------------------------------------
# the resolver's modelled compute


def _clipped_requests(p):
    """One request clipped at the two-resolver boundary: each resolver's
    part keeps the other's transactions as empty, slot-aligned rows."""
    txns = [
        p.types.CommitTransaction(read_conflict_ranges=[(b"a", b"b")]),
        p.types.CommitTransaction(),
        p.types.CommitTransaction(write_conflict_ranges=[(b"\xc0", b"\xd0")]),
        p.types.CommitTransaction(read_conflict_ranges=[(b"\x10", b"\xf0")],
                                  write_conflict_ranges=[(b"\x90", b"\x91")]),
    ]
    out = []
    for lo, hi in p.mp.resolver_key_ranges(
            p.mp.default_resolver_boundaries(2)):
        part = p.mp.clip_transactions(txns, lo, hi)
        req = p.types.ResolveTransactionBatchRequest(
            prev_version=-1, version=100, last_received_version=-1,
            transactions=part)
        out.append(req)
        out.append(p.codec.ResolveBatchColumnar(
            prev_version=-1, version=100, last_received_version=-1,
            cols=p.packing.pack_columnar(part)))
    return out


def test_local_txns_matches_jax():
    """tests/test_elasticity.py::test_local_txns_counts_partition_work, on
    requests clipped for two resolvers, object and columnar frames."""
    got = [PMP.ResolverRole.__new__(PMP.ResolverRole)._local_txns(r)
           for r in _clipped_requests(PKG["port"])]
    want = [JMP.ResolverRole.__new__(JMP.ResolverRole)._local_txns(r)
            for r in _clipped_requests(PKG["jax"])]
    assert got == want == [2, 2, 2, 2]


@pytest.mark.parametrize("cost", [0.0, 0.25])
def test_compute_cost_awaits_local_txns(monkeypatch, cost):
    """ResolverRole(compute_cost_per_txn=...): 0.0 awaits nothing; a cost
    awaits cost x the batch's local transactions, after the resolve."""
    slept = []

    async def fake_sleep(s):
        slept.append(s)

    role = PMP.ResolverRole(backend="cpu", compute_cost_per_txn=cost)
    assert role.compute_cost_per_txn == cost
    monkeypatch.setattr(PMP.asyncio, "sleep", fake_sleep)
    reqs = _clipped_requests(PKG["port"])
    reply = run(role.resolve(reqs[0]))
    assert len(reply.committed) == 4
    assert slept == ([] if cost == 0.0 else [cost * 2])


def test_role_kernel_launches_are_its_own_resolves(monkeypatch):
    """process_status()'s role_kernel_launches count the launches of the
    role's own resolves only: a role built after another keeps none of
    the launches the other makes later (a replaced resolver finishing a
    batch of its generation on the same worker), while kernel_launches
    stays the process's. The CPU launches nothing, so each resolve here
    counts one merge_maps, as a batch on the card's path would."""
    from foundationdb_tpu_torch import kernels

    plain = PMP.ResolverRole._resolve_now

    def launching(self, req):
        kernels.COUNTS["merge_maps"] += 1
        return plain(self, req)

    monkeypatch.setattr(PMP.ResolverRole, "_resolve_now", launching)
    monkeypatch.setitem(kernels.COUNTS, "merge_maps",
                        kernels.COUNTS["merge_maps"])

    def req(v):
        return PT.ResolveTransactionBatchRequest(
            prev_version=v - 100 if v > 100 else -1, version=v,
            last_received_version=-1, transactions=[])

    old = PMP.ResolverRole(backend="cpu")
    run(old.resolve(req(100)))
    new = PMP.ResolverRole(backend="cpu")
    assert new.process_status()["role_kernel_launches"] == {}
    run(old.resolve(req(200)))
    run(new.resolve(req(100)))
    run(old.resolve(req(300)))
    start = kernels.COUNTS["merge_maps"] - 4
    assert old.process_status()["role_kernel_launches"] == {"merge_maps": 3}
    st = new.process_status()
    assert st["role_kernel_launches"] == {"merge_maps": 1}
    assert st["kernel_launches"]["merge_maps"] == start + 4


# ---------------------------------------------------------------------------
# a worker's roles


def test_worker_init_role_matches_jax(tmp_path):
    """WorkerRole.init_role for each kind on the JAX package's specs:
    the replies and the worker's status equal JAX's (the resolver on the
    C++ skip list in both), and a role replaced at a newer epoch."""
    specs = [
        {"kind": "tlog", "epoch": 2, "data_dir": "tl", "partitioned": True},
        {"kind": "sequencer", "epoch": 2, "recovery_version": 5_000_000,
         "n_tags": 2},
        {"kind": "storage", "epoch": 2, "data_dir": "st"},
        {"kind": "resolver", "epoch": 2, "backend": "native"},
        {"kind": "resolver", "epoch": 3, "backend": "native",
         "compute_cost_per_txn": 0.5},
    ]
    out = {}
    for k in PKG:
        mp = PKG[k].mp
        w = mp.WorkerRole("w0", str(tmp_path / f"{k}.sock"))
        replies = []

        async def go(_w=w, _mp=mp, _k=k):
            for spec in specs:
                spec = dict(spec)
                if "data_dir" in spec:
                    spec["data_dir"] = str(tmp_path / f"{_k}-{spec['data_dir']}")
                rep = await _w.init_role(_mp.InitializeRole(
                    payload=json.dumps(spec)))
                replies.append(json.loads(rep.payload))
            st = _w.status()
            await _w.stop()
            return st

        st = run(go())
        out[k] = (replies, {key: st[key] for key in (
            "worker_id", "hosted", "role_epochs", "initializations",
            "idle")},
            sorted(st["qos"]["hosted"]))
        assert w.roles == {}
    assert out["port"] == out["jax"]
    assert out["port"][1]["role_epochs"] == {
        "tlog": 2, "sequencer": 2, "storage": 2, "resolver": 3}


def test_worker_cuda_resolver_without_a_card_fails_its_recruit(tmp_path):
    """A "cuda" resolver with no device asks for the card: on a host
    without one the recruit fails, nothing is hosted, and nothing falls
    back to the CPU. With device "cpu" (the worker's own, or the spec's)
    it is the plain versions."""
    w = PMP.WorkerRole("w0", str(tmp_path / "w.sock"))
    spec = {"kind": "resolver", "epoch": 1, "backend": "cuda",
            "resolver_kernel": SMALL_KERNEL}
    if not torch.cuda.is_available():
        with pytest.raises(Exception):
            run(w.init_role(PMP.InitializeRole(payload=json.dumps(spec))))
        assert w.roles == {}
    for worker_dev, spec_dev in (("cpu", None), (None, "cpu")):
        w = PMP.WorkerRole("w0", str(tmp_path / "w.sock"), device=worker_dev)
        s = dict(spec, **({"device": spec_dev} if spec_dev else {}))
        run(w.init_role(PMP.InitializeRole(payload=json.dumps(s))))
        assert w.role("resolver").process_status()["conflict_set"] == {
            "class": "TorchConflictSet", "device": "cpu"}
        assert w.status()["role_epochs"] == {"resolver": 1}


def recovery_walk(k: str, conf: dict, survivors: dict) -> tuple:
    """ClusterControllerRole._recover through one package, its worker
    calls answered by stubs: each call's encoded frame (byte-identical
    across packages for equal messages) and each recruit's spec, in
    order, with the state and topology it leaves."""
    mp, codec = PKG[k].mp, PKG[k].codec
    c = mp.ClusterControllerRole(dict(conf))
    for i in range(12):
        beacon(c, f"w{i}", survivors.get(f"w{i}"))
    calls = []

    async def fake_call(address, token, msg, *, timeout=30.0):
        calls.append(("call", address, token, codec.encode(msg)))
        if token == mp.TOKEN_TLOG_LOCK:
            return mp.TLogLockReply(epoch=msg.epoch,
                                    durable_version=4_000 + len(calls))
        if token == mp.TOKEN_SEQUENCER_VERSION:
            return mp.RoleVersionReply(version=9_000)
        if token == mp.TOKEN_STORAGE_CATCHUP:
            return mp.StorageCatchUpReply(version=3_000)
        return None

    async def fake_init(place, spec, *, timeout=120.0):
        calls.append(("init", dict(place), spec))
        return {"ok": True, "recovered": True}

    c._worker_call, c._init_role = fake_call, fake_init
    run(c._recover())
    return calls, ctrl_state(c), c.topology_doc(), [
        r["status"] for r in c.gen.timeline_dicts()]


@pytest.mark.parametrize("case", ["one", "scale_out", "survivors"])
def test_recovery_walk_matches_jax(case):
    """The recovery walk of tests/test_lifecycle.py::test_controller_
    recruits_and_recovers_from_kill (one resolver; and the scale-out
    topology of scripts/bench_pipeline.py's two proxies and two
    resolvers, with survivors re-adopted from their beacons): the same
    calls, recruits, state and topology, for a conf naming the backend
    ("native", JAX's default)."""
    conf = {"resolvers": 1, "backend": "native", "ratekeeper": False,
            "tlog_data_dir": "/d/tlog", "storage_data_dir": "/d/storage"}
    survivors = {}
    if case != "one":
        conf.update(resolvers=2, proxies=2, tlogs=2, ratekeeper=True)
    if case == "survivors":
        survivors = {"w0": {"tlog": 1}, "w1": {"tlog": 1},
                     "w2": {"storage": 1}, "w5": {"ratekeeper": 1}}
    port = recovery_walk("port", conf, survivors)
    jax = recovery_walk("jax", conf, survivors)
    assert port == jax
    calls, state, topo, walk = port
    assert walk[-len(PG.RECOVERY_STATES):] == list(PG.RECOVERY_STATES)
    assert topo["state"] == PG.FULLY_RECOVERED and state["epoch"] == 1
    kinds = [x[1]["kind"] for x in calls if x[0] == "init"]
    assert kinds.count("resolver") == conf["resolvers"]
    assert kinds[-1] == "proxy"


@pytest.mark.parametrize("conf,want", [
    ({}, {"backend": "cuda"}),
    ({"device": "cpu"}, {"backend": "cuda", "device": "cpu"}),
    ({"backend": "cpu", "device": "cpu"}, {"backend": "cpu",
                                            "device": "cpu"}),
    ({"backend": "native"}, {"backend": "native"}),
])
def test_resolver_spec_names_the_port_backend_and_device(conf, want):
    """The port's two differences in the walk: the resolver spec's
    backend defaults to "cuda" (JAX: "native") and a conf `device` rides
    in it; everything else in the walk is JAX's (the same walk with the
    backend and device taken out of the specs)."""
    base = {"resolvers": 2, "ratekeeper": False, **conf}
    port = recovery_walk("port", base, {})
    jax = recovery_walk("jax", {k: v for k, v in base.items()
                                if k != "device"}, {})
    specs = [x[2] for x in port[0] if x[0] == "init"
             and x[1]["kind"] == "resolver"]
    assert len(specs) == 2
    for spec in specs:
        assert {k: spec.get(k) for k in want} == want
        assert ("device" in spec) == ("device" in conf)

    def strip(walk):
        calls = [x if x[0] != "init" or x[1]["kind"] != "resolver"
                 else ("init", x[1], {k: v for k, v in x[2].items()
                                      if k not in ("backend", "device")})
                 for x in walk[0]]
        state = dict(walk[1], conf={k: v for k, v in walk[1]["conf"].items()
                                    if k != "device"})
        return calls, state, walk[2], walk[3]

    assert strip(port) == strip(jax)


# ---------------------------------------------------------------------------
# sim / wire recovery parity


@pytest.fixture(scope="module")
def sim_decisions():
    from test_lifecycle import _inflight_set, _sim_recovery_decisions

    return _sim_recovery_decisions(_inflight_set)


@pytest.mark.parametrize("backend", ["cuda", "native", "cpu"])
def test_sim_wire_recovery_parity(sim_decisions, monkeypatch, backend):
    """tests/test_lifecycle.py::test_sim_wire_recovery_parity: the JAX sim
    recovery's decisions on an in-flight set, against a freshly recruited
    port ResolverRole (empty state, epoch 2) fed the controller's boot
    batch, the conservative recovery transaction and then the same set."""
    from test_lifecycle import _inflight_set

    decisions, _rv = sim_decisions
    monkeypatch.setenv("RESOLVER_KERNEL", SMALL_KERNEL)
    role = PMP.ResolverRole(backend=backend, epoch=2, device="cpu")
    recovery_version = 2_000_000
    stale_rv, fresh_rv = 1_000, recovery_version + 1_000

    async def wire():
        await role.resolve(PT.ResolveTransactionBatchRequest(
            prev_version=-1, version=recovery_version,
            last_received_version=-1, epoch=2))
        rep = await role.resolve(PT.ResolveTransactionBatchRequest(
            prev_version=recovery_version,
            version=recovery_version + 1_000,
            last_received_version=recovery_version, epoch=2,
            transactions=[
                PG.conservative_recovery_transaction(recovery_version)]))
        assert rep.committed[0] == PT.TransactionResult.COMMITTED
        rep = await role.resolve(PT.ResolveTransactionBatchRequest(
            prev_version=recovery_version + 1_000,
            version=recovery_version + 2_000,
            last_received_version=recovery_version + 1_000, epoch=2,
            transactions=[PT.CommitTransaction(
                read_conflict_ranges=t.read_conflict_ranges,
                write_conflict_ranges=t.write_conflict_ranges,
                read_snapshot=t.read_snapshot)
                for t in _inflight_set(stale_rv, fresh_rv)]))
        return ["commit" if v == PT.TransactionResult.COMMITTED else "abort"
                for v in rep.committed]

    assert run(wire()) == decisions == [
        "abort", "commit", "abort", "commit", "commit", "abort"]
    if backend == "cuda":
        assert type(role._cs).__name__ == "TorchConflictSet"
