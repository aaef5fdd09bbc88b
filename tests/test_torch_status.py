"""The port's status document (`cluster/status.py`) held against the JAX
package's on the CPU.

* `assemble_status`, `qos_section`, `performance_limited_by` and
  `sampling_rollup` on seeded role blocks: equal.
* `cluster_status` of the port's simulated cluster against JAX's on the
  same scenarios (`tests/test_torch_sim_cluster.py`'s harness: four of
  its scenarios on the host oracle, "cpu" in both, and one on the kernel
  path, the port's "cuda" with device="cpu" against JAX "tpu-force").
  Equal, once two kinds of fields are set apart:
  - the wall clock's and the process's: `run_loop`, `census`, every
    seconds sample (`*Seconds`, `*_seconds*`), `compile_cache` and the
    kernel block's `compile_cache_hits` / `_misses` (process-wide
    counters that gather over every test the process ran) differ between
    two runs of one package; they are compared by their keys and types;
  - the port's differences, each named in `PORT_DIFFERENCES` and
    checked to hold: `configuration.resolver_backend` is the port's
    backend name, `resolver_kernel.*.backend` and `processes.*.kernel`
    report `TorchConflictSet` and the port's KernelStageMetrics (its
    `fixpoint` block), and `compile_cache` has no XLA compile counters.
* The sim client's `\\xff\\xff/status/json` serves that document.
* `wire_cluster_status` over stub role connections: JAX's document.
"""

from __future__ import annotations

import asyncio
import copy
import json
import os
import re
import shutil
import tempfile

import numpy as np
import pytest

from foundationdb_tpu.cluster import multiprocess as JMP
from foundationdb_tpu.cluster import status as JS
from foundationdb_tpu.wire import transport as JTR
from foundationdb_tpu_torch.cluster import multiprocess as PMP
from foundationdb_tpu_torch.cluster import status as PS
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.wire import transport as PTR

import test_torch_sim_cluster as SC  # the sim harness

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# ---------------------------------------------------------------------------
# the assembly functions on seeded role blocks


def seeded_processes(seed: int) -> dict:
    """Role blocks of every kind the assembly reads, with seeded sensor
    readings (some keys left out: partial blocks degrade, never raise)."""
    g = np.random.default_rng(seed)

    def f(hi):
        return float(np.round(g.random() * hi, 6))

    def tag_row():
        return {"tag": f"t{int(g.integers(0, 4))}",
                "bytes_per_s": f(5000.0), "frac": f(1.0)}

    procs = {}
    for i in range(int(g.integers(1, 4))):
        procs[f"tlog{i}"] = {"role": "log", "version": int(g.integers(0, 10**7)),
                             "qos": {"queue_bytes": int(g.integers(0, 1 << 27)),
                                     "smoothed_queue_bytes": f(1 << 27),
                                     "durability_lag_versions":
                                         int(g.integers(0, 10**6))}}
    for i in range(int(g.integers(1, 4))):
        q = {"busiest_read_tag": tag_row(), "busiest_write_tag": tag_row(),
             "hot_ranges": [{"range": f"r{int(g.integers(0, 3))}",
                             "begin": "a%d" % int(g.integers(0, 9)),
                             "end": "z%d" % int(g.integers(0, 9)),
                             "bytes": int(g.integers(0, 10**6)),
                             "keys": int(g.integers(0, 100))}
                            for _ in range(int(g.integers(0, 4)))]}
        if g.random() < 0.5:
            q["version_lag_versions"] = int(g.integers(0, 4 * 10**6))
        procs[f"storage{i}"] = {"role": "storage",
                                "version": int(g.integers(0, 10**7)),
                                "qos": q}
    for i in range(int(g.integers(1, 4))):
        procs[f"resolver{i}"] = {"role": "resolver",
                                 "qos": {"queue_depth": int(g.integers(0, 12)),
                                         "occupancy": f(1.2)}}
    for i in range(int(g.integers(1, 3))):
        procs[f"proxy{i}"] = {"role": "commit_proxy",
                              "committed_version": int(g.integers(0, 10**7)),
                              "qos": {"queued_requests":
                                      int(g.integers(0, 6000)),
                                      "busiest_write_tag": tag_row()}}
    procs["grv_proxy0"] = {"role": "grv_proxy",
                           "qos": {"queued_requests": int(g.integers(0, 6000))}}
    if g.random() < 0.5:
        procs["ratekeeper0"] = {"role": "ratekeeper",
                                "qos": {"transactions_per_second_limit":
                                        f(10**5), "budget_stale": False}}
    procs["odd"] = {"role": "worker", "idle": True}
    return procs


@pytest.mark.parametrize("seed", range(8))
def test_assembly_matches_jax(seed):
    procs = seeded_processes(seed)
    extra = {"note": seed}
    got = PS.assemble_status(copy.deepcopy(procs), lag_target=1.5e6,
                             cluster_extra=dict(extra))
    want = JS.assemble_status(copy.deepcopy(procs), lag_target=1.5e6,
                              cluster_extra=dict(extra))
    assert got == want
    slots = {k: {} for k in ("tlogs", "storages", "resolvers", "proxies",
                             "grvs")}
    for name, b in procs.items():
        slot = JS._QOS_SLOT.get(b["role"])
        if slot:
            slots[slot][name] = b["qos"]
    args = [slots[k] for k in ("tlogs", "storages", "resolvers", "proxies",
                               "grvs")]
    rk = {"transactions_per_second_limit": 1234.0}
    for lag in (1.0, 2e6):
        assert (PS.qos_pressures(*args, lag_target=lag)
                == JS.qos_pressures(*args, lag_target=lag))
        assert (PS.qos_section(*args, lag_target=lag, ratekeeper=rk)
                == JS.qos_section(*args, lag_target=lag, ratekeeper=rk))
    cands = PS.qos_pressures(*args, lag_target=2e6)
    assert PS.performance_limited_by(cands) == JS.performance_limited_by(cands)
    assert (PS.sampling_rollup(slots["storages"], slots["proxies"])
            == JS.sampling_rollup(slots["storages"], slots["proxies"]))
    assert PS.QOS_REASONS == JS.QOS_REASONS
    assert PS._QOS_SLOT == JS._QOS_SLOT
    for k in ("TLOG_QUEUE_BYTES_TARGET", "RESOLVER_QUEUE_TARGET",
              "PROXY_QUEUE_TARGET", "GRV_QUEUE_TARGET"):
        assert getattr(PS, k) == getattr(JS, k)


# ---------------------------------------------------------------------------
# cluster_status of the simulated cluster

#: the port's differences from the JAX document, each a path pattern and
#: the rule its values follow (checked, then set apart)
PORT_DIFFERENCES = {
    # the port's backend names ("cuda", "cpu"); JAX writes its knob's
    # ("tpu-force", "cpu"; "tpu" when unset)
    r"^cluster/configuration/resolver_backend$":
        lambda p, j: (p, j) in {("cuda", "tpu-force"), ("cpu", "cpu")},
    # the conflict set's class: TorchConflictSet where JAX has
    # TpuConflictSet
    r"^cluster/(resolver_kernel/resolver\d+|processes/resolver\d+/kernel)"
    r"/backend$":
        lambda p, j: (p, j) == ("TorchConflictSet", "TpuConflictSet"),
    # the port's KernelStageMetrics: its fixpoint block, JAX has none
    r"^cluster/(resolver_kernel/resolver\d+|processes/resolver\d+/kernel)"
    r"/fixpoint$": lambda p, j: isinstance(p, dict) and j is MISSING,
    # the port's compile cache has no XLA backend-compile counters
    r"^cluster/compile_cache/(backend_compiles|compile_seconds_total)$":
        lambda p, j: p is MISSING and j is not MISSING,
}

#: the wall clock's fields, and the process's (the compile cache's
#: counters and signatures gather over every test the process ran, the
#: kernel block's `compile_cache_hits` / `_misses` too: JAX's
#: `compile_cache.stats()` and the port's `kernels.build_stats()` are
#: process-wide, and JAX's count only once an earlier test in the
#: process turned its persistent cache on): compared by their keys and
#: types only
WALL_CLOCK = re.compile(
    r"^cluster/(run_loop|census|compile_cache)(/|$)|Seconds(/|$)|_seconds"
    r"|/compile_cache_(hits|misses)$")
#: of those, the dicts whose keys are the wall clock's or the process's
#: too (the actors that ran slow, the signatures compiled): their type
PROCESS_DICTS = re.compile(r"^cluster/(compile_cache/"
                           r"per_signature_compile_seconds|"
                           r"run_loop/slow_tasks_by_actor)$")

MISSING = object()


def split(port, jax, path="", named=None, wall=None):
    """Walk both documents; return (port, jax) with the named
    differences and the wall clock's values taken out, recording each
    named difference's path in `named` and each wall-clock path in
    `wall`."""
    if isinstance(port, dict) and isinstance(jax, dict):
        p, j = {}, {}
        for k in sorted(set(port) | set(jax)):
            sub = f"{path}/{k}" if path else k
            pv, jv = port.get(k, MISSING), jax.get(k, MISSING)
            rule = next((r for pat, r in PORT_DIFFERENCES.items()
                         if re.search(pat, sub)), None)
            if rule is not None and (pv is MISSING or jv is MISSING
                                     or pv != jv):
                assert rule(pv, jv), (sub, pv, jv)
                named.add(re.sub(r"\d+", "N", sub))
                continue
            if WALL_CLOCK.search(sub) and pv is not MISSING \
                    and jv is not MISSING:
                wall.add(re.sub(r"\d+", "N", sub))
                if isinstance(pv, dict) and isinstance(jv, dict) \
                        and not PROCESS_DICTS.search(sub):
                    p[k], j[k] = split(pv, jv, sub, named, wall)
                else:
                    p[k] = j[k] = type(pv).__name__
                    assert type(pv) is type(jv) or {type(pv), type(jv)} <= {
                        int, float}, sub
                continue
            if pv is MISSING or jv is MISSING:
                p[k], j[k] = pv is MISSING, jv is MISSING
            else:
                p[k], j[k] = split(pv, jv, sub, named, wall)
        return p, j
    if isinstance(port, list) and isinstance(jax, list) \
            and len(port) == len(jax):
        pairs = [split(a, b, f"{path}[{i}]", named, wall)
                 for i, (a, b) in enumerate(zip(port, jax))]
        return [a for a, _ in pairs], [b for _, b in pairs]
    return port, jax


def first_difference(a, b, path: str = "") -> str:
    """The first path (in sorted key order) where `a` and `b` differ,
    with both values: the message of a whole-document assert."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=str):
            sub = f"{path}/{k}" if path else str(k)
            if k not in a or k not in b:
                return (f"{sub}: only in "
                        f"{'the first' if k in a else 'the second'}: "
                        f"{(a.get(k) if k in a else b.get(k))!r}")
            if a[k] != b[k]:
                return first_difference(a[k], b[k], sub)
    elif isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return first_difference(x, y, f"{path}[{i}]")
    return f"{path or '<root>'}: {a!r} != {b!r}"


def status_of(pkg: str, backend: str, scn) -> dict:
    P = SC.ns(pkg)
    kw = dict(scn.config(P), resolver_backend=backend)
    if pkg == SC.PORT:
        kw["device"] = "cpu"
    sched, cluster, db = P.database.open_cluster(
        P.database.ClusterConfig(**kw))
    try:
        scn.body(P, sched, cluster, db)
        doc = (PS if pkg == SC.PORT else JS).cluster_status(cluster)
        # the sim client's special key serves the same document
        served = json.loads(db.special_key(b"\xff\xff/status/json"))
        return json.loads(json.dumps(doc)), served
    finally:
        cluster.stop()


STATUS_SCENARIOS = ["cluster_basics", "ratekeeper_throttle",
                    "tlog_crash_reboot", "atomic_ops"]


@pytest.mark.parametrize("name,backend", [
    *((n, "cpu") for n in STATUS_SCENARIOS),
    ("atomic_ops", "cuda"),
])
def test_cluster_status_matches_jax(name, backend):
    scn = next(s for s in SC.SCENARIOS if s.name == name)
    jax_backend = {"cuda": "tpu-force", "cpu": "cpu"}[backend]
    port, port_served = status_of(SC.PORT, backend, scn)
    jax, jax_served = status_of(SC.JAX, jax_backend, scn)
    named, wall = set(), set()
    p, j = split(port, jax, named=named, wall=wall)
    assert p == j, "port != jax at " + first_difference(p, j)
    assert "cluster/run_loop/wall_seconds" in wall
    assert "cluster/configuration/resolver_backend" in named or \
        backend == "cpu"
    if backend == "cuda":
        assert named >= {
            "cluster/configuration/resolver_backend",
            "cluster/resolver_kernel/resolverN/backend",
            "cluster/resolver_kernel/resolverN/fixpoint",
        }
    # the served document is the same document, a moment later
    for doc, served in ((port, port_served), (jax, jax_served)):
        a, b = split(served, doc, named=set(), wall=set())
        assert a == b, "served != document at " + first_difference(a, b)


def test_status_document_shape():
    """The port's document carries every section of the reference
    schema JAX's does, and its configuration names the port's backend."""
    scn = next(s for s in SC.SCENARIOS if s.name == "atomic_ops")
    doc, _ = status_of(SC.PORT, "cuda", scn)
    c = doc["cluster"]
    assert c["configuration"]["resolver_backend"] == "cuda"
    assert {r["backend"] for r in c["resolver_kernel"].values()} == {
        "TorchConflictSet"}
    assert set(c) >= {"configuration", "qos", "processes", "latency_bands",
                      "workload", "run_loop", "census", "compile_cache",
                      "busiest_tags", "hot_ranges", "latest_version"}
    assert c["qos"]["performance_limited_by"]["name"] in PS.QOS_REASONS


# ---------------------------------------------------------------------------
# the wire assembly over stub role connections


def test_wire_cluster_status_matches_jax():
    procs = seeded_processes(99)
    d = tempfile.mkdtemp(prefix="st")

    async def scenario():
        servers = {}
        for name, block in procs.items():
            srv = JTR.RpcServer(os.path.join(d, f"{name}.sock"))

            async def status(_req, _b=block):
                return JMP.StatusReply(payload=json.dumps(_b))

            srv.register(JMP.TOKEN_STATUS, status)
            await srv.start()
            servers[name] = srv
        docs = []
        try:
            for mp, tr in ((PMP, PTR), (JMP, JTR)):
                conns = {}
                for name in procs:
                    c = tr.RpcConnection(os.path.join(d, f"{name}.sock"))
                    await c.connect()
                    conns[name] = c
                docs.append(await mp.wire_cluster_status(
                    conns, lag_target=1e6))
                for c in conns.values():
                    await c.close()
            # a dead role is named, in both
            dead = os.path.join(d, "storage0.sock")
            await servers.pop("storage0").close()
            for mp, tr in ((PMP, PTR), (JMP, JTR)):
                c = tr.RpcConnection(dead)
                with pytest.raises(Exception):
                    await c.connect(retries=1)
                    await mp.wire_cluster_status({"storage0": c})
        finally:
            for srv in servers.values():
                await srv.close()
        return docs

    try:
        port, jax = run(scenario())
    finally:
        shutil.rmtree(d, ignore_errors=True)
    assert port == jax
    assert port["cluster"]["processes"].keys() == procs.keys()
