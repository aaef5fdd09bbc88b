"""The port's operator drills (`foundationdb_tpu_torch/drills/fdbtop.py`,
`chaos.py`, `elasticity.py`) against the JAX package's scripts
(`scripts/fdbtop.py`, `chaos_pipeline.py`, `elasticity_drill.py`).

* fdbtop, twins of tests/test_fdbtop.py:232, :360, :382, :501, :520: one
  status document through both packages' `check_status` gives the same
  verdict (healthy, and each broken variant naming the same problems)
  and through both `render`s the same text, for a sim document of each
  package; both `_poll_wire`s over the port's role processes and a
  pipeline's status socket give documents the gate passes with the same
  processes; `--sim --once --json` runs as a command; the census gate
  and columns agree; `--smoke` and `--autotune` raise, naming what they
  still need.
* chaos and elasticity: `_write_confs` writes JAX's files but for the
  conf's `backend` ("cuda", the card, where JAX writes "native"); one
  chaos `--smoke` on the port's processes with `--backend cpu` (the host
  oracle): a resolver's worker SIGKILLed, a newer fully recovered
  generation found by the monitor's push, every acknowledged key read
  back, the recovery timeline from the controller's trace file, the
  persisted 2-proxy topology, its ledger row, FDBTPU_CONTROLLER_TRACE
  restored; without a card the default "cuda" backend fails the
  recruit and the drill raises.
* The elasticity drill in both directions is gated on wall-clock
  goodput ratios (1.5x ON, <= 1.25x OFF) that a shared host's load
  moves, so that test is marked slow. On the CPU its ON gate measures
  the recruit's commit stall rather than the scale, and the port's
  recruit stalls nothing there, so it is also marked xfail with that
  cause (`tests/elastic_timeline.py` prints both drills' timelines).

Each test has a wall limit (tests/time_limit.py). The spawned children
run with one intra-op thread (OMP_NUM_THREADS=1).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

from foundationdb_tpu.cluster.database import ClusterConfig as JClusterConfig
from foundationdb_tpu.cluster.database import open_cluster as jopen_cluster
from foundationdb_tpu.cluster.status import cluster_status as jcluster_status
from foundationdb_tpu_torch.cluster import multiprocess as mp
from foundationdb_tpu_torch.drills import chaos
from foundationdb_tpu_torch.drills import elasticity
from foundationdb_tpu_torch.drills import fdbtop as pfdbtop
from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import perf
from foundationdb_tpu_torch.wire.codec import Mutation

from time_limit import limit_each_test

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import chaos_pipeline as jchaos  # noqa: E402
import elasticity_drill as jelastic  # noqa: E402
import fdbtop as jfdbtop  # noqa: E402

_time_limit = limit_each_test(240)

REQUIRE = ["log", "storage", "resolver", "commit_proxy", "grv_proxy",
           "ratekeeper", "sequencer"]


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@pytest.fixture
def sock_dir():
    # a short path: a Unix socket's holds at most 107 bytes
    d = tempfile.mkdtemp(prefix="od")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


# ---------------------------------------------------------------------------
# fdbtop


def _good_status() -> dict:
    """tests/test_fdbtop.py:236-318's healthy document."""
    none_tag = {"tag": None, "bytes_per_s": 0.0, "frac": 0.0}
    return {"cluster": {
        "qos": {"performance_limited_by": {"name": "workload"}},
        "busiest_tags": [],
        "hot_ranges": [],
        "processes": {
            "tlog0": {"role": "log", "qos": {
                "queue_bytes": 0, "smoothed_queue_bytes": 0.0,
                "input_bytes_per_s": 0.0}},
            "storage0": {"role": "storage", "qos": {
                "version_lag_versions": 0, "input_bytes_per_s": 0.0,
                "sampled_bytes": 0, "sample_keys": 0, "hot_ranges": [],
                "busiest_read_tag": dict(none_tag),
                "busiest_write_tag": dict(none_tag)}},
            "resolver0": {"role": "resolver", "qos": {
                "queue_depth": 0, "queue_wait_dist": {},
                "compute_time_dist": {}, "occupancy": 0.0,
                "kernel": {"compile_cache_hits": 0,
                           "compile_cache_misses": 0,
                           "last_compile_seconds": 0.0,
                           "stage_p99_seconds": {}, "shards": 1,
                           "worst_shard_delta_occupancy": 0.0,
                           "worst_shard_main_occupancy": 0.0,
                           "collective_time_share": 0.0,
                           "spills": 0, "sweep_groups": 0},
                "key_sample": {"keys": 0, "top": []}}},
            "proxy0": {"role": "commit_proxy", "qos": {
                "queued_requests": 0, "inflight_batches": 0,
                "batch_sizer": {}, "version_grants": 0,
                "tag_partitioned": False,
                "busiest_write_tag": dict(none_tag)}},
            "sequencer0": {"role": "sequencer", "qos": {
                "grants": 0, "grants_per_s": 0.0,
                "live_committed_version": 0, "tags": 2,
                "proxies_seen": 2}},
            "grv_proxy0": {"role": "grv_proxy", "qos": {
                "queued_requests": 0, "sheds": 0, "budget_stale": False}},
            "ratekeeper0": {"role": "ratekeeper", "qos": {
                "transactions_per_second_limit": 1e7,
                "budget_limited_by": {"name": "workload"},
                "binding_streak": {"name": "workload", "intervals": 1},
                "budget_stale": False}},
        },
    }}


def _drop(path: tuple):
    def mutate(doc):
        node = doc
        for part in path[:-1]:
            node = node[part]
        del node[path[-1]]
    return mutate


P = ("cluster", "processes")
BROKEN = {
    "healthy": lambda doc: None,
    "missing role": _drop(P + ("resolver0",)),
    "empty qos": lambda doc: doc["cluster"]["processes"]["tlog0"].update(
        qos={}),
    "missing sensor": _drop(P + ("proxy0", "qos", "batch_sizer")),
    "missing grants": _drop(P + ("proxy0", "qos", "version_grants")),
    "sequencer surface": _drop(P + ("sequencer0", "qos", "proxies_seen")),
    "dotted sensor": _drop(P + ("resolver0", "qos", "kernel", "shards")),
    "no limiter": lambda doc: doc["cluster"].update(qos={}),
    "sampling sensor": _drop(P + ("storage0", "qos", "busiest_read_tag")),
    "key sample": _drop(P + ("resolver0", "qos", "key_sample")),
    "skew rollup": _drop(("cluster", "busiest_tags")),
}


@pytest.mark.parametrize("case", list(BROKEN))
def test_fdbtop_check_status_gate_both_directions(case):
    doc = _good_status()
    BROKEN[case](doc)
    got = pfdbtop.check_status(doc, REQUIRE)
    assert got == jfdbtop.check_status(doc, REQUIRE)
    assert bool(got) == (case != "healthy")
    assert pfdbtop.REQUIRED_SENSORS == jfdbtop.REQUIRED_SENSORS
    assert pfdbtop.CENSUS_SENSORS == jfdbtop.CENSUS_SENSORS
    assert pfdbtop.HEADLINE == jfdbtop.HEADLINE


def _port_sim_status() -> dict:
    world = pfdbtop._SimWorld(seed=0, backend="cpu")
    try:
        return world.poll()
    finally:
        world.stop()


def _jax_sim_status() -> dict:
    sched, cluster, db = jopen_cluster(JClusterConfig(
        n_commit_proxies=2, n_resolvers=2, n_storage=2, n_tlogs=2))

    async def body():
        for i in range(25):
            txn = db.create_transaction()
            txn.set(b"sat%03d" % i, b"v" * 64)
            await txn.commit()

    sched.run_until(sched.spawn(body()).done)
    status = jcluster_status(cluster)
    cluster.stop()
    return status


@pytest.mark.parametrize("source", ["port", "jax"])
def test_fdbtop_render_sim_status(source):
    status = _port_sim_status() if source == "port" else _jax_sim_status()
    frames = []
    for top in (jfdbtop, pfdbtop):
        histories = {}
        out1 = top.render(status, histories, 0.0)
        out2 = top.render(status, histories, 1.0)
        assert all(len(h) == 2 for h in histories.values())
        frames.append((out1, out2))
    assert frames[1] == frames[0]
    out1, out2 = frames[1]
    for name in status["cluster"]["processes"]:
        assert name in out1
    assert "limited by" in out1 and "run loop" in out1
    assert "▁" in out2
    assert pfdbtop.check_status(status, REQUIRE[:5]) == []


def test_wire_status_and_fdbtop_poll(sock_dir, one_thread_children):
    """Both packages' `_poll_wire` over the port's resolver, tlog and
    storage processes and a port pipeline's status socket."""
    d = sock_dir
    procs = [mp.spawn_role("resolver", d, backend="cpu"),
             mp.spawn_role("tlog", d), mp.spawn_role("storage", d)]

    async def scenario():
        resolver, tlog, storage = [
            await mp.connect(p.address, proc=p) for p in procs]
        pipe = mp.ProxyPipeline([resolver], tlog, storage,
                                batch_interval=0.001)
        pipe.start()
        server = mp.serve_status(d, pipe)
        await server.start()
        try:
            for i in range(20):
                k = b"w%02d" % i
                rv = await pipe.get_read_version()
                await pipe.commit(CommitTransaction(
                    read_conflict_ranges=[(k, k + b"\x00")],
                    write_conflict_ranges=[(k, k + b"\x00")],
                    read_snapshot=rv,
                    mutations=[Mutation(0, k, b"v" * 32)],
                ))
            docs = []
            for top in (jfdbtop, pfdbtop):
                conns = {}
                try:
                    docs.append(await top._poll_wire(d, conns))
                finally:
                    await top._close_conns(conns)
            return docs
        finally:
            await pipe.stop()
            await server.close()
            for c in (resolver, tlog, storage):
                await c.close()

    try:
        jdoc, pdoc = run(scenario())
    finally:
        for p in procs:
            p.stop()
    require = REQUIRE[:5]
    for doc in (jdoc, pdoc):
        assert jfdbtop.check_status(doc, require, census=True) == []
        assert pfdbtop.check_status(doc, require, census=True) == []
        json.dumps(doc)
    procs_seen = {n: b["role"] for n, b in
                  pdoc["cluster"]["processes"].items()}
    assert procs_seen == {n: b["role"] for n, b in
                          jdoc["cluster"]["processes"].items()}
    assert set(procs_seen.values()) == {"resolver", "log", "storage",
                                        "commit_proxy", "grv_proxy"}
    assert pdoc["cluster"]["processes"]["tlog0"]["version"] > 0


def test_fdbtop_sim_once_json_smoke():
    out = subprocess.run(
        [sys.executable, "-m", "foundationdb_tpu_torch.drills.fdbtop",
         "--sim", "--once", "--json", "--backend", "cpu",
         "--require", ",".join(REQUIRE[:5])],
        capture_output=True, text=True, timeout=180, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    assert "performance_limited_by" in doc["cluster"]["qos"]
    assert jfdbtop.check_status(doc, REQUIRE[:5]) == []
    assert pfdbtop.check_status(doc, REQUIRE[:5]) == []


def test_fdbtop_census_gate_and_columns():
    census = {"fds": 11, "connections": 2, "servers": 1, "tasks": 5}
    none_tag = {"tag": None, "bytes_per_s": 0.0, "frac": 0.0}
    good = {"cluster": {
        "qos": {"performance_limited_by": {"name": "workload"}},
        "busiest_tags": [], "hot_ranges": [],
        "processes": {
            "storage0": {"role": "storage", "census": dict(census),
                         "qos": {"version_lag_versions": 0,
                                 "input_bytes_per_s": 0.0,
                                 "sampled_bytes": 0, "sample_keys": 0,
                                 "hot_ranges": [],
                                 "busiest_read_tag": dict(none_tag),
                                 "busiest_write_tag": dict(none_tag)}},
            "grv_proxy0": {"role": "grv_proxy",
                           "qos": {"queued_requests": 0, "sheds": 0,
                                   "budget_stale": False}},
        },
    }}
    require = ["storage", "grv_proxy"]
    bare = json.loads(json.dumps(good))
    del bare["cluster"]["processes"]["storage0"]["census"]
    partial = json.loads(json.dumps(good))
    del partial["cluster"]["processes"]["storage0"]["census"]["fds"]
    for doc, census_on, bad in ((good, True, False), (bare, False, False),
                                (partial, True, True)):
        got = pfdbtop.check_status(doc, require, census=census_on)
        assert got == jfdbtop.check_status(doc, require, census=census_on)
        assert bool(got) == bad
    assert any("storage0" in p and "census.fds" in p for p in
               pfdbtop.check_status(partial, require, census=True))
    block = good["cluster"]["processes"]["storage0"]
    assert pfdbtop._census_cols(block) == jfdbtop._census_cols(block)
    assert dict(pfdbtop._census_cols(block)) == {"conns": 2, "tasks": 5,
                                                 "fds": 11}
    assert pfdbtop._census_cols({"role": "grv_proxy"}) == []


@pytest.mark.parametrize("flag", ["--smoke", "--autotune"])
def test_fdbtop_unported_modes_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        pfdbtop.main([flag])


# ---------------------------------------------------------------------------
# chaos and elasticity


def _read_confs(d: str) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        text = Path(d, name).read_text()
        out[name] = json.loads(text) if name.endswith(".json") else text
    return out


def test_chaos_write_confs_matches_jax(tmp_path):
    args = argparse.Namespace(resolvers=2, backend="cuda")
    got = {}
    for name, write in (("jax", jchaos._write_confs),
                        ("port", chaos._write_confs)):
        d = tmp_path / name
        d.mkdir()
        mpath, ctrl = write(str(d), args)
        assert (mpath, ctrl) == (str(d / "monitor.conf"),
                                 str(d / "controller0.sock"))
        got[name] = json.loads(json.dumps(_read_confs(str(d))).replace(
            str(d), "<dir>"))
    assert got["jax"]["cluster.json"].pop("backend") == "native"
    assert got["port"]["cluster.json"].pop("backend") == "cuda"
    assert got["port"] == got["jax"]
    assert got["port"]["epoch.json"] == {"epoch": 0,
                                         "topology": {"proxies": 2}}


@pytest.mark.parametrize("elastic", [True, False], ids=["on", "off"])
def test_elasticity_write_confs_matches_jax(tmp_path, elastic):
    args = argparse.Namespace(compute_cost=0.004, streak=8, backend="cuda")
    got = {}
    for name, write in (("jax", jelastic._write_confs),
                        ("port", elasticity._write_confs)):
        d = tmp_path / name
        d.mkdir()
        write(str(d), args, elastic=elastic)
        got[name] = json.loads(json.dumps(_read_confs(str(d))).replace(
            str(d), "<dir>"))
    assert got["jax"]["cluster.json"].pop("backend") == "native"
    assert got["port"]["cluster.json"].pop("backend") == "cuda"
    assert got["port"] == got["jax"]
    assert elasticity._key(3, 5) == jelastic._key(3, 5)
    assert chaos.KILLABLE == jchaos.KILLABLE


def test_chaos_smoke_on_the_cpu(tmp_path, capsys, monkeypatch,
                                one_thread_children):
    monkeypatch.setenv("FDBTPU_CONTROLLER_TRACE", "/untouched")
    ledger = tmp_path / "ledger.jsonl"
    out = tmp_path / "results.jsonl"
    rc = chaos.main(["--smoke", "--backend", "cpu", "--perf-ledger",
                     str(ledger), "--json-out", str(out)])
    said = capsys.readouterr().out
    assert rc == 0, said
    assert "chaos ok (1 scenario(s): resolver)" in said
    assert os.environ["FDBTPU_CONTROLLER_TRACE"] == "/untouched"
    (res,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert res["kill"] == "resolver" and res["killed_pid"]
    assert res["recovered"] == 1
    assert res["epoch_after"] > res["epoch_before"]
    assert res["recovery_state"] == "fully_recovered"
    assert res["recovery_time_s"] <= 30.0
    assert res["push_detected"] == 1
    assert res["recovery_reason"].startswith("push:")
    assert res["consistency_ok"] == 1 and res["missing_keys"] == 0
    assert res["committed"] > 0
    assert res["timeline_ok"] == 1
    assert res["timeline"][-1]["status"] == "fully_recovered"
    assert res["proxies_planned"] == 2 and res["partitioned"] == 1
    assert res["tlog_lock"]["survivors"] == res["tlog_lock"]["total"] == 2
    assert chaos.scenario_failures("resolver", res, chaos.parser()
                                   .parse_args([]), drill=False) == []
    (row,) = perf.load_history(str(ledger))
    assert row["source"] == "chaos_pipeline"
    assert row["metrics"]["recoveries_completed"]["value"] == 1
    for name in ("consistency_ok", "timeline_ok", "push_detected",
                 "topology_persisted"):
        assert row["metrics"][name]["value"] == 1, name
    assert row["workload"]["backend"] == "cpu"


def test_chaos_without_a_card_fails_the_recruit(monkeypatch,
                                                one_thread_children):
    """The default backend resolves on the card: here the resolver's
    recruit fails and the drill raises; it never carries on with
    another backend."""
    args = chaos.parser().parse_args(["--recovery-bound", "8"])
    assert args.backend == "cuda"
    with pytest.raises(Exception):
        run(chaos._run_scenario("resolver", args))


@pytest.mark.slow
@pytest.mark.xfail(strict=False, reason=(
    "on the CPU the ON gate (1.5x) reads the recruit's stall, not the "
    "scale: the JAX drill's recruit walk stalls every commit 2.0-2.8 s "
    "inside its plateau window and passes on that alone (about 240 txn/s "
    "before and after); the port's walk stalls 0.1 s, its two resolvers "
    "run at about 1.95x the plateau until the controller's scale-down 4 s "
    "later, and the post window averages 1.27-1.30x "
    "(tests/elastic_timeline.py, PERF.md section 6)"))
def test_elasticity_both_directions_on_the_cpu(tmp_path, capsys,
                                               one_thread_children):
    rc = elasticity.main(["--smoke", "--backend", "cpu", "--perf-ledger",
                          str(tmp_path / "ledger.jsonl")])
    said = capsys.readouterr().out
    assert rc == 0, said
    (row,) = perf.load_history(str(tmp_path / "ledger.jsonl"))
    assert row["metrics"]["recruits_completed"]["value"] == 1
    assert row["metrics"]["off_no_recruit"]["value"] == 1
