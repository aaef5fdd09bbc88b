"""Kill -9 chaos drill for the wire cluster's lifecycle (the port's
analog of the JAX package's `scripts/chaos_pipeline.py`).

    python -m foundationdb_tpu_torch.drills.chaos --smoke
    python -m foundationdb_tpu_torch.drills.chaos --kill tlog
    python -m foundationdb_tpu_torch.drills.chaos --drill
    python -m foundationdb_tpu_torch.drills.chaos --smoke --backend cpu

A controller + worker cluster (cluster/multiprocess.py: WorkerRole,
ClusterControllerRole) runs under the Monitor (fdbmonitor's analog,
driven from a thread); a unique-key workload runs through the
ClusterClient front door while one role's worker process is killed with
SIGKILL mid-run. The gate: the controller detects the death (the
monitor's push, not the heartbeat backstop, for a transaction-path
role), recovers the transaction system into a newer generation (the
cluster/generation.py walk: lock the surviving tlogs, recruit empty
resolvers, the conservative whole-keyspace write), the monitor restarts
the corpse, the workload keeps flowing, the exact-count consistency
check passes, and the recovery's epoch timeline is in the controller's
trace file.

Every scenario runs the scale-out commit path: a sequencer, two commit
proxies and two tag-partitioned tlogs. The conf declares one proxy and
the pre-seeded state file says an elastic recruit widened the fleet to
two, so each recovery also checks that the persisted topology survives
(a controller restart too). Keys land on both sides of the tag boundary,
so the consistency check covers both tlog partitions, and a tlog kill
must recover off the survivors.

Modes: `--smoke` kills one resolver; `--kill KIND` one scenario; `--drill`
kills the proxy, resolver, one of two tlogs, sequencer, ratekeeper and
controller, each on a fresh cluster, and also gates the SLOs on the
redundant roles (admitted-txn p99 <= 0.5 s, post-kill goodput >= 0.70 of
the pre-kill peak). The resolvers resolve on the card (`--backend cuda`,
the default, as the port's controller conf does); `--backend cpu` (the
host oracle) and `--backend native` (the C++ sets) run where the caller
asks for them. A "cuda" resolver without a card fails its recruit and
the drill exits nonzero; it never carries on with another backend.
`RESOLVER_KERNEL` in the environment sets the card's kernel config.

Consistency under chaos: every client write targets a unique key, so a
commit whose fate is unknown (the connection lost mid-flight) is
resolved by readback: key present == committed. Every definite commit's
key must be present.

The run appends one perf-ledger row (utils/perf.py) to `--perf-ledger`
or the default ledger, unless `--no-perf`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
import tempfile
import threading
import time

KILLABLE = ("proxy", "resolver", "tlog", "sequencer", "ratekeeper",
            "controller")
#: the kills whose recovery is a generation walk the monitor's
#: push-on-death must start
TXN_PATH = ("proxy", "resolver", "tlog", "sequencer")
#: the resolver backends a drill's cluster takes
BACKENDS = ("cuda", "cpu", "native")


def _pctl(samples, q):
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, int(len(s) * q))]


def _write_monitor_conf(d: str, cpath: str, n_workers: int) -> tuple:
    """The monitor's conf: the controller and `n_workers` workers, all
    in `d`. Returns (its path, the controller's address)."""
    ctrl_addr = os.path.join(d, "controller0.sock")
    lines = [
        "[role.controller]",
        "kind = controller",
        f"socket_dir = {d}",
        f"cluster_conf = {cpath}",
        f"state_file = {os.path.join(d, 'epoch.json')}",
    ]
    for i in range(n_workers):
        lines += [
            f"[role.worker{i}]",
            "kind = worker",
            f"socket_dir = {d}",
            f"index = {i}",
            f"controller = {ctrl_addr}",
        ]
    mpath = os.path.join(d, "monitor.conf")
    with open(mpath, "w") as f:
        f.write("\n".join(lines) + "\n")
    return mpath, ctrl_addr


def _write_confs(d: str, args) -> tuple[str, str]:
    """The declarative cluster conf + the monitor conf: controller +
    enough workers to host the topology plus one spare (the killed
    worker's replacement until the monitor restarts the corpse)."""
    cluster_conf = {
        "resolvers": args.resolvers,
        # the scale-out commit path: a sequencer, two tag-partitioned
        # tlogs, and (from the persisted topology below) two commit
        # proxies. The conf declares one proxy on purpose: the state
        # file says an elastic recruit widened the fleet to 2, so every
        # scenario checks that a recovered (or restarted) controller
        # plans proxies=2 and never falls back to the conf.
        "proxies": 1,
        "tlogs": 2,
        "sequencer": True,
        "backend": args.backend,
        "tlog_data_dir": os.path.join(d, "tlog-data"),
        "storage_data_dir": os.path.join(d, "storage-data"),
        "ratekeeper": True,
        "trace": False,
    }
    cpath = os.path.join(d, "cluster.json")
    with open(cpath, "w") as f:
        json.dump(cluster_conf, f)
    with open(os.path.join(d, "epoch.json"), "w") as f:
        json.dump({"epoch": 0, "topology": {"proxies": 2}}, f)
    # 2 tlogs + storage + sequencer + ratekeeper + 2 proxies
    n_roles = args.resolvers + 6
    return _write_monitor_conf(d, cpath, n_roles + 1)


class _MonitorThread:
    """The Monitor driven from a thread (its run_forever installs signal
    handlers, which work on the main thread only; the supervision loop
    itself is start_all + poll_once)."""

    def __init__(self, conf_path: str):
        from foundationdb_tpu_torch.cluster.monitor import Monitor

        self.monitor = Monitor(conf_path, log=lambda *_: None)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        self.monitor.start_all()
        while not self._stop.is_set():
            self.monitor.poll_once()
            time.sleep(0.1)

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
        self.monitor.stop_all()

    def controller_pid(self):
        child = self.monitor.children.get("controller")
        return child.proc.proc.pid if child else None


async def _controller_status(mp, ctrl_addr: str) -> dict:
    conn = mp.transport.RpcConnection(ctrl_addr)
    await conn.connect(retries=2, delay=0.05)
    try:
        reply = await conn.call(
            mp.TOKEN_STATUS, mp.StatusRequest(pad=0), timeout=5.0
        )
        return json.loads(reply.payload)
    finally:
        await conn.close()


async def _read_many(client, keys: list, rv: int) -> list:
    """Read `keys` at `rv`, 64 at a time: thousands of keys would
    otherwise cost one serial round trip each."""
    out = []
    for lo in range(0, len(keys), 64):
        out.extend(await asyncio.gather(*(
            client.read(k, rv) for k in keys[lo:lo + 64]
        )))
    return out


async def _kill_under_load(kill_kind: str, client, mon: _MonitorThread,
                           ctrl_addr: str, trace_path: str, args,
                           segment: int = 0) -> dict:
    """One scenario on a running cluster: `args.clients` clients commit
    unique keys for `args.duration` seconds; at 40% of it the worker
    hosting `kill_kind` (or the controller) is SIGKILLed and the
    recovery watched live; then the controller's status, the exact-count
    readback, the timeline from the trace and the SLO windows. A
    cluster's later scenarios pass `segment` 1, 2, ... so their keys
    differ from the earlier ones' (the keys stay short: a kernel config
    of 16-byte keys compares longer ones by their first 16 bytes)."""
    from foundationdb_tpu_torch.cluster import generation as gen
    from foundationdb_tpu_torch.cluster import multiprocess as mp
    from foundationdb_tpu_torch.models.types import CommitTransaction
    from foundationdb_tpu_torch.wire.codec import Mutation

    stats = {
        "committed": 0, "unknown": 0, "conflicted": 0,
        "grv_throttled": 0, "recovering_waits": 0,
    }
    lat: list[float] = []
    commit_times: list[float] = []  # a monotonic stamp a commit
    definite: list[bytes] = []
    unknown: list[bytes] = []
    kill_at = args.duration * 0.4
    killed = {"pid": None, "at": None, "kind": kill_kind}
    await client.connect()  # the live generation
    epoch0 = client.epoch
    t_start = time.monotonic()
    stop = t_start + args.duration
    name = b"chaos%d" % segment if segment else b"chaos"

    async def one_client(cid: int):
        seq = 0
        # unique keys on both sides of the 0x80 tag boundary, so the
        # exact-count check covers both tlog partitions
        prefix = name if cid % 2 else b"\xf0" + name
        while time.monotonic() < stop:
            seq += 1
            key = b"%s-%d-%d" % (prefix, cid, seq)
            t0 = time.monotonic()
            try:
                rv = await client.get_read_version()
                txn = CommitTransaction(
                    write_conflict_ranges=[(key, key + b"\x00")],
                    read_conflict_ranges=[(key, key + b"\x00")],
                    read_snapshot=rv,
                    mutations=[Mutation(0, key, b"x")],
                )
                await client.commit(txn)
                now = time.monotonic()
                stats["committed"] += 1
                definite.append(key)
                lat.append(now - t0)
                commit_times.append(now)
            except mp.GrvThrottledError:
                stats["grv_throttled"] += 1
                await asyncio.sleep(0.01)
            except mp.NotCommittedError:
                # unique keys never truly conflict: this is the
                # conservative recovery abort of an in-flight
                # pre-recovery snapshot, as designed
                stats["conflicted"] += 1
            except mp.CommitUnknownError:
                stats["unknown"] += 1
                unknown.append(key)
            except mp.ClusterRecoveringError:
                stats["recovering_waits"] += 1
                await asyncio.sleep(0.1)

    async def killer():
        await asyncio.sleep(kill_at)
        if kill_kind == "controller":
            pid = mon.controller_pid()
        else:
            t = await client.topology()
            entry = next(
                (e for e in t["roles"].values()
                 if e["kind"] == kill_kind), None
            )
            pid = entry and entry.get("pid")
        if pid:
            os.kill(pid, signal.SIGKILL)
            killed["pid"] = pid
            killed["at"] = time.monotonic() - t_start
            print(f"[chaos] SIGKILL {kill_kind} pid={pid} at "
                  f"t+{killed['at']:.1f}s", flush=True)
        # watch the recovery live, so time-to-recover includes death
        # detection. A killed ratekeeper is a singleton re-recruit (no
        # generation bump): its recovery is a new pid in the topology;
        # every other kill must give a strictly newer fully recovered
        # generation.
        t_kill = time.monotonic()
        while time.monotonic() - t_kill < args.recovery_bound:
            try:
                t = await client.topology()
                if kill_kind == "ratekeeper":
                    entry = next(
                        (e for e in t["roles"].values()
                         if e["kind"] == "ratekeeper"), None
                    )
                    ok = (entry and entry.get("pid")
                          and entry["pid"] != pid
                          and t["state"] == gen.FULLY_RECOVERED)
                else:
                    ok = (t["epoch"] > epoch0
                          and t["state"] == gen.FULLY_RECOVERED)
                if ok:
                    killed["recovered_after_s"] = round(
                        time.monotonic() - t_kill, 3
                    )
                    return
            except Exception:
                pass
            await asyncio.sleep(0.1)

    await asyncio.gather(
        killer(), *(one_client(c) for c in range(args.clients))
    )
    wall = time.monotonic() - t_start

    if killed.get("recovered_after_s") is None:
        raise RuntimeError(
            f"no recovery observed within {args.recovery_bound}s "
            f"after killing {kill_kind}"
        )
    status = await _controller_status(mp, ctrl_addr)
    q = status["qos"]

    # --- post-recovery liveness + exact-count consistency ------------
    await client.connect()  # re-resolve the recovered generation
    rv = await client.get_read_version()
    missing = sum(1 for v in await _read_many(client, definite, rv)
                  if v != b"x")
    resolved_committed = sum(
        1 for v in await _read_many(client, unknown, rv) if v == b"x")

    # --- the recovery timeline, reconstructed from the trace ---------
    timeline = []
    if os.path.exists(trace_path):
        from foundationdb_tpu_torch.utils import commit_debug as cd

        timeline = gen.recovery_timeline_from_trace(
            cd.load_jsonl([trace_path])
        )
    if kill_kind == "ratekeeper":
        # singleton re-recruit, no epoch bump: the timeline must still
        # hold a recruitment walk
        post_kill = timeline
    else:
        post_kill = [e for e in timeline if e["epoch"] > epoch0]
    timeline_ok = any(
        e["status"] == gen.FULLY_RECOVERED for e in post_kill
    )

    # --- SLO math ------------------------------------------------------
    k_at = t_start + (killed["at"] or kill_at)
    pre = [t for t in commit_times if t_start + 1.0 <= t < k_at]
    post = [t for t in commit_times if t >= k_at]
    pre_window = max(1e-6, k_at - (t_start + 1.0))
    post_window = max(1e-6, (t_start + wall) - k_at)
    peak = len(pre) / pre_window
    post_rate = len(post) / post_window
    return {
        "kill": kill_kind,
        "killed_pid": killed["pid"],
        "epoch_before": epoch0,
        "epoch_after": q["epoch"],
        "recovery_state": q["recovery_state"],
        "controller_recoveries": q["recoveries_completed"],
        # kill -> recovered generation observed, detection included
        "recovery_time_s": killed.get("recovered_after_s"),
        # the controller's own recovery walk seconds (lock ->
        # fully_recovered), for comparison
        "recovery_walk_s": q["last_recovery_s"],
        "recovery_reason": q["last_recovery_reason"],
        # the monitor's push-on-death beat the heartbeat backstop (only
        # meaningful for the transaction-path kills, which walk)
        "push_detected": int(
            kill_kind in TXN_PATH
            and str(q["last_recovery_reason"] or "").startswith("push:")
        ),
        "death_notifications": q.get("death_notifications", 0),
        # the scale-out pins: the recovered generation still plans the
        # widened fleet (state file 2 proxies, conf 1), and the phase-one
        # lock report shows how many tlogs the walk locked against the
        # topology's width (a one-of-two tlog kill recovers off the
        # survivor)
        "proxies_planned": q.get("proxies_planned"),
        "partitioned": int(bool(q.get("partitioned"))),
        "tlog_lock": q.get("last_tlog_lock"),
        "recovered": int(
            killed.get("recovered_after_s") is not None
            and q["recovery_state"] == gen.FULLY_RECOVERED
        ),
        "consistency_ok": int(missing == 0),
        "missing_keys": missing,
        "unknown_resolved_committed": resolved_committed,
        "timeline_ok": int(timeline_ok),
        "timeline": post_kill[-12:],
        "wall_s": round(wall, 2),
        "commit_p50_ms": round(_pctl(lat, 0.50) * 1e3, 1),
        "commit_p99_ms": round(_pctl(lat, 0.99) * 1e3, 1),
        "peak_txn_s": round(peak, 1),
        "post_kill_txn_s": round(post_rate, 1),
        "goodput_ratio": round(post_rate / peak, 3) if peak else 0.0,
        **stats,
    }


class _Cluster:
    """A drill's cluster for the length of an `async with`: the confs in
    a fresh directory, the controller's trace file named in
    FDBTPU_CONTROLLER_TRACE (the monitor starts the controller, which
    reads it at startup; restored on exit), the monitor thread, and a
    connected ClusterClient. The directory goes on a clean exit, unless
    CHAOS_KEEP is set."""

    def __init__(self, prefix: str, write_confs, *, recovery_timeout):
        self.prefix = prefix
        self.write_confs = write_confs
        self.recovery_timeout = recovery_timeout

    async def __aenter__(self):
        from foundationdb_tpu_torch.cluster import multiprocess as mp

        self.dir = tempfile.mkdtemp(prefix=self.prefix)
        rel = os.path.relpath(self.dir)
        if len(rel) < len(self.dir):
            self.dir = rel  # a Unix socket's path holds at most 107 bytes
        mon_conf, self.ctrl_addr = self.write_confs(self.dir)
        self.trace_path = os.path.join(self.dir, "controller-trace.jsonl")
        self._old_trace = os.environ.get("FDBTPU_CONTROLLER_TRACE")
        os.environ["FDBTPU_CONTROLLER_TRACE"] = self.trace_path
        self.mon = _MonitorThread(mon_conf)
        self.mon.start()
        self.client = None
        try:
            self.client = mp.ClusterClient(
                self.ctrl_addr, recovery_timeout=self.recovery_timeout)
            await self.client.connect()
        except BaseException:
            await self._teardown(clean=False)
            raise
        return self

    async def _teardown(self, clean: bool) -> None:
        try:
            if self.client is not None:
                await self.client.close()
        finally:
            self.mon.stop()
            if self._old_trace is None:
                os.environ.pop("FDBTPU_CONTROLLER_TRACE", None)
            else:
                os.environ["FDBTPU_CONTROLLER_TRACE"] = self._old_trace
            if clean and not os.environ.get("CHAOS_KEEP"):
                import shutil

                shutil.rmtree(self.dir, ignore_errors=True)

    async def __aexit__(self, exc_type, exc, tb):
        # keep the directory on a failure, for its logs and state
        await self._teardown(clean=exc_type is None)


def chaos_cluster(args) -> _Cluster:
    """The drill's cluster (`_write_confs`) as an async context."""
    return _Cluster(f"chaos_{args.backend}_",
                    lambda d: _write_confs(d, args),
                    recovery_timeout=args.recovery_bound)


async def _run_scenario(kill_kind: str, args) -> dict:
    """One scenario on a fresh cluster."""
    async with chaos_cluster(args) as c:
        return await _kill_under_load(kill_kind, c.client, c.mon,
                                      c.ctrl_addr, c.trace_path, args)


async def _run_scenario_gated(kill_kind: str, args) -> dict:
    """One scenario under the resource-census gate: every fd, connection
    and server the scenario opens in this process must be gone once the
    monitor is down. A leak fails the scenario (and so the drill)."""
    from foundationdb_tpu_torch.runtime import census

    pre = census.snapshot()
    res = await _run_scenario(kill_kind, args)
    # asyncio tears transports down a tick after close(); let the loop
    # drain before the post census
    await asyncio.sleep(0.1)
    census.check_drained(
        pre, census.snapshot(), label=f"chaos {kill_kind}"
    )
    return res


def scenario_failures(kind: str, res: dict, args, *, drill: bool) -> list:
    """The gates of one scenario's result; `drill` adds the SLOs on the
    redundant roles. Returns the failures (empty: it passed)."""
    failures = []
    if not res["recovered"]:
        failures.append(f"{kind}: no recovered generation")
    if not res["consistency_ok"]:
        failures.append(
            f"{kind}: {res['missing_keys']} committed key(s) missing"
        )
    if not res["timeline_ok"]:
        failures.append(f"{kind}: recovery timeline not in trace")
    if kind in TXN_PATH and not res["push_detected"]:
        failures.append(
            f"{kind}: recovery was heartbeat-detected "
            f"(reason {res['recovery_reason']!r}); the monitor's "
            "push-on-death should have won"
        )
    # the persisted topology: every recovered generation (a fresh
    # controller process too) keeps the widened fleet from the state
    # file, not the declared conf
    if res["proxies_planned"] != 2:
        failures.append(
            f"{kind}: recovered with proxies_planned="
            f"{res['proxies_planned']}; persisted elastic topology "
            "lost (expected 2)"
        )
    if not res["partitioned"]:
        failures.append(f"{kind}: cluster not in partitioned mode")
    lock = res["tlog_lock"] or {}
    if kind == "tlog":
        # the per-tag quorum: the walk locked the survivors and
        # recovered anyway, never waiting on the corpse
        if not (lock.get("survivors", 0) < lock.get("total", 0)):
            failures.append(
                f"{kind}: phase-one lock saw {lock}; expected a "
                "survivor quorum strictly smaller than the fleet"
            )
    elif kind in ("proxy", "resolver", "sequencer", "controller"):
        # these kills force a fresh walk with every tlog alive: the
        # lock is full-width. (A ratekeeper kill is a re-recruit with
        # no walk.)
        if lock.get("survivors") != lock.get("total"):
            failures.append(
                f"{kind}: phase-one lock lost a tlog it shouldn't "
                f"have: {lock}"
            )
    if res["committed"] == 0:
        failures.append(f"{kind}: nothing committed")
    if (res["recovery_time_s"] or args.recovery_bound) \
            > args.recovery_bound:
        failures.append(
            f"{kind}: recovery took {res['recovery_time_s']}s"
        )
    # The SLO pair gates the redundant data-plane kills: one of N dies
    # and the survivors keep the pipeline flowing. The sequencer and the
    # controller are singletons whose death stalls every commit until
    # the walk replaces them, so they gate on the recovery bound,
    # consistency and the persisted topology instead.
    if drill and kind not in ("sequencer", "controller"):
        if res["commit_p99_ms"] > args.slo_p99_s * 1e3:
            failures.append(
                f"{kind}: p99 {res['commit_p99_ms']}ms > SLO"
            )
        if res["goodput_ratio"] < args.slo_goodput:
            failures.append(
                f"{kind}: goodput ratio {res['goodput_ratio']} < "
                f"{args.slo_goodput}"
            )
    return failures


def _emit_ledger(args, results: list[dict]) -> None:
    """One perf-ledger row for the run: the recoveries and the
    consistency bit are structural (the drill recovered every scenario
    or it did not); time to recover and the SLO numbers are wall clock
    (hardware tier)."""
    from foundationdb_tpu_torch.utils import perf

    n = len(results)
    rec = perf.emit(
        "chaos_pipeline",
        {
            "recoveries_completed": perf.metric(
                sum(r["recovered"] for r in results), "count",
                direction="higher", tier="structural",
            ),
            "consistency_ok": perf.metric(
                int(all(r["consistency_ok"] for r in results)), "bool",
                direction="higher", tier="structural",
            ),
            "timeline_ok": perf.metric(
                int(all(r["timeline_ok"] for r in results)), "bool",
                direction="higher", tier="structural",
            ),
            "recovery_time_s": perf.metric(
                round(max(r["recovery_time_s"] or 0.0 for r in results), 3),
                "s", direction="lower", tier="hardware",
            ),
            "commit_p99_ms": perf.metric(
                round(max(r["commit_p99_ms"] for r in results), 1),
                "ms", direction="lower", tier="hardware",
            ),
            "goodput_ratio": perf.metric(
                round(min(r["goodput_ratio"] for r in results), 3),
                "ratio", direction="higher", tier="hardware",
            ),
            # every transaction-path kill detected by the monitor's
            # push, not the heartbeat backstop
            "push_detected": perf.metric(
                int(all(r["push_detected"] for r in results
                        if r["kill"] in TXN_PATH)),
                "bool", direction="higher", tier="structural",
            ),
            # every recovered generation kept the persisted 2-proxy
            # fleet (the conf declares 1) and stayed partitioned
            "topology_persisted": perf.metric(
                int(all(
                    r["proxies_planned"] == 2 and r["partitioned"]
                    for r in results
                )),
                "bool", direction="higher", tier="structural",
            ),
        },
        workload={
            "scenarios": [r["kill"] for r in results],
            "clients": args.clients,
            "duration_s": args.duration,
            "resolvers": args.resolvers,
            "topology": "scaleout-2proxy-2tlog-seq",
            "backend": args.backend,
        },
        knobs={"mode": "drill" if n > 1 else "single"},
        ledger=args.perf_ledger,
    )
    print(f"[perf] chaos ledger row appended "
          f"({rec['metrics']['recoveries_completed']['value']}/{n} "
          "scenarios recovered)", flush=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kill", choices=KILLABLE, default="resolver",
                    help="which role's worker process gets SIGKILL")
    ap.add_argument("--smoke", action="store_true",
                    help="small cluster, kill one resolver, gate recovery "
                         "+ consistency + the ledger row")
    ap.add_argument("--drill", action="store_true",
                    help="each role killed mid-load on a fresh cluster, "
                         "SLO gated")
    ap.add_argument("--backend", choices=BACKENDS, default="cuda",
                    help="the resolvers' backend (default: the card)")
    ap.add_argument("--clients", type=int, default=24)
    ap.add_argument("--duration", type=float, default=12.0)
    ap.add_argument("--resolvers", type=int, default=1)
    ap.add_argument("--recovery-bound", type=float, default=30.0,
                    help="max seconds from kill to fully_recovered")
    ap.add_argument("--slo-p99-s", type=float, default=0.5)
    ap.add_argument("--slo-goodput", type=float, default=0.70)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--perf-ledger", default=None,
                    help="append the run's ledger row here (default: "
                         "utils/perf.history_path())")
    ap.add_argument("--no-perf", action="store_true")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    if args.smoke:
        scenarios = ["resolver"]
        args.clients = min(args.clients, 12)
        args.duration = min(args.duration, 8.0)
    elif args.drill:
        scenarios = list(KILLABLE)
    else:
        scenarios = [args.kill]

    if args.backend == "cuda":
        from foundationdb_tpu_torch import kernels

        # once, here: the workers' resolvers load the built libraries
        kernels.build_all()
    results = []
    failures = []
    for kind in scenarios:
        print(f"== chaos scenario: kill -9 {kind} ==", flush=True)
        res = asyncio.run(_run_scenario_gated(kind, args))
        results.append(res)
        print(json.dumps(
            {k: v for k, v in res.items() if k != "timeline"}
        ), flush=True)
        for row in res["timeline"]:
            print(f"    epoch {row['epoch']:>3}  {row['status']}",
                  flush=True)
        failures += scenario_failures(kind, res, args, drill=args.drill)

    if args.json_out:
        with open(args.json_out, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    if not args.no_perf:
        _emit_ledger(args, results)
    if failures:
        print(f"chaos FAILED: {failures}", flush=True)
        return 1
    print(f"chaos ok ({len(results)} scenario(s): "
          f"{', '.join(r['kill'] for r in results)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
