#!/usr/bin/env python
"""fdbtop: live terminal monitor for a cluster's saturation telemetry
(the port's analog of the JAX package's `scripts/fdbtop.py`).

The `fdbcli status` / `top` hybrid: one screen with a row a role process
(queue depth and bytes, version lag, batch-sizer targets, kernel
occupancy, the resource census) plus a sparkline history a row,
refreshed live. It reads both deployment shapes:

  wire mode (role processes over Unix sockets):
      python -m foundationdb_tpu_torch.drills.fdbtop --socket-dir DIR --watch
      python -m foundationdb_tpu_torch.drills.fdbtop --socket-dir DIR --once \
          --json
      python -m foundationdb_tpu_torch.drills.fdbtop --conf monitor.conf --once

    Every role process answers the StatusRequest RPC (cluster/
    multiprocess.py TOKEN_STATUS) with its qos block; a pipeline's
    status socket (`serve_status`) serves its commit and GRV proxy
    blocks as proxy0.sock in the same directory. fdbtop assembles them
    with cluster/status.assemble_status, the same qos math as the
    simulated cluster's `cluster_status()`: one schema for both shapes.
    `--conf` reads the socket directories from a monitor conf.

  sim mode (an in-process simulated cluster and a demo workload):
      python -m foundationdb_tpu_torch.drills.fdbtop --sim --watch
      python -m foundationdb_tpu_torch.drills.fdbtop --sim --once --json \
          --backend cpu

    Its resolvers resolve on the card (`--backend cuda`, the default) or
    with the host oracle (`--backend cpu`).

`--smoke` (the JAX script's wire smoke, which spins the pipeline bench)
and `--autotune` (the autotune panel) raise until the pipeline bench
(ROADMAP queue 1 item 2) and `utils/autotune.py` (item 8) are ported.
"""

from __future__ import annotations

import argparse
import asyncio
import glob
import json
import os
import sys
import time

from foundationdb_tpu_torch.utils.metrics import MetricHistory, sparkline

#: per-role headline gauge (the sparkline column): path into the qos
#: block, rendered per poll into a bounded MetricHistory ring
HEADLINE = {
    "log": ("smoothed_queue_bytes", "queue B"),
    "storage": ("version_lag_versions", "lag v"),
    "resolver": ("queue_depth", "queue"),
    "commit_proxy": ("queued_requests", "queued"),
    "grv_proxy": ("queued_requests", "queued"),
    "master": ("version", "version"),
    # the scale-out sequencer: version-batch allotment rate — the
    # whole commit path's grant heartbeat as a sparkline
    "sequencer": ("grants_per_s", "grants/s"),
    # the admission budget as a live sparkline: watching the limit dip
    # and recover IS watching the control loop work
    "ratekeeper": ("transactions_per_second_limit", "tps lim"),
    # the generation counter: a recovery is a visible +1 step
    "cluster_controller": ("epoch", "epoch"),
    "worker": ("initializations", "inits"),
}

#: sensors every role's qos block must carry (the --require gate; the
#: JAX package's tests pin the same schema)
REQUIRED_SENSORS = {
    "log": ("queue_bytes", "smoothed_queue_bytes", "input_bytes_per_s"),
    # hot-key telemetry: the byte-sample totals, the top-K tag
    # trackers' busiest rows, and the heatmap's hot_ranges density rows
    # — always present (zeros/None rows before traffic, never missing)
    "storage": ("version_lag_versions", "input_bytes_per_s",
                "sampled_bytes", "sample_keys", "hot_ranges",
                "busiest_read_tag", "busiest_write_tag"),
    # "kernel" is the kernel panel: compile-cache hits/misses, last
    # compile seconds, stage p99s (KernelStageMetrics.qos()) — present
    # on EVERY resolver backend, native included. Dotted keys descend
    # into nested blocks: the per-shard columns (mesh shard count,
    # worst-shard tier occupancy, measured collective time share) are
    # pinned on every backend too — single-device kernels report
    # shards=1 / zeros, never a missing key.
    "resolver": ("queue_depth", "queue_wait_dist", "compute_time_dist",
                 "occupancy", "kernel", "kernel.shards",
                 "kernel.worst_shard_delta_occupancy",
                 "kernel.worst_shard_main_occupancy",
                 "kernel.collective_time_share",
                 # the range-path counters (sweep groups dispatched,
                 # pressure spills) — zeros on unconfigured kernels,
                 # never a missing key
                 "kernel.spills", "kernel.sweep_groups",
                 # the ResolutionBalancer's conflict-range key
                 # sample (width + top begin keys by touch count)
                 "key_sample"),
    "commit_proxy": ("queued_requests", "inflight_batches", "batch_sizer",
                     # scale-out: grants consumed + whether this
                     # proxy pushes tag-partitioned (0/False legacy)
                     "version_grants", "tag_partitioned",
                     # commit-side TransactionTagCounter top row
                     "busiest_write_tag"),
    # the sequencer role's allotment surface — grant count/rate,
    # the GRV notification floor, and the tag/proxy fan-out widths
    "sequencer": ("grants", "grants_per_s", "live_committed_version",
                  "tags", "proxies_seen"),
    "grv_proxy": ("queued_requests", "sheds", "budget_stale"),
    # binding_streak is the elasticity trigger's input — shipped by
    # the shared law's rate_info(), so sim and wire both pin it
    "ratekeeper": ("transactions_per_second_limit", "budget_limited_by",
                   "budget_stale", "binding_streak"),
    # wire-cluster lifecycle: the controller's generation + recovery
    # surface (the chaos drill reads the same fields); elastic_recruits
    # is the elasticity panel's headline counter (0 when disabled)
    "cluster_controller": ("epoch", "recovery_state",
                           "recoveries_completed", "workers_live",
                           "recovery_timeline", "elastic_recruits"),
}

#: per-process resource-census keys (runtime/census.py) every wire role
#: process must report NEXT TO its qos block — the leak gate's gauges
#: as operator columns. Enforced with census=True only: the sim surfaces
#: one cluster-level census (the whole sim is one process), and
#: grv_proxy rides the proxy0 socket so its census IS proxy0's.
CENSUS_SENSORS = ("census.fds", "census.connections", "census.servers",
                  "census.tasks")


# ---------------------------------------------------------------------------
# Wire-mode polling.


async def _poll_wire(socket_dir: str, conns: dict, *, retries: int = 40):
    """One status poll over every .sock in the dir; connections are
    cached across polls (watch mode). Returns the assembled document."""
    from foundationdb_tpu_torch.cluster import multiprocess as mp
    from foundationdb_tpu_torch.cluster.status import assemble_status

    procs: dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(socket_dir, "*.sock"))):
        name = os.path.basename(path)[: -len(".sock")]
        conn = conns.get(name)
        if conn is None:
            try:
                conn = await mp.connect(path, retries=retries)
            except (OSError, ConnectionError):
                continue  # half-started cluster: render what answers
            conns[name] = conn
        try:
            reply = await conn.call(
                mp.TOKEN_STATUS, mp.StatusRequest(pad=0), timeout=5.0
            )
        except Exception:
            conns.pop(name, None)
            try:
                await conn.close()
            except Exception:
                pass
            continue
        block = json.loads(reply.payload)
        # the parent pipeline's socket carries BOTH proxy roles; split
        # the embedded GRV block into its own process row
        grv = block.pop("grv_proxy", None)
        procs[name] = block
        if grv is not None:
            procs[f"grv_{name}"] = grv
    return assemble_status(procs)


async def _close_conns(conns: dict) -> None:
    for conn in conns.values():
        try:
            await conn.close()
        except Exception:
            pass
    conns.clear()


def _conf_socket_dirs(conf_path: str) -> list[str]:
    """Socket dirs named by a foundationdb.conf-style role file
    (cluster/monitor.py parse_conf) — `fdbtop --conf` monitors a
    Monitor-managed cluster without knowing where its sockets live."""
    from foundationdb_tpu_torch.cluster.monitor import parse_conf

    return sorted({s.socket_dir for s in parse_conf(conf_path).values()})


# ---------------------------------------------------------------------------
# Sim mode: an in-process cluster + demo workload on the virtual clock.


class _SimWorld:
    """A small simulated cluster whose virtual time advances between
    polls: the `--sim` backend (the same render path as wire mode). Its
    resolvers resolve on the card (`backend` "cuda") or with the host
    oracle ("cpu")."""

    def __init__(self, seed: int = 0, backend: str = "cuda"):
        import numpy as np

        from foundationdb_tpu_torch.cluster.database import (
            ClusterConfig,
            open_cluster,
        )

        self.rng = np.random.default_rng(seed)
        self.sched, self.cluster, self.db = open_cluster(
            ClusterConfig(
                n_commit_proxies=2, n_resolvers=2, n_storage=2, n_tlogs=2,
                resolver_backend=backend,
            )
        )
        self._stop = False
        for w in range(4):
            self.sched.spawn(self._workload(w))

    async def _workload(self, wid: int) -> None:
        i = 0
        while not self._stop:
            txn = self.db.create_transaction()
            # tenant-prefixed keys so the demo exercises the tag
            # sensors: each workload is one tenant, rate-skewed by wid
            key = b"t%d/fdbtop-%06d" % (wid, int(self.rng.integers(4096)))
            txn.set(key, b"x" * int(self.rng.integers(16, 512)))
            try:
                await txn.commit()
            except Exception:
                pass  # conflicts are workload, not monitor, business
            i += 1
            await self.sched.delay(0.002 * (wid + 1))

    def poll(self) -> dict:
        from foundationdb_tpu_torch.cluster.status import cluster_status

        self.sched.run_for(0.25)  # advance virtual time between frames
        return cluster_status(self.cluster)

    def stop(self) -> None:
        self._stop = True
        self.cluster.stop()


# ---------------------------------------------------------------------------
# Rendering.


def _fmt(v) -> str:
    if isinstance(v, float):
        if v and (abs(v) >= 1e5 or abs(v) < 1e-2):
            return f"{v:9.2e}"
        return f"{v:9.2f}"
    return f"{v!s:>9}"


def _row_metrics(role: str, block: dict) -> list[tuple[str, object]]:
    """The per-role detail columns after the headline gauge."""
    q = block.get("qos", {})
    if role == "log":
        return [
            ("mutations", q.get("queue_mutations", 0)),
            ("in B/s", q.get("input_bytes_per_s", 0.0)),
            ("dur.lag", q.get("durability_lag_versions", 0)),
        ]
    if role == "storage":
        # the hot-tag column: this role's busiest read/write tag
        # prefixes, '-' before any tagged traffic has flowed
        rt = (q.get("busiest_read_tag") or {}).get("tag")
        wt = (q.get("busiest_write_tag") or {}).get("tag")
        return [
            ("in B/s", q.get("input_bytes_per_s", 0.0)),
            ("fetch", q.get("fetch_backlog_ranges", 0)),
            ("keys", q.get("keys", block.get("keys", 0))),
            ("sampB", q.get("sampled_bytes", 0)),
            ("hot r/w", f"{rt or '-'}/{wt or '-'}"),
        ]
    if role == "resolver":
        # the kernel panel: cache hit/miss + last compile seconds catch
        # a cold-build stall the moment it happens; the stage p99s say
        # WHERE resolve wall time goes (pack/transfer/kernel/fence)
        k = q.get("kernel") or {}
        stage = k.get("stage_p99_seconds") or {}
        return [
            ("occ", q.get("occupancy", 0.0)),
            ("qwait p99", q.get("queue_wait_dist", {}).get("p99", 0.0)),
            ("kern p99", stage.get("kernel", 0.0)),
            ("fence p99", stage.get("fence", 0.0)),
            ("cc h/m", f"{k.get('compile_cache_hits', 0)}/"
                       f"{k.get('compile_cache_misses', 0)}"),
            ("compile s", k.get("last_compile_seconds", 0.0)),
            # the mesh-sharded columns: shard count, the worst
            # shard's delta-tier fill (the one closest to overflow) and
            # the measured collective (pmin/psum combine) share of
            # per-batch resolve time
            ("shards", k.get("shards", 1)),
            ("worst Δocc", k.get("worst_shard_delta_occupancy", 0.0)),
            ("coll %", round(100 * k.get("collective_time_share", 0.0), 1)),
        ]
    if role == "commit_proxy":
        bs = q.get("batch_sizer", {})
        return [
            ("inflight", q.get("inflight_batches", 0)),
            ("queued", q.get("queued_requests", 0)),
            # scale-out: per-proxyN grant consumption makes an idle
            # recruit visible at a glance
            ("grants", q.get("version_grants", 0)),
            ("interval", bs.get("interval", 0.0)),
            ("count", bs.get("target_count", 0)),
        ]
    if role == "sequencer":
        return [
            ("grants", q.get("grants", 0)),
            ("live v", q.get("live_committed_version", 0)),
            ("tags", q.get("tags", 1)),
            ("proxies", q.get("proxies_seen", 0)),
            ("stale rej", q.get("stale_epoch_rejects", 0)),
        ]
    if role == "grv_proxy":
        bs = q.get("batch_sizer", {})
        return [
            ("grv/s", q.get("grv_per_s", 0.0)),
            ("sheds", q.get("sheds", 0)),
            ("throttled", len(q.get("throttled_tags", []))),
            ("interval", bs.get("interval", 0.0)),
        ]
    if role == "ratekeeper":
        limited = q.get("budget_limited_by") or {}
        streak = q.get("binding_streak") or {}
        return [
            ("by", limited.get("name", "?")),
            # the elasticity trigger's input: how long the binding
            # limiter has held
            ("streak", streak.get("intervals", 0)),
            ("stale", int(bool(q.get("budget_stale")))),
            ("pushes", q.get("rate_pushes", 0)),
            ("polls", q.get("peer_polls", q.get("control_loops", 0))),
        ]
    if role == "cluster_controller":
        out = [
            ("state", q.get("recovery_state", "?")),
            ("recoveries", q.get("recoveries_completed", 0)),
            ("last s", q.get("last_recovery_s") or 0.0),
            ("workers", f"{q.get('workers_live', 0)}/"
                        f"{q.get('workers_registered', 0)}"),
        ]
        if q.get("elastic_enabled"):
            # the elasticity panel: planned resolver count,
            # completed elastic recruits, the live trigger streak
            out.append((
                "elastic",
                f"res={q.get('resolvers_planned', '?')} "
                f"recruits={q.get('elastic_recruits', 0)} "
                f"streak={q.get('elastic_last_streak', 0)}/"
                f"{q.get('elastic_streak_needed', 0)}",
            ))
        return out
    if role == "worker":
        return [
            ("hosted", ",".join(q.get("hosted", [])) or "idle"),
        ]
    return [("version", block.get("version", 0))]


def _census_cols(block: dict) -> list[tuple[str, object]]:
    """The resource-census columns riding every wire process row:
    live connections / asyncio tasks / open fds in that role's OS
    process (runtime/census.py gauges). Absent block (sim rows, grv
    sharing proxy0's process) renders no columns."""
    c = block.get("census")
    if not c:
        return []
    return [
        ("conns", c.get("connections", 0)),
        ("tasks", c.get("tasks", 0)),
        ("fds", c.get("fds", -1)),
    ]


#: heatmap density ticks, lowest to highest
_TICKS = "▁▂▃▄▅▆▇█"


def _heatmap_lines(cl: dict) -> list[str]:
    """The keyspace-heatmap panel: one density bar over the
    cluster's hot ranges (tick height = range's share of sampled bytes,
    scaled to the hottest) plus the busiest-tag rollup — a skewed
    workload reads as one tall tick and one dominant tag."""
    lines = []
    ranges = cl.get("hot_ranges") or []
    if ranges:
        peak = max(r.get("frac", 0.0) for r in ranges) or 1.0
        bar = "".join(
            _TICKS[min(
                len(_TICKS) - 1,
                int(r.get("frac", 0.0) / peak * (len(_TICKS) - 1) + 0.5),
            )]
            for r in ranges
        )
        labels = "  ".join(
            f"{r.get('range', '?')}:{100 * r.get('frac', 0.0):.0f}%"
            for r in ranges[:6]
        )
        lines.append(f"keyspace  {bar}  {labels}")
    tags = cl.get("busiest_tags") or []
    if tags:
        lines.append(
            "busiest tags: " + "  ".join(
                f"{t.get('tag', '?')} {100 * t.get('frac', 0.0):.0f}% "
                f"({t.get('bytes_per_s', 0.0):g} B/s)"
                for t in tags[:4]
            )
        )
    return lines


def render(status: dict, histories: dict[str, MetricHistory],
           t: float) -> str:
    cl = status.get("cluster", {})
    qos = cl.get("qos", {})
    limited = qos.get("performance_limited_by", {})
    lines = []
    tps = qos.get("transactions_per_second_limit")
    budget_by = qos.get("budget_limited_by") or {}
    sheds = sum(
        b.get("qos", {}).get("sheds", 0) or 0
        for b in cl.get("processes", {}).values()
        if b.get("role") == "grv_proxy"
    )
    lines.append(
        "fdbtop — limited by: "
        f"{limited.get('name', '?')}"
        + (f" ({limited.get('reason_server_id')})"
           if limited.get("reason_server_id") else "")
        + f"  pressure={limited.get('pressure', 0.0):.2f}"
        + (f"  tps_limit={tps:g}" if tps is not None else "")
        + (f"  budget by {budget_by['name']}" if budget_by else "")
        + ("  [BUDGET STALE]" if qos.get("budget_stale") else "")
        + (f"  sheds={sheds}" if sheds else "")
    )
    run_loop = cl.get("run_loop")
    if run_loop:
        lines.append(
            f"run loop: {run_loop['utilization'] * 100:5.1f}% busy, "
            f"{run_loop['steps']} steps, "
            f"{run_loop['slow_tasks']} slow tasks"
        )
    lines.extend(_heatmap_lines(cl))
    lines.append(
        f"{'process':<14} {'role':<13} {'gauge':<8} {'value':>9}  "
        f"{'history':<24} detail"
    )
    for name in sorted(cl.get("processes", {})):
        block = cl["processes"][name]
        role = block.get("role", "?")
        path, label = HEADLINE.get(role, ("version", "version"))
        val = block.get("qos", {}).get(path, block.get(path, 0)) or 0
        hist = histories.setdefault(name, MetricHistory(120))
        hist.append(t, float(val))
        detail = "  ".join(
            f"{k}={_fmt(v).strip()}"
            for k, v in _row_metrics(role, block) + _census_cols(block)
        )
        lines.append(
            f"{name:<14} {role:<13} {label:<8} {_fmt(val)}  "
            f"{sparkline(hist.values()):<24} {detail}"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Modes.


def check_status(status: dict, require: list[str], *,
                 census: bool = False) -> list[str]:
    """The smoke gate: every required role present, every process's qos
    non-empty, every role-required sensor key populated. With
    census=True (wire processes only), every role process must also
    carry its CENSUS_SENSORS block. Returns the list of problems (empty
    == healthy)."""
    problems = []
    procs = status.get("cluster", {}).get("processes", {})
    roles_seen = {b.get("role") for b in procs.values()}
    for role in require:
        if role not in roles_seen:
            problems.append(f"no process with role {role!r}")
    for name, block in sorted(procs.items()):
        qos = block.get("qos")
        if not qos:
            problems.append(f"{name}: empty qos block")
            continue
        keys = REQUIRED_SENSORS.get(block.get("role", ""), ())
        if census and block.get("role") != "grv_proxy":
            keys = (*keys, *CENSUS_SENSORS)
        for key in keys:
            # dotted keys descend into nested blocks (kernel.shards);
            # census.* keys live NEXT TO qos in the process block
            node = block if key.startswith("census.") else qos
            missing = False
            for part in key.split("."):
                if not isinstance(node, dict) or part not in node:
                    missing = True
                    break
                node = node[part]
            if missing:
                problems.append(f"{name}: missing sensor {key!r}")
    if "performance_limited_by" not in status.get("cluster", {}).get(
        "qos", {}
    ):
        problems.append("cluster.qos missing performance_limited_by")
    # the skew rollup: both keys must exist at cluster level (empty
    # lists before traffic — absence means the rollup didn't run)
    for key in ("busiest_tags", "hot_ranges"):
        if key not in status.get("cluster", {}):
            problems.append(f"cluster missing {key!r}")
    return problems


async def _wire_main(args) -> int:
    histories: dict[str, MetricHistory] = {}
    dirs = (
        _conf_socket_dirs(args.conf) if args.conf else [args.socket_dir]
    )
    # one connection cache PER socket dir: sockets are keyed by
    # basename, and two dirs may each hold e.g. storage0.sock — a
    # shared cache would silently poll only the first
    conns_by_dir: dict = {d: {} for d in dirs}
    try:
        while True:
            procs_all: dict = {}
            status = None
            for i, d in enumerate(dirs):
                status = await _poll_wire(d, conns_by_dir[d])
                for name, block in status["cluster"]["processes"].items():
                    # same basename in a later dir: suffix, don't drop
                    key = name if name not in procs_all else f"{name}@{i}"
                    procs_all[key] = block
            if len(dirs) > 1:
                from foundationdb_tpu_torch.cluster.status import (
                    assemble_status,
                )

                status = assemble_status(procs_all)
            if args.json:
                print(json.dumps(status, sort_keys=True))
            else:
                if args.watch:
                    print("\x1b[2J\x1b[H", end="")
                print(render(status, histories, time.monotonic()))
            if args.require:
                problems = check_status(status, args.require.split(","))
                if problems:
                    for p in problems:
                        print(f"fdbtop: MISSING SENSOR: {p}",
                              file=sys.stderr)
                    return 1
            if not args.watch:
                return 0
            await asyncio.sleep(args.interval)
    finally:
        for dir_conns in conns_by_dir.values():
            await _close_conns(dir_conns)


def _sim_main(args) -> int:
    world = _SimWorld(seed=args.seed, backend=args.backend)
    histories: dict[str, MetricHistory] = {}
    try:
        while True:
            status = world.poll()
            if args.json:
                print(json.dumps(status, sort_keys=True))
            else:
                if args.watch:
                    print("\x1b[2J\x1b[H", end="")
                print(render(status, histories, world.sched.now()))
            if args.require:
                problems = check_status(status, args.require.split(","))
                if problems:
                    for p in problems:
                        print(f"fdbtop: MISSING SENSOR: {p}",
                              file=sys.stderr)
                    return 1
            if not args.watch:
                return 0
            time.sleep(args.interval)
    finally:
        world.stop()


#: what `--smoke` and `--autotune` still need
NOT_PORTED = {
    "smoke": "fdbtop --smoke spins the pipeline bench, which is not "
             "ported yet (ROADMAP queue 1 item 2)",
    "autotune": "fdbtop --autotune reads the autotune searches of "
                "utils/autotune.py, which is not ported yet (ROADMAP "
                "queue 1 item 8)",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--socket-dir",
                     help="wire mode: dir of role UDS sockets")
    src.add_argument("--conf",
                     help="wire mode: monitor conf naming the roles")
    src.add_argument("--sim", action="store_true",
                     help="in-process sim cluster + demo workload")
    src.add_argument("--smoke", action="store_true",
                     help="the pipeline bench's wire smoke + sensor gate "
                          "(not ported yet)")
    src.add_argument("--autotune", action="store_true",
                     help="summarize autotune experiment rows from the "
                          "perf ledger (not ported yet)")
    ap.add_argument("--watch", action="store_true",
                    help="refresh live until interrupted")
    ap.add_argument("--once", action="store_true",
                    help="one poll then exit (default)")
    ap.add_argument("--json", action="store_true",
                    help="print the raw status JSON instead of the table")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                    help="sim mode: the resolvers' backend (default: the "
                         "card)")
    ap.add_argument(
        "--require", default="",
        help="comma-separated role kinds that must report qos "
             "(exit nonzero on any missing sensor)",
    )
    args = ap.parse_args(argv)
    if args.autotune:
        raise NotImplementedError(NOT_PORTED["autotune"])
    if args.smoke:
        raise NotImplementedError(NOT_PORTED["smoke"])
    if args.sim:
        return _sim_main(args)
    if not args.socket_dir and not args.conf:
        ap.error("one of --socket-dir / --conf / --sim required")
    return asyncio.run(_wire_main(args))


if __name__ == "__main__":
    sys.exit(main())
