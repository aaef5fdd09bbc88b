"""Elasticity drill: limiter-driven live resolver recruitment, gated in
both directions (the port's analog of the JAX package's
`scripts/elasticity_drill.py`).

    python -m foundationdb_tpu_torch.drills.elasticity            # both
    python -m foundationdb_tpu_torch.drills.elasticity --smoke
    python -m foundationdb_tpu_torch.drills.elasticity --direction on
    python -m foundationdb_tpu_torch.drills.elasticity --backend cpu

A monitor-supervised wire cluster (controller + workers) starts with one
resolver whose modeled per-transaction compute cost
(`resolver_compute_cost`, the wire twin of the sim's
sim_compute_cost_per_txn) makes resolver occupancy the binding resource.
A load whose clients retry through throttles saturates it; the
Ratekeeper's admission law names `resolver_busy` and holds goodput at
the occupancy-targeted plateau.

ON direction: with `elastic: true` the controller reads the law's
binding_streak off the ratekeeper heartbeat and, after `elastic_streak`
consecutive resolver-limited control intervals, plans a topology with a
second resolver and drives the generation-bumped recovery walk to
recruit it live (reason "elastic:resolver->2"; the boundaries
re-derived, the new proxy clips batches to the 2-way split). Gates: the
recruit happens, post-recruit goodput reaches >= --scale-gate (1.5x) of
the one-resolver plateau, and exact-count consistency holds (unique
keys; unknown fates resolved by readback).

OFF direction: the same load with `elastic: false`: the topology stays
at one resolver, goodput stays at the plateau (<= 1.25x), and the binding
limiter still names resolver_busy at the end.

The resolvers resolve on the card (`--backend cuda`, the default); the
modeled compute cost comes on top of the card's own. `--backend cpu`
(the host oracle) and `--backend native` run where the caller asks. The
run appends one perf-ledger row (utils/perf.py): the recruit, the
consistency, the limiter and OFF's no-recruit are structural, the
plateau and the scaled goodput wall clock.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

from foundationdb_tpu_torch.drills.chaos import (
    BACKENDS,
    _Cluster,
    _read_many,
    _write_monitor_conf,
)


def _write_confs(d: str, args, *, elastic: bool) -> tuple[str, str]:
    cluster_conf = {
        "resolvers": 1,
        "backend": args.backend,
        "tlog_data_dir": os.path.join(d, "tlog-data"),
        "storage_data_dir": os.path.join(d, "storage-data"),
        "ratekeeper": True,
        "trace": False,
        "resolver_compute_cost": args.compute_cost,
        "elastic": elastic,
        "elastic_max_resolvers": 2,
        "elastic_streak": args.streak,
    }
    cpath = os.path.join(d, "cluster.json")
    with open(cpath, "w") as f:
        json.dump(cluster_conf, f)
    # enough workers for the grown topology (2 resolvers) plus a spare
    return _write_monitor_conf(d, cpath, 2 + 4 + 1)


def _key(cid: int, seq: int) -> bytes:
    """Unique a (client, seq), spread uniformly over the byte-prefix
    keyspace so the 2-way resolver split halves each resolver's work (a
    common prefix would land every key in one partition)."""
    return bytes([(seq * 131 + cid * 67) % 256]) + b"el-%d-%d" % (cid, seq)


async def _rk_status(mp, topo: dict) -> dict:
    entry = next(
        (e for e in topo["roles"].values() if e["kind"] == "ratekeeper"),
        None,
    )
    if entry is None:
        return {}
    conn = mp.transport.RpcConnection(entry["address"])
    await conn.connect(retries=2, delay=0.05)
    try:
        reply = await conn.call(
            mp.TOKEN_STATUS, mp.StatusRequest(pad=0), timeout=5.0
        )
        return json.loads(reply.payload).get("qos", {})
    finally:
        await conn.close()


def elastic_cluster(args, elastic: bool) -> _Cluster:
    """One direction's cluster (`_write_confs`) as an async context."""
    return _Cluster(f"elastic_{'on' if elastic else 'off'}_",
                    lambda d: _write_confs(d, args, elastic=elastic),
                    recovery_timeout=30.0)


async def _drive_direction(elastic: bool, args, client,
                           ctrl_addr: str) -> dict:
    """The load, the live watch of the limiter and the recruit, then the
    controller's status, the readback and the goodput windows, on a
    running cluster."""
    from foundationdb_tpu_torch.cluster import generation as gen
    from foundationdb_tpu_torch.cluster import multiprocess as mp
    from foundationdb_tpu_torch.models.types import CommitTransaction
    from foundationdb_tpu_torch.wire.codec import Mutation

    stats = {"committed": 0, "unknown": 0, "conflicted": 0,
             "grv_throttled": 0, "recovering_waits": 0}
    commit_times: list[float] = []
    definite: list[bytes] = []
    unknown: list[bytes] = []
    recruit = {"at": None, "epoch": None, "reason": None}
    limiters_seen: list[str] = []
    epoch0 = client.epoch
    t_start = time.monotonic()
    stop = t_start + args.duration

    async def one_client(cid: int):
        seq = 0
        while time.monotonic() < stop:
            seq += 1
            key = _key(cid, seq)
            try:
                rv = await client.get_read_version()
                txn = CommitTransaction(
                    write_conflict_ranges=[(key, key + b"\x00")],
                    read_conflict_ranges=[(key, key + b"\x00")],
                    read_snapshot=rv,
                    mutations=[Mutation(0, key, b"x")],
                )
                await client.commit(txn)
                stats["committed"] += 1
                definite.append(key)
                commit_times.append(time.monotonic())
            except mp.GrvThrottledError:
                stats["grv_throttled"] += 1
                await asyncio.sleep(0.01)
            except mp.NotCommittedError:
                stats["conflicted"] += 1
            except mp.CommitUnknownError:
                stats["unknown"] += 1
                unknown.append(key)
            except mp.ClusterRecoveringError:
                stats["recovering_waits"] += 1
                await asyncio.sleep(0.1)

    async def watcher():
        """Observe the limiter and (ON) the elastic recruit, live."""
        while time.monotonic() < stop:
            try:
                topo = await client.topology()
                qos = await _rk_status(mp, topo)
                lim = (qos.get("budget_limited_by") or {}).get("name")
                if lim:
                    limiters_seen.append(lim)
                n_res = sum(
                    1 for e in topo["roles"].values()
                    if e["kind"] == "resolver"
                )
                if (recruit["at"] is None and n_res > 1
                        and topo["state"] == gen.FULLY_RECOVERED):
                    recruit["at"] = time.monotonic() - t_start
                    recruit["epoch"] = topo["epoch"]
                    print(f"[elastic] second resolver live at "
                          f"t+{recruit['at']:.1f}s "
                          f"(epoch {topo['epoch']})", flush=True)
            except Exception:
                pass
            await asyncio.sleep(0.2)

    await asyncio.gather(
        watcher(), *(one_client(c) for c in range(args.clients))
    )
    wall = time.monotonic() - t_start

    # the recovery reason and the elastic counters, from the controller
    conn = mp.transport.RpcConnection(ctrl_addr)
    await conn.connect(retries=2, delay=0.05)
    try:
        reply = await conn.call(
            mp.TOKEN_STATUS, mp.StatusRequest(pad=0), timeout=5.0
        )
        q = json.loads(reply.payload)["qos"]
    finally:
        await conn.close()
    recruit["reason"] = q.get("last_recovery_reason")

    # -- consistency: exact count by readback ---------------------------
    await client.connect()
    rv = await client.get_read_version()
    missing = sum(1 for v in await _read_many(client, definite, rv)
                  if v != b"x")
    resolved = sum(1 for v in await _read_many(client, unknown, rv)
                   if v == b"x")

    # -- goodput windows ------------------------------------------------
    warm = args.warmup
    if recruit["at"] is not None:
        # plateau = the throttled steady state: the last few seconds
        # before the recruit (the first seconds after startup still ride
        # the budget clamping down from max_tps), clamped so a recruit
        # landing before the warmup still leaves a non-empty window
        plateau_hi = t_start + recruit["at"]
        warm = min(
            max(warm, recruit["at"] - 3.5),
            max(0.0, recruit["at"] - 1.0),
        )
        post_lo = plateau_hi + args.settle
    else:
        # no recruit: plateau is the first half, "post" the second
        plateau_hi = t_start + warm + (wall - warm) / 2
        post_lo = plateau_hi
    pre = [t for t in commit_times if t_start + warm <= t < plateau_hi]
    post = [t for t in commit_times if t >= post_lo]
    pre_w = plateau_hi - (t_start + warm)
    post_w = max(1e-6, (t_start + wall) - post_lo)
    if pre_w < 0.5:
        # no plateau could be measured (the recruit landed almost at
        # once): a 0-width window would fail every scale gate spuriously
        raise RuntimeError(
            f"recruit at t+{recruit['at']:.1f}s left no plateau "
            "window to measure against; raise --streak (or "
            "--warmup) so the throttled steady state exists first"
        )
    plateau = len(pre) / pre_w
    post_rate = len(post) / post_w
    return {
        "elastic": int(elastic),
        "epoch_before": epoch0,
        "recruited": int(recruit["at"] is not None),
        "recruit_at_s": recruit["at"],
        "recovery_reason": recruit["reason"],
        "elastic_recruits": q.get("elastic_recruits", 0),
        "resolvers_planned": q.get("resolvers_planned"),
        "consistency_ok": int(missing == 0),
        "missing_keys": missing,
        "unknown_resolved_committed": resolved,
        "plateau_txn_s": round(plateau, 1),
        "post_txn_s": round(post_rate, 1),
        "scale": round(post_rate / plateau, 3) if plateau else 0.0,
        "limiter_resolver_busy": int("resolver_busy" in limiters_seen),
        "final_limiter": limiters_seen[-1] if limiters_seen else None,
        "wall_s": round(wall, 2),
        **stats,
    }


async def _run_direction(elastic: bool, args) -> dict:
    """One direction on a fresh cluster."""
    async with elastic_cluster(args, elastic) as c:
        return await _drive_direction(elastic, args, c.client, c.ctrl_addr)


async def _run_direction_gated(elastic: bool, args) -> dict:
    """One direction under the resource-census gate (runtime/census.py):
    the fds, connections and servers this process opened must all be gone
    once the monitor is down, or the drill fails."""
    from foundationdb_tpu_torch.runtime import census

    pre = census.snapshot()
    res = await _run_direction(elastic, args)
    # let the loop drain transport teardown before the post census
    await asyncio.sleep(0.1)
    census.check_drained(
        pre, census.snapshot(),
        label=f"elasticity {'on' if elastic else 'off'}",
    )
    return res


def on_failures(on: dict, args) -> list:
    """The ON direction's gates; returns the failures."""
    failures = on_recruit_failures(on)
    if on["recruited"] and on["scale"] < args.scale_gate:
        failures.append(
            f"ON: post-recruit goodput {on['post_txn_s']} is "
            f"{on['scale']}x the plateau {on['plateau_txn_s']} "
            f"(gate {args.scale_gate}x)"
        )
    return failures


def on_recruit_failures(on: dict) -> list:
    """The ON direction's gates but the wall-clock scale gate: the
    recruit and its elastic reason, the consistency, the limiter."""
    from foundationdb_tpu_torch.cluster.generation import is_elastic_reason

    failures = []
    if not on["recruited"]:
        failures.append("ON: no second resolver was recruited")
    elif not is_elastic_reason(on["recovery_reason"]):
        failures.append(
            f"ON: recovery reason {on['recovery_reason']!r} is "
            "not elastic:"
        )
    if not on["consistency_ok"]:
        failures.append(f"ON: {on['missing_keys']} committed key(s) "
                        "missing")
    if not on["limiter_resolver_busy"]:
        failures.append("ON: resolver_busy never named as the "
                        "binding limiter")
    if on["committed"] == 0:
        failures.append("ON: nothing committed")
    return failures


def off_failures(off: dict) -> list:
    """The OFF direction's gates; returns the failures."""
    failures = []
    if off["recruited"] or off.get("elastic_recruits"):
        failures.append("OFF: a resolver was recruited with "
                        "elasticity disabled")
    if not off["limiter_resolver_busy"]:
        failures.append("OFF: resolver_busy never named as the "
                        "binding limiter")
    if off["final_limiter"] != "resolver_busy":
        failures.append(
            f"OFF: final binding limiter {off['final_limiter']!r} "
            "!= resolver_busy"
        )
    if off["scale"] > 1.25:
        failures.append(
            f"OFF: goodput scaled {off['scale']}x without a recruit"
        )
    if not off["consistency_ok"]:
        failures.append(f"OFF: {off['missing_keys']} committed "
                        "key(s) missing")
    return failures


def _emit_ledger(args, on: dict, off: dict) -> None:
    from foundationdb_tpu_torch.utils import perf

    metrics = {
        "recruits_completed": perf.metric(
            (on or {}).get("recruited", 0), "count", direction="higher",
            tier="structural",
        ),
        "consistency_ok": perf.metric(
            int(all(r["consistency_ok"] for r in (on, off) if r)), "bool",
            direction="higher", tier="structural",
        ),
        # the saturating load must be explained as resolver_busy in the
        # OFF direction (and before the recruit in ON)
        "limiter_resolver_busy": perf.metric(
            int(all(r["limiter_resolver_busy"] for r in (on, off) if r)),
            "bool", direction="higher", tier="structural",
        ),
    }
    if off:
        # only when the OFF direction ran: a one-direction run records no
        # pass for a check it never made
        metrics["off_no_recruit"] = perf.metric(
            int(off["recruited"] == 0), "bool",
            direction="higher", tier="structural",
        )
    if on:
        metrics["goodput_scale"] = perf.metric(
            on["scale"], "ratio", direction="higher"
        )
        metrics["plateau_txn_s"] = perf.metric(
            on["plateau_txn_s"], "txn/s", direction="higher"
        )
        if on.get("recruit_at_s") is not None:
            metrics["recruit_latency_s"] = perf.metric(
                round(on["recruit_at_s"], 2), "s", direction="lower"
            )
    rec = perf.emit(
        "elasticity_drill", metrics,
        workload={
            "clients": args.clients,
            "duration_s": args.duration,
            "compute_cost": args.compute_cost,
            "directions": [
                d for d, r in (("on", on), ("off", off)) if r
            ],
            "backend": args.backend,
        },
        knobs={"streak": args.streak, "mode": args.mode_label},
        ledger=args.perf_ledger,
    )
    print(f"[perf] elasticity ledger row appended "
          f"(recruits={rec['metrics']['recruits_completed']['value']})",
          flush=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--direction", choices=("both", "on", "off"),
                    default="both")
    ap.add_argument("--smoke", action="store_true",
                    help="shorter windows, both directions")
    ap.add_argument("--backend", choices=BACKENDS, default="cuda",
                    help="the resolvers' backend (default: the card)")
    ap.add_argument("--clients", type=int, default=24)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--compute-cost", type=float, default=0.004,
                    help="modeled resolver seconds per local txn")
    ap.add_argument("--streak", type=int, default=8,
                    help="consecutive resolver-limited control "
                         "intervals before the controller recruits")
    ap.add_argument("--warmup", type=float, default=3.0)
    ap.add_argument("--settle", type=float, default=3.0,
                    help="seconds after the recruit before the scaled "
                         "window opens (budget recovery)")
    ap.add_argument("--scale-gate", type=float, default=1.5)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--perf-ledger", default=None)
    ap.add_argument("--no-perf", action="store_true")
    return ap


def smoke_args(args) -> None:
    """`--smoke`'s settings. The client count is not cut: the scaled
    window's goodput must be capacity-limited (two resolvers' worth),
    not offered-load-limited, for the 1.5x gate to measure the recruit
    and not the workload."""
    args.duration = min(args.duration, 18.0)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    args.mode_label = "smoke" if args.smoke else "drill"
    if args.smoke:
        smoke_args(args)

    if args.backend == "cuda":
        from foundationdb_tpu_torch import kernels

        # once, here: the workers' resolvers load the built libraries
        kernels.build_all()
    failures = []
    on = off = None
    if args.direction in ("both", "on"):
        print("== elasticity ON: saturate one resolver, expect a live "
              "recruit ==", flush=True)
        on = asyncio.run(_run_direction_gated(True, args))
        print(json.dumps(on), flush=True)
        failures += on_failures(on, args)
    if args.direction in ("both", "off"):
        print("== elasticity OFF: same load must stay pinned at the "
              "plateau ==", flush=True)
        off = asyncio.run(_run_direction_gated(False, args))
        print(json.dumps(off), flush=True)
        failures += off_failures(off)

    if args.json_out:
        with open(args.json_out, "a") as f:
            for r in (on, off):
                if r:
                    f.write(json.dumps(r) + "\n")
    if not args.no_perf:
        _emit_ledger(args, on, off)
    if failures:
        print(f"elasticity FAILED: {failures}", flush=True)
        return 1
    parts = []
    if on:
        parts.append(f"ON scaled {on['scale']}x after a live recruit at "
                     f"t+{on['recruit_at_s']:.1f}s")
    if off:
        parts.append(f"OFF pinned at {off['plateau_txn_s']} txn/s, "
                     f"limited by {off['final_limiter']}")
    print(f"elasticity ok ({'; '.join(parts)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
