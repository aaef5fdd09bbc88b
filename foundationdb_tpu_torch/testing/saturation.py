"""Saturation ramp: the machine-checked overload-survival SLO (the port's
own copy of foundationdb_tpu.testing.saturation; `run_saturation` takes
two more arguments, `resolver_backend` and `device`).

The ROADMAP's admission-control item asks for more than a control loop —
it asks for a GATE: "ramp offered load past capacity and gate on p99
stays in band and throughput degrades gracefully instead of
collapsing". This module is that gate, driven by the `[saturation]`
table of `testing/specs/saturation.toml`:

* The cluster gets a FINITE capacity on the virtual clock (a modeled
  per-transaction resolver cost, `Resolver.sim_compute_cost_per_txn`),
  because an unmodeled sim resolves instantaneously and cannot
  saturate.
* An OPEN-LOOP generator offers transactions at multiples of that
  capacity (arrivals don't wait for completions — the load shape that
  collapses closed systems).
* Per ramp step it measures offered/admitted/committed rates, sheds,
  too-old aborts, and the client-observed commit latency distribution
  of admitted transactions (GRV throttle delay deliberately excluded:
  delaying at the front door is the MECHANISM, not the failure).
* The SLO gate: at overload steps, commit p99 must stay inside
  `commit_p99_band_s` and goodput must hold >= `min_goodput_frac` of
  the peak. With admission control ON the gate must PASS; with the
  ratekeeper disconnected the same ramp must VIOLATE it (both
  directions run by the saturation drill, drills/saturation.py).

Everything runs on the virtual clock in one deterministic simulation,
so the gate is exactly reproducible per seed.

The cluster's resolver is `resolver_backend`: "cuda" (the default) is
the port's conflict set on `device` (None = the card, "cpu" = the
kernels' plain PyTorch versions, the same report), "cpu" the host
oracle. The JAX ramp takes its backend from the knob, whose gate sends
this 64-txn configuration to the host oracle; its "tpu-force" gives the
port's "cuda" report. The two differ only where a batch outgrows the
kernel configuration's 64 transactions: the unthrottled overload step
of the admission-OFF ramp, whose oversized batches fail to pack on the
device path (CommitUnknownResult, counted `failed_other`).
"""

from __future__ import annotations

DEFAULTS = {
    "compute_cost_per_txn": 0.004,
    "window_versions": 1_000_000,
    "grv_max_queue": 64,
    "control_interval": 0.05,
    "ramp": [0.5, 1.0, 2.0, 3.0],
    "step_seconds": 3.0,
    "overload_from": 2.0,
    "quick_ramp": [1.0, 3.0],
    "quick_step_seconds": 1.5,
    "commit_p99_band_s": 0.5,
    "min_goodput_frac": 0.7,
}


def load_saturation_config(spec_name: str = "saturation") -> dict:
    """The `[saturation]` table of a spec file, over DEFAULTS."""
    import tomllib

    from foundationdb_tpu_torch.testing.spec import SPEC_DIR

    cfg = dict(DEFAULTS)
    path = SPEC_DIR / f"{spec_name}.toml"
    if path.exists():
        with open(path, "rb") as f:
            cfg.update(tomllib.load(f).get("saturation", {}))
    return cfg


def _pctl(samples: list, q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, int(len(s) * q))]


def run_saturation(
    *,
    admission: bool = True,
    seed: int = 0,
    quick: bool = False,
    cfg: dict = None,
    spec_name: str = "saturation",
    resolver_backend: str = "cuda",
    device=None,
) -> dict:
    """One deterministic saturation ramp; returns the report dict with
    per-step rows and the SLO gate verdict under `slo`."""
    from foundationdb_tpu_torch.cluster.commit_proxy import (
        CommitUnknownResult,
        NotCommitted,
        TransactionTooOldError,
    )
    from foundationdb_tpu_torch.cluster.database import ClusterConfig, open_cluster
    from foundationdb_tpu_torch.cluster.grv_proxy import (
        GrvProxyFailedError,
        GrvThrottledError,
    )
    from foundationdb_tpu_torch.runtime.flow import Scheduler, all_of
    from foundationdb_tpu_torch.utils.metrics import Smoother

    cfg = {**load_saturation_config(spec_name), **(cfg or {})}
    ramp = cfg["quick_ramp"] if quick else cfg["ramp"]
    step_s = cfg["quick_step_seconds"] if quick else cfg["step_seconds"]
    cost = float(cfg["compute_cost_per_txn"])
    capacity = 1.0 / cost

    from foundationdb_tpu_torch.cluster.database import ClusterConfig as _CC

    sched = Scheduler(sim=True)
    _s, cluster, db = open_cluster(
        ClusterConfig(
            n_commit_proxies=1,
            n_resolvers=1,
            n_storage=2,
            sim_seed=seed,
            kernel_config=_CC.kernel_config.scaled(
                window_versions=int(cfg["window_versions"])
            ),
            resolver_backend=resolver_backend,
            device=device,
        ),
        sched=sched,
    )
    try:
        rk = cluster.ratekeeper
        grv = cluster.grv_proxy
        # finite capacity + ramp-tuned control: the resolver costs
        # `cost` virtual seconds per txn; the control loop runs at the
        # ramp cadence and the occupancy smoother tightens so the
        # busy-fraction signal tracks inside one step
        for r in cluster.resolvers:
            r.sim_compute_cost_per_txn = cost
            r.occupancy = Smoother(0.5, clock=sched.now)
        rk.interval = float(cfg["control_interval"])
        grv.max_queue = int(cfg["grv_max_queue"])
        if not admission:
            # the OFF direction: no budget at the front door at all
            # (stopping the ratekeeper alone would fail SAFE and still
            # throttle — exactly the robustness this flag must bypass
            # to demonstrate the collapse)
            grv.ratekeeper = None

        steps = []
        for mult in ramp:
            rate = mult * capacity
            row = {
                "offered_tps": round(rate, 1),
                "multiplier": mult,
                "offered": 0,
                "admitted": 0,
                "committed": 0,
                "shed": 0,
                "too_old": 0,
                "conflicted": 0,
                "failed_other": 0,
            }
            lat: list[float] = []
            tasks = []
            n_txns = int(rate * step_s)
            t_start = sched.now()

            async def one_txn(i: int, row=row, lat=lat):
                row["offered"] += 1
                txn = db.create_transaction()
                # unique key per txn: conflicts can't pollute the
                # overload signal; the self read-conflict range makes
                # the MVCC window bite exactly like a real RMW
                key = b"sat%08d" % i
                txn.set(key, b"v")
                txn.add_read_conflict_range(key, key + b"\x00")
                try:
                    await txn.get_read_version()
                except GrvThrottledError:
                    row["shed"] += 1
                    return
                except GrvProxyFailedError:
                    row["failed_other"] += 1
                    return
                row["admitted"] += 1
                t0 = sched.now()
                try:
                    await txn.commit()
                except TransactionTooOldError:
                    row["too_old"] += 1
                    return
                except NotCommitted:
                    row["conflicted"] += 1
                    return
                except (CommitUnknownResult, GrvProxyFailedError):
                    row["failed_other"] += 1
                    return
                row["committed"] += 1
                lat.append(sched.now() - t0)

            async def generate():
                # open loop: arrivals at fixed spacing, regardless of
                # completions — offered load is EXOGENOUS
                for i in range(n_txns):
                    tasks.append(
                        sched.spawn(one_txn(i), name=f"sat{mult}-{i}")
                    )
                    await sched.delay(1.0 / rate)

            gen = sched.spawn(generate(), name=f"satgen{mult}")
            sched.run_until(gen.done)
            # drain: every offered txn resolves (commit, shed or abort)
            sched.run_until(all_of([t.done for t in tasks]))
            wall = max(sched.now() - t_start, 1e-9)
            row["virtual_s"] = round(wall, 3)
            row["goodput_tps"] = round(row["committed"] / wall, 1)
            row["commit_p50_s"] = round(_pctl(lat, 0.50), 4)
            row["commit_p99_s"] = round(_pctl(lat, 0.99), 4)
            steps.append(row)
            sched.run_for(1.0)  # settle between steps

        peak = max((s["goodput_tps"] for s in steps), default=0.0)
        overload = [
            s for s in steps if s["multiplier"] >= cfg["overload_from"]
        ]
        band = float(cfg["commit_p99_band_s"])
        frac = float(cfg["min_goodput_frac"])
        violations = []
        for s in overload:
            if s["commit_p99_s"] > band:
                violations.append(
                    f"{s['multiplier']}x: commit p99 "
                    f"{s['commit_p99_s']}s > band {band}s"
                )
            if peak > 0 and s["goodput_tps"] < frac * peak:
                violations.append(
                    f"{s['multiplier']}x: goodput {s['goodput_tps']} "
                    f"tps collapsed below {frac:.0%} of peak {peak} tps"
                )
        return {
            "spec": spec_name,
            "seed": seed,
            "admission": admission,
            "capacity_tps": round(capacity, 1),
            "config": {
                k: cfg[k]
                for k in (
                    "compute_cost_per_txn", "window_versions",
                    "grv_max_queue", "commit_p99_band_s",
                    "min_goodput_frac", "overload_from",
                )
            },
            "ramp": list(ramp),
            "step_seconds": step_s,
            "steps": steps,
            "peak_goodput_tps": peak,
            "ratekeeper": rk.status() if admission else None,
            "slo": {
                "commit_p99_band_s": band,
                "min_goodput_frac": frac,
                "violations": violations,
                "passed": not violations,
            },
        }
    finally:
        cluster.stop()
