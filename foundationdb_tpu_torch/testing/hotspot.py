"""Hotspot drill: the machine-checked keyspace-skew attribution gate (the
port's own copy of foundationdb_tpu.testing.hotspot; each runner takes
one more argument, `device`: where the resolver's conflict set lives,
None = the card, "cpu" = the kernels' plain PyTorch versions).

The sensing substrate (cluster/sampling.py — deterministic byte
sample, busiest-tag counters, resolver key sample) is only telemetry
if its verdict can be trusted in BOTH directions:

* **zipf direction** — a seeded zipf tenant mix (tenant weight
  1/(rank+1)^exponent) concentrates traffic on one injected hot
  tenant. The assembled status document's `cluster.busiest_tags` /
  `cluster.hot_ranges` rollup must attribute that exact tenant top-1
  (sampling.attribute_hotspot).
* **uniform direction** — the SAME drill with a uniform tenant mix
  must NOT flag. A skew detector that can't stay quiet on flat
  traffic is noise, not telemetry.

Both directions run against BOTH deployment shapes: the in-sim cluster
(`cluster_status()`, virtual clock, deterministic per seed) and real
OS role processes over UDS (`wire_cluster_status`, wall clock — the
gate reads only the attribution verdict, which is rate-RATIO robust).
The hotspot drill (drills/hotspot.py) exit-codes on all four legs.

Driven by the `[hotspot]` table of `testing/specs/hotspot.toml`.
"""

from __future__ import annotations

import random

DEFAULTS = {
    "tenants": 8,
    "keys_per_tenant": 64,
    "txns": 600,
    "quick_txns": 300,
    "value_bytes": 2048,
    "zipf_exponent": 2.0,
    "threshold": 0.5,
}


def load_hotspot_config(spec_name: str = "hotspot") -> dict:
    """The `[hotspot]` table of a spec file, over DEFAULTS."""
    import tomllib

    from foundationdb_tpu_torch.testing.spec import SPEC_DIR

    cfg = dict(DEFAULTS)
    path = SPEC_DIR / f"{spec_name}.toml"
    if path.exists():
        with open(path, "rb") as f:
            cfg.update(tomllib.load(f).get("hotspot", {}))
    return cfg


def plan_workload(seed: int, skewed: bool, cfg: dict) -> list[bytes]:
    """The drill's key sequence, precomputed: a pure function of
    (seed, direction, config) — the async workload consumes it without
    touching the rng, so task interleaving can never fork the trace."""
    rng = random.Random(seed * 7919 + (1 if skewed else 0))  # flowcheck: ignore[determinism]
    tenants = [f"tenant{i}" for i in range(int(cfg["tenants"]))]
    if skewed:
        weights = [
            1.0 / (i + 1) ** float(cfg["zipf_exponent"])
            for i in range(len(tenants))
        ]
    else:
        weights = [1.0] * len(tenants)
    kpt = int(cfg["keys_per_tenant"])
    return [
        (f"{t}/k{rng.randrange(kpt):05d}").encode()
        for t in rng.choices(tenants, weights=weights, k=int(cfg["txns"]))
    ]


def _verdict(attr: dict, skewed: bool, hot_tenant: str) -> tuple[bool, str]:
    """The gate rule: skewed must attribute the INJECTED tenant top-1;
    uniform must not attribute anything."""
    named = set()
    if attr.get("hot_tag"):
        named.add(attr["hot_tag"].get("tag"))
    if attr.get("hot_range"):
        named.add(attr["hot_range"].get("range"))
    if skewed:
        if not attr.get("attributed"):
            return False, "skewed mix not attributed"
        if hot_tenant not in named:
            return False, (
                f"attributed {sorted(named)!r}, expected {hot_tenant!r}"
            )
        return True, "attributed the injected tenant"
    if attr.get("attributed"):
        return False, f"uniform mix falsely attributed {sorted(named)!r}"
    return True, "uniform mix stayed quiet"


def _report(path: str, seed: int, skewed: bool, cfg: dict,
            status: dict, committed: int, failed: int,
            sampling: dict, spec_name: str = "hotspot") -> dict:
    from foundationdb_tpu_torch.cluster.sampling import attribute_hotspot

    attr = attribute_hotspot(status, threshold=float(cfg["threshold"]))
    ok, why = _verdict(attr, skewed, "tenant0")
    cl = status.get("cluster", {})
    return {
        "path": path,
        "direction": "zipf" if skewed else "uniform",
        "seed": seed,
        "spec": spec_name,
        "hot_tenant": "tenant0",
        "committed": committed,
        "failed": failed,
        "busiest_tags": (cl.get("busiest_tags") or [])[:4],
        "hot_ranges": (cl.get("hot_ranges") or [])[:4],
        "attribution": attr,
        "sampling": sampling,
        "ok": ok,
        "why": why,
        "config": dict(cfg),
    }


# ---------------------------------------------------------------------------
# Sim path: virtual clock, deterministic per seed.


def run_hotspot_sim(*, seed: int = 0, skewed: bool = True,
                    quick: bool = False, cfg: dict = None,
                    spec_name: str = "hotspot", device=None) -> dict:
    from foundationdb_tpu_torch.cluster.database import ClusterConfig, open_cluster
    from foundationdb_tpu_torch.cluster.status import cluster_status
    from foundationdb_tpu_torch.runtime.flow import Scheduler, all_of

    cfg = dict(cfg or load_hotspot_config(spec_name))
    if quick:
        cfg["txns"] = cfg.get("quick_txns", cfg["txns"])
    keys = plan_workload(seed, skewed, cfg)
    value = b"x" * int(cfg["value_bytes"])

    sched = Scheduler(sim=True)
    _s, cluster, db = open_cluster(
        ClusterConfig(
            n_commit_proxies=1, n_resolvers=1, n_storage=2, sim_seed=seed,
            resolver_backend="cuda", device=device,
        ),
        sched=sched,
    )
    counts = {"committed": 0, "failed": 0}
    try:
        tasks = []

        async def one(key: bytes):
            txn = db.create_transaction()
            txn.set(key, value)
            try:
                await txn.get_read_version()
                await txn.commit()
                counts["committed"] += 1
            except Exception:
                counts["failed"] += 1  # blind writes: conflicts can't

        async def generate():
            for key in keys:
                tasks.append(sched.spawn(one(key), name="hot"))
                await sched.delay(0.002)

        gen = sched.spawn(generate(), name="hotgen")
        sched.run_until(gen.done)
        sched.run_until(all_of([t.done for t in tasks]))
        sched.run_for(0.5)  # settle: smoothers + storage apply drain

        status = cluster_status(cluster)
        sampling = {
            "sample_keys": sum(
                ss.byte_sample.count for ss in cluster.storage_servers
            ),
            "sampled_bytes": sum(
                ss.byte_sample.total_bytes()
                for ss in cluster.storage_servers
            ),
            "byte_sample_writes": sum(
                ss.byte_sample.writes_seen
                for ss in cluster.storage_servers
            ),
            "tag_counter_tags": sum(
                len(ss.read_tags._rates) + len(ss.write_tags._rates)
                for ss in cluster.storage_servers
            ) + sum(
                len(p.write_tags._rates) for p in cluster.commit_proxies
            ),
            "tag_notes": sum(
                ss.read_tags.notes + ss.write_tags.notes
                for ss in cluster.storage_servers
            ) + sum(p.write_tags.notes for p in cluster.commit_proxies),
            "tag_bytes_noted": sum(
                ss.read_tags.bytes_noted + ss.write_tags.bytes_noted
                for ss in cluster.storage_servers
            ) + sum(
                p.write_tags.bytes_noted for p in cluster.commit_proxies
            ),
            "resolver_key_sample_keys": sum(
                len(r._key_sample) for r in cluster.resolvers
            ),
        }
        return _report(
            "sim", seed, skewed, cfg, status,
            counts["committed"], counts["failed"], sampling,
            spec_name=spec_name,
        )
    finally:
        cluster.stop()


# ---------------------------------------------------------------------------
# Wire path: real OS role processes over UDS. Wall clock — only the
# attribution verdict (a rate ratio) gates, never absolute rates.


def run_hotspot_wire(*, seed: int = 0, skewed: bool = True,
                     quick: bool = False, cfg: dict = None,
                     spec_name: str = "hotspot", device=None) -> dict:
    import asyncio  # flowcheck: ignore[determinism]
    import tempfile

    from foundationdb_tpu_torch.cluster import multiprocess as mp
    from foundationdb_tpu_torch.models.types import CommitTransaction
    from foundationdb_tpu_torch.wire.codec import Mutation

    cfg = dict(cfg or load_hotspot_config(spec_name))
    if quick:
        cfg["txns"] = cfg.get("quick_txns", cfg["txns"])
    keys = plan_workload(seed, skewed, cfg)
    value = b"x" * int(cfg["value_bytes"])

    sock_dir = tempfile.mkdtemp(prefix="hotspot_wire_")
    procs = [
        mp.spawn_role("resolver", sock_dir, device=device),
        mp.spawn_role("tlog", sock_dir),
        mp.spawn_role("storage", sock_dir),
    ]
    counts = {"committed": 0, "failed": 0}

    async def scenario():
        resolver = await mp.connect(procs[0].address)
        tlog = await mp.connect(procs[1].address)
        storage = await mp.connect(procs[2].address)
        pipe = mp.ProxyPipeline(
            [resolver], tlog, storage, batch_interval=0.001
        )
        pipe.start()
        try:
            for key in keys:
                rv = await pipe.get_read_version()
                try:
                    await pipe.commit(CommitTransaction(
                        write_conflict_ranges=[(key, key + b"\x00")],
                        read_snapshot=rv,
                        mutations=[Mutation(0, key, value)],
                    ))
                    counts["committed"] += 1
                except Exception:
                    counts["failed"] += 1
            # drain the apply queue so the storage-side sensors (byte
            # sample, write tags) have seen every mutation
            deadline = asyncio.get_event_loop().time() + 10.0  # flowcheck: ignore[determinism]
            while (pipe.applied_version < pipe.committed_version
                   and asyncio.get_event_loop().time() < deadline):  # flowcheck: ignore[determinism]
                await asyncio.sleep(0.05)  # flowcheck: ignore[determinism]
            return await mp.wire_cluster_status(
                {"resolver0": resolver, "tlog0": tlog,
                 "storage0": storage},
                pipe,
            )
        finally:
            await pipe.stop()
            for c in (resolver, tlog, storage):
                await c.close()

    try:
        loop = asyncio.new_event_loop()  # flowcheck: ignore[determinism]
        try:
            status = loop.run_until_complete(scenario())
        finally:
            loop.close()
    finally:
        for p in procs:
            p.stop()

    sq = status["cluster"]["processes"].get("storage0", {}).get("qos", {})
    sampling = {
        "sample_keys": sq.get("sample_keys", 0),
        "sampled_bytes": sq.get("sampled_bytes", 0),
    }
    return _report(
        "wire", seed, skewed, cfg, status,
        counts["committed"], counts["failed"], sampling,
        spec_name=spec_name,
    )


# ---------------------------------------------------------------------------
# The four-leg gate.


def run_hotspot_gate(*, seed: int = 0, quick: bool = False,
                     paths: tuple = ("sim", "wire"),
                     spec_name: str = "hotspot", device=None) -> dict:
    """Both directions on every requested path. `ok` only when the zipf
    legs attribute the injected tenant AND the uniform legs stay quiet
    — the exit-code contract of the hotspot drill."""
    runners = {"sim": run_hotspot_sim, "wire": run_hotspot_wire}
    legs = []
    for path in paths:
        for skewed in (True, False):
            legs.append(runners[path](
                seed=seed, skewed=skewed, quick=quick,
                spec_name=spec_name, device=device,
            ))
    return {
        "seed": seed,
        "spec": spec_name,
        "legs": legs,
        "ok": all(leg["ok"] for leg in legs),
    }
