"""Cluster status: the machine-readable health and metrics document
(the port's own copy of foundationdb_tpu.cluster.status).

Behavioral mirror of `fdbserver/Status.actor.cpp` (schema shape from
fdbclient/Schemas.cpp): one JSON-able dict aggregating every role's
counters, versions, latencies and configuration, what `fdbcli status`
and monitoring consume. The `processes` section carries one entry per
role instance (role kind, version, counters, latency distributions, and
a `qos` saturation block from the role's `saturation()` sensors);
`cluster.latency_bands` rolls the reference-style commit/GRV/read bands
up across role instances; `cluster.resolver_kernel` surfaces each
resolver's always-on kernel stage metrics (models/conflict_set.py
KernelStageMetrics); `cluster.qos` is the reference's qos section:
worst storage/tlog queue health, worst version lag, the Ratekeeper's
live budget, and `performance_limited_by` naming the process class
closest to saturation. The same qos math serves the wire-mode
aggregation (cluster/multiprocess.py `wire_cluster_status`).

Against the JAX module: `configuration.resolver_backend` is the port's
backend name ("cuda" or "cpu", where JAX writes "tpu" for its unset
knob), and `resolver_kernel` reports the port's conflict set class
(`TorchConflictSet`) and its KernelStageMetrics."""

from __future__ import annotations

from typing import Any

# ---------------------------------------------------------------------------
# Saturation budgets: the denominators that turn raw sensor readings into
# comparable pressure scores (the reference's analogs live in ServerKnobs —
# TARGET_BYTES_PER_TLOG, MAX_TL_SS_VERSION_DIFFERENCE, ...). Status readers
# expect stable semantics, so these are module constants, not knobs.

#: retained tlog queue bytes at which the log counts as saturated
#: (the reference throttles toward TARGET_BYTES_PER_TLOG = 2.4 GB; the
#: sim tlog spills to its simdisk long before that, so the budget here
#: is sized to the in-memory retention the spill discipline allows)
TLOG_QUEUE_BYTES_TARGET = 64 << 20
#: resolver batches waiting on the version chain at which resolution is
#: the bottleneck (the wire pipeline caps in-flight batches at the
#: MAX_PIPELINED_COMMIT_BATCHES knob = 8; a full chain means every
#: pipeline slot is parked on the resolver)
RESOLVER_QUEUE_TARGET = 8
#: commit requests queued at one proxy before admission is overdue
PROXY_QUEUE_TARGET = 4096
#: GRV requests queued at the front door before reads are being gated
GRV_QUEUE_TARGET = 4096

#: performance_limited_by reason ids (the reference's limitReason names,
#: Ratekeeper.actor.cpp limitReasonName[]) -> human description
QOS_REASONS = {
    "workload": "The database is not being saturated by the workload.",
    "storage_server_durability_lag": (
        "Storage server durability lag is approaching the MVCC window."
    ),
    "log_server_write_queue": (
        "The write queue at a log server is approaching its budget."
    ),
    "resolver_queue": (
        "Commit batches are queueing on conflict resolution."
    ),
    "resolver_busy": (
        "Conflict-resolution compute is saturating a resolver."
    ),
    "commit_proxy_queue": (
        "Commit requests are queueing at a commit proxy."
    ),
    "grv_proxy_queue": (
        "Read-version requests are queueing at the GRV proxy."
    ),
    # the Ratekeeper's fail-safe direction (one vocabulary: the budget's
    # binding limiter and performance_limited_by share these ids)
    "ratekeeper_failsafe": (
        "The Ratekeeper's sensor feed is stale or no storage replica is "
        "live; admission is clamped toward the fail-safe floor."
    ),
}


def performance_limited_by(
    candidates: list[tuple[str, str, float]],
) -> dict[str, Any]:
    """The status schema's `performance_limited_by` block.

    `candidates` are (process_name, reason_id, score) with score
    normalized against that sensor's budget (1.0 = at budget). The
    worst score past 0.5 names the limiting process; below that the
    cluster is workload-limited (the reference's healthy default)."""
    name, reason, score = "", "workload", 0.0
    for proc, rid, s in candidates:
        if s > score:
            name, reason, score = proc, rid, s
    if score < 0.5:
        name, reason = "", "workload"
    return {
        "name": reason,
        "description": QOS_REASONS[reason],
        "reason_server_id": name,
        "pressure": round(score, 4),
    }


def qos_pressures(
    tlogs: dict[str, dict],
    storages: dict[str, dict],
    resolvers: dict[str, dict],
    proxies: dict[str, dict],
    grvs: dict[str, dict],
    *,
    lag_target: float,
) -> list[tuple[str, str, float]]:
    """Normalized saturation candidates from per-process qos blocks
    (one shared scoring path for sim and wire assembly). Each block is
    the role's `saturation()` dict; missing keys score zero so partial
    wire blocks degrade to 'not limiting', never crash the status."""
    out = []
    for name, q in tlogs.items():
        out.append((
            name, "log_server_write_queue",
            q.get("smoothed_queue_bytes", 0.0) / TLOG_QUEUE_BYTES_TARGET,
        ))
    for name, q in storages.items():
        out.append((
            name, "storage_server_durability_lag",
            q.get("version_lag_versions", q.get("apply_lag_versions", 0))
            / max(lag_target, 1.0),
        ))
    for name, q in resolvers.items():
        out.append((
            name, "resolver_queue",
            q.get("queue_depth", 0) / RESOLVER_QUEUE_TARGET,
        ))
        # busy fraction: the Ratekeeper's actual resolver input. A
        # saturated resolver forms few, huge batches — queue depth stays
        # low while compute occupies ~the whole wall clock, so the
        # queue candidate alone mis-attributes to 'workload'.
        out.append((name, "resolver_busy", q.get("occupancy", 0.0)))
    for name, q in proxies.items():
        out.append((
            name, "commit_proxy_queue",
            q.get("queued_requests", 0) / PROXY_QUEUE_TARGET,
        ))
    for name, q in grvs.items():
        out.append((
            name, "grv_proxy_queue",
            q.get("queued_requests", 0) / GRV_QUEUE_TARGET,
        ))
    return out


def qos_section(
    tlogs: dict[str, dict],
    storages: dict[str, dict],
    resolvers: dict[str, dict],
    proxies: dict[str, dict],
    grvs: dict[str, dict],
    *,
    lag_target: float,
    ratekeeper: dict | None = None,
) -> dict[str, Any]:
    """The reference's status `qos` section from per-process qos blocks:
    worst storage/tlog queue health, worst version lag, the limiting
    process, and (when present) the Ratekeeper's live budget — ONE
    assembly path shared by the sim `cluster_status()` and the wire-mode
    aggregation, so fdbtop renders one schema for both."""

    def _worst(blocks: dict[str, dict], key: str, default=0):
        vals = [q.get(key, default) for q in blocks.values()]
        return max(vals) if vals else default

    cands = qos_pressures(
        tlogs, storages, resolvers, proxies, grvs, lag_target=lag_target
    )
    limited = performance_limited_by(cands)
    out: dict[str, Any] = {
        "worst_queue_bytes_log_server": _worst(tlogs, "queue_bytes"),
        "worst_smoothed_queue_bytes_log_server": _worst(
            tlogs, "smoothed_queue_bytes", 0.0
        ),
        "worst_durability_lag_log_server": _worst(
            tlogs, "durability_lag_versions"
        ),
        "worst_version_lag_storage_server": _worst(
            storages, "version_lag_versions"
        ),
        "worst_queue_depth_resolver": _worst(resolvers, "queue_depth"),
        "worst_occupancy_resolver": _worst(resolvers, "occupancy", 0.0),
        "worst_queued_requests_commit_proxy": _worst(
            proxies, "queued_requests"
        ),
        "worst_queued_requests_grv_proxy": _worst(grvs, "queued_requests"),
        "limiting_process": limited["reason_server_id"],
        "performance_limited_by": limited,
    }
    if ratekeeper is not None:
        out.update(ratekeeper)
    return out


def sampling_rollup(
    storages: dict[str, dict],
    proxies: dict[str, dict],
) -> dict[str, Any]:
    """`cluster.busiest_tags` + `cluster.hot_ranges` from per-role qos
    blocks — ONE rollup path shared by the sim
    `cluster_status()` and the wire `assemble_status`, so the
    skew-attribution gate reads the same document shape on both.

    Tag fractions are re-normalized GLOBALLY: each role's busiest-tag
    row carries its LOCAL frac (share of that role's traffic), which
    can be high on a storage role that merely owns few shards — so the
    rollup reconstructs each role's total rate as `bytes_per_s / frac`
    and divides the tag's summed rate by the summed totals. A uniform
    workload therefore stays flat at cluster level even when individual
    storage roles see locally-dominant tags."""
    tag_rate: dict[str, float] = {}
    denom = 0.0
    rows = [
        (q.get(field) or {})
        for q in list(storages.values()) + list(proxies.values())
        for field in ("busiest_read_tag", "busiest_write_tag")
    ]
    for row in rows:
        rate = float(row.get("bytes_per_s") or 0.0)
        frac = float(row.get("frac") or 0.0)
        denom += rate / frac if frac > 1e-9 else rate
        tag = row.get("tag")
        if tag is not None:
            tag_rate[tag] = tag_rate.get(tag, 0.0) + rate
    busiest_tags = sorted(
        (
            {
                "tag": t,
                "bytes_per_s": round(r, 3),
                "frac": round(r / denom, 4) if denom > 1e-9 else 0.0,
            }
            for t, r in tag_rate.items()
        ),
        key=lambda r: (-r["bytes_per_s"], r["tag"]),
    )[:8]
    # hot ranges: merge the storage samples' rows by range label —
    # bytes sum, bounds widen, frac re-normalized over the merged total
    ranges: dict[str, list] = {}
    for q in storages.values():
        for row in q.get("hot_ranges") or []:
            label = row.get("range", "")
            g = ranges.get(label)
            b = int(row.get("bytes") or 0)
            k = int(row.get("keys") or 0)
            if g is None:
                ranges[label] = [
                    b, row.get("begin", ""), row.get("end", ""), k
                ]
            else:
                g[0] += b
                g[1] = min(g[1], row.get("begin", ""))
                g[2] = max(g[2], row.get("end", ""))
                g[3] += k
    total = sum(g[0] for g in ranges.values())
    hot_ranges = sorted(
        (
            {
                "range": label,
                "begin": g[1],
                "end": g[2],
                "bytes": g[0],
                "keys": g[3],
                "frac": round(g[0] / total, 4) if total > 0 else 0.0,
            }
            for label, g in ranges.items()
        ),
        key=lambda r: (-r["bytes"], r["range"]),
    )[:8]
    return {"busiest_tags": busiest_tags, "hot_ranges": hot_ranges}


#: role kind (the per-process "role" field) -> the qos_section argument
#: slot its block feeds; unknown kinds simply don't contribute pressure
_QOS_SLOT = {
    "log": "tlogs",
    "storage": "storages",
    "resolver": "resolvers",
    "commit_proxy": "proxies",
    "grv_proxy": "grvs",
}


def assemble_status(
    processes: dict[str, dict],
    *,
    lag_target: float = 2_000_000.0,
    ratekeeper: dict | None = None,
    cluster_extra: dict | None = None,
) -> dict[str, Any]:
    """Assemble a reference-shaped status document from per-process
    blocks — the wire-mode path (cluster/multiprocess.py
    `wire_cluster_status` and scripts/fdbtop.py): each block is one
    role's StatusReply payload `{"role": kind, "qos": {...}, ...}`.
    Blocks with unknown roles or missing qos keys degrade to
    'not limiting' — a half-started cluster still renders."""
    slots: dict[str, dict[str, dict]] = {
        "tlogs": {}, "storages": {}, "resolvers": {},
        "proxies": {}, "grvs": {},
    }
    for name, block in processes.items():
        slot = _QOS_SLOT.get(block.get("role", ""))
        if slot is not None:
            # the live dict, so the join below lands in the document
            slots[slot][name] = block.setdefault("qos", {})
        elif block.get("role") == "ratekeeper" and ratekeeper is None:
            # a wire RatekeeperRole's status block IS the qos
            # ratekeeper payload (budget, binding limiter, fail-safe
            # state) — merge it like the sim path merges rk.status()
            ratekeeper = block.get("qos", {})
    # version-lag join: a storage process doesn't know the committed
    # head — derive it from the proxy/log blocks (the reference's
    # Status.actor.cpp joins the same way) and fill
    # version_lag_versions into any storage block missing it
    head = 0
    for block in processes.values():
        if block.get("role") == "commit_proxy":
            head = max(head, block.get("committed_version", 0))
        elif block.get("role") == "log":
            head = max(head, block.get("version", 0))
    for name, q in slots["storages"].items():
        if "version_lag_versions" not in q:
            v = processes[name].get("version")
            if v is not None:
                q["version_lag_versions"] = max(0, head - v)
    data: dict[str, Any] = {
        "cluster": {
            "qos": qos_section(
                slots["tlogs"], slots["storages"], slots["resolvers"],
                slots["proxies"], slots["grvs"],
                lag_target=lag_target, ratekeeper=ratekeeper,
            ),
            "processes": processes,
            # keyspace-skew rollup: the skew-attribution
            # gate's input, shared math with the sim path
            **sampling_rollup(slots["storages"], slots["proxies"]),
        }
    }
    if cluster_extra:
        data["cluster"].update(cluster_extra)
    return data


def _merge_bands(bands_list) -> dict[str, int]:
    """Sum LatencyBands dicts across role instances (identical edges by
    construction — the thresholds are module constants)."""
    out: dict[str, int] = {}
    for b in bands_list:
        for k, v in b.as_dict().items():
            out[k] = out.get(k, 0) + v
    return out


def _compile_cache_section() -> dict[str, Any]:
    from foundationdb_tpu_torch.utils import compile_cache

    return compile_cache.stats()


def _census_snapshot(sched=None) -> dict[str, int]:
    from foundationdb_tpu_torch.runtime import census

    return census.snapshot(sched)


def _kernel_section(resolver) -> dict[str, Any]:
    cs = resolver.conflict_set
    metrics = getattr(cs, "metrics", None)
    if metrics is None:
        return {"backend": "unrouted"}
    return {
        "backend": type(cs).__name__,
        **metrics.as_dict(),
    }


def cluster_status(cluster) -> dict[str, Any]:
    seq = cluster.sequencer
    cfg = cluster.config
    rk = cluster.ratekeeper
    # per-role saturation blocks (each role's `saturation()` sensors);
    # the storage blocks gain the CLUSTER-level version lag here — the
    # distance behind the sequencer head is derivable only where the
    # head is known (Status.actor.cpp does the same join)
    tlog_qos = {
        f"tlog{i}": cluster.tlog.tlogs[i].saturation()
        for i in range(cfg.n_tlogs)
    }
    storage_qos = {
        f"storage{i}": {
            **ss.saturation(),
            "version_lag_versions": max(0, seq.version - ss.version.get()),
        }
        for i, ss in enumerate(cluster.storage_servers)
    }
    resolver_qos = {
        f"resolver{i}": r.saturation()
        for i, r in enumerate(cluster.resolvers)
    }
    proxy_qos = {
        f"proxy{i}": p.saturation()
        for i, p in enumerate(cluster.commit_proxies)
    }
    grv_qos = {"grv_proxy0": cluster.grv_proxy.saturation()}
    data = {
        "cluster": {
            "configuration": {
                "commit_proxies": len(cluster.commit_proxies),
                "grv_proxies": cfg.n_grv_proxies,
                "resolvers": len(cluster.resolvers),
                "storage_servers": len(cluster.storage_servers),
                "logs": cfg.n_tlogs,
                "coordinators": cfg.n_coordinators,
                "resolver_backend": cfg.resolver_backend,
            },
            "datacenter_lag": {"versions": 0},
            "latest_version": seq.version,
            "live_committed_version": seq.live_committed.get(),
            # the reference's qos section (Schemas.cpp `qos`): worst
            # queue/lag across role instances, the limiting process,
            # and the Ratekeeper's live budget + quota tiers
            "qos": qos_section(
                tlog_qos, storage_qos, resolver_qos, proxy_qos, grv_qos,
                lag_target=rk.lag_target, ratekeeper=rk.status(),
            ),
            # run-loop utilization + slow-task ledger (WALL-clock by
            # design: it measures how busy this OS process's loop is;
            # status readers surface it, traced output never does)
            "run_loop": cluster.sched.run_loop_stats(),
            # live resource census (runtime/census.py): fds straight
            # off /proc, transport gauges, the Scheduler's live-task
            # count — the leak gate's gauges, surfaced for operators.
            # Status-only, like run_loop: never lands in traces.
            "census": _census_snapshot(sched=cluster.sched),
            "workload": {
                "transactions": {
                    "committed": sum(
                        p.counters.get("txnCommitOut")
                        for p in cluster.commit_proxies
                    ),
                    "conflicted": sum(
                        p.counters.get("txnConflicts")
                        for p in cluster.commit_proxies
                    ),
                    "started": sum(
                        p.counters.get("txnCommitIn")
                        for p in cluster.commit_proxies
                    ),
                },
                "grv": cluster.grv_proxy.counters.as_dict(),
            },
            # reference-style latency bands (fdbrpc/Stats.h LatencyBands
            # -> the status schema's latency_statistics buckets), rolled
            # up across role instances
            "latency_bands": {
                "commit": _merge_bands(
                    p.latency_bands for p in cluster.commit_proxies
                ),
                "grv": _merge_bands([cluster.grv_proxy.latency_bands]),
                "read": _merge_bands(
                    ss.read_latency_bands for ss in cluster.storage_servers
                ),
            },
            # each resolver's always-on kernel stage metrics
            # (pack/transfer/kernel/fence, tier occupancy, compactions,
            # latch/fallback counts, overflow events)
            "resolver_kernel": {
                f"resolver{r.resolver_id}": _kernel_section(r)
                for r in cluster.resolvers
            },
            # process-global compile observability: the
            # persistent-cache hit/miss counters, backend-compile
            # seconds, and per-signature compile times — the "why did
            # that batch stall" panel for cold-jit pathologies
            "compile_cache": _compile_cache_section(),
            # keyspace-skew rollup: busiest_tags (globally
            # re-normalized tag fractions) + hot_ranges (merged storage
            # byte-sample density) — same math as the wire assembly
            **sampling_rollup(storage_qos, proxy_qos),
            "processes": {},
        }
    }
    procs = data["cluster"]["processes"]
    for i, r in enumerate(cluster.resolvers):
        procs[f"resolver{i}"] = {
            "role": "resolver",
            "version": r.version.get(),
            "counters": r.counters.as_dict(),
            "latency": {
                "resolver": r.resolver_latency.as_dict(),
                "queue_wait": r.queue_wait_latency.as_dict(),
                "compute": r.compute_time.as_dict(),
            },
            "kernel": _kernel_section(r),
            "total_state_bytes": r.total_state_bytes,
            "qos": resolver_qos[f"resolver{i}"],
        }
    for i, p in enumerate(cluster.commit_proxies):
        procs[f"proxy{i}"] = {
            "role": "commit_proxy",
            "committed_version": p.committed_version.get(),
            "counters": p.counters.as_dict(),
            "latency": {"commit": p.commit_latency.as_dict()},
            "latency_bands": p.latency_bands.as_dict(),
            "failed": p.failed is not None,
            "qos": proxy_qos[f"proxy{i}"],
        }
    procs["grv_proxy0"] = {
        "role": "grv_proxy",
        "counters": cluster.grv_proxy.counters.as_dict(),
        "latency": {"grv": cluster.grv_proxy.grv_latency.as_dict()},
        "latency_bands": cluster.grv_proxy.latency_bands.as_dict(),
        "qos": grv_qos["grv_proxy0"],
    }
    for i, ss in enumerate(cluster.storage_servers):
        procs[f"storage{i}"] = {
            "role": "storage",
            "version": ss.version.get(),
            "durable_version": ss.durable_version,
            "keys": len(ss._keys),
            "latency": {"read": ss.read_latency.as_dict()},
            "latency_bands": ss.read_latency_bands.as_dict(),
            "live": cluster.storage_live[i],
            "qos": storage_qos[f"storage{i}"],
        }
    for i in range(cfg.n_tlogs):
        procs[f"tlog{i}"] = {
            "role": "log",
            "version": cluster.tlog.tlogs[i].version.get(),
            "live": bool(cluster.tlog.live[i]),
            "qos": tlog_qos[f"tlog{i}"],
        }
    procs["sequencer"] = {
        "role": "master",
        "version": seq.version,
        # the sequencer's saturation surface: how far live-committed
        # visibility trails allocation (a growing gap means committed
        # batches aren't reporting back — the recovery-fence symptom)
        "qos": {
            "version": seq.version,
            "live_committed_version": seq.live_committed.get(),
            "allocation_gap_versions": max(
                0, seq.version - seq.live_committed.get()
            ),
        },
    }
    return data
