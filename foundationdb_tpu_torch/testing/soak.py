"""Seed-sweeping soak ensemble: Joshua in miniature (the port's own copy of
foundationdb_tpu.testing.soak, with one more argument to `run_seed`:
`device`).

One seed = one deterministic simulated-cluster run with a SPEC-derived
cluster shape, seed-randomized knobs (the reference's `randomize &&
BUGGIFY` discipline, fdbclient/ServerKnobs.cpp), and a spec-derived fault
mix (clogging, storage reboots, shard moves, tlog kills, coordinator
kills, proxy kills forcing quorum-gated recovery) running under a
ConflictRange-style model-checked workload — plus, spec-gated, the
full-client ApiCorrectness workload (testing/api_workload.py) whose
sequential-model cross-check fails the seed on ANY read or commit/abort
divergence. The signature of a run — outcome counts, virtual end time,
epoch, final keys, api check counts — is deterministic per seed;
`run_seed` executed twice must return identical signatures (the
unseed-determinism check, contrib/debug_determinism/).

Every probability and topology range lives in a named spec file
(testing/specs/*.toml — the reference's TOML-driven tester,
fdbserver/tester.actor.cpp readTOMLTests_impl), never in this module:
`plan_for_seed(seed, spec)` derives the plan from the spec, and
`python -m foundationdb_tpu_torch.drills.soak --spec <name>` sweeps
seeds through it.

Where a plan draws the "cuda" backend, every resolver of every epoch
(and the backup's restore target) is the port's conflict set on
`device`: the card when it is None, the kernels' plain PyTorch versions
when it is "cpu". The backend and the device go into each ClusterConfig
explicitly: the port's cluster never reads SERVER_KNOBS.RESOLVER_BACKEND,
and the knob's "cuda" is gated by RESOLVER_CUDA_MIN_BATCH, far over a
soak batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from foundationdb_tpu_torch.utils.probes import code_probe, declare

declare(
    "workload.sideband_checked",
    "workload.atomic_sum_checked",
    "workload.backup_restored",
    # the ycsb_d soak twin — a
    # read-latest workload whose insert frontier PERSISTS across
    # batches inside the fault ensemble (bench ycsb_d's frontier resets
    # per run; here a read landing on a key inserted in an EARLIER
    # round proves cross-batch persistence through the chaos)
    "workload.ycsb_d_read_latest_checked",
    "workload.ycsb_d_frontier_persisted",
)


@dataclasses.dataclass
class SeedPlan:
    """Everything a seed decides, derived from (seed, spec) before the
    run starts (testing/spec.derive_plan_fields)."""

    n_commit_proxies: int
    n_resolvers: int
    n_storage: int
    replication: int
    n_tlogs: int
    rounds: int
    kill_proxy: bool
    kill_tlog: bool
    kill_coordinator: bool
    clog: bool
    reboot_storage: bool
    move_shard: bool
    randomize_knobs: bool
    # the rare paths the
    # ensemble previously never reached
    duplicate_resolve: bool    # proxy replays resolve requests
    coordinator_outage: bool   # majority down transiently mid-recovery
    usurper: bool              # rogue candidate steals leadership
    laggard_txn: bool          # snapshot ages past the MVCC window
    state_squeeze: bool        # resolver state-memory backpressure
    small_window: bool         # 1s MVCC window (makes laggard cheap)
    crash_tlog: bool           # power-loss + DiskQueue recovery of a log
    slow_storage: bool         # IO slowdown -> ratekeeper must throttle
    tag_quota: bool            # per-tag GRV throttling exercised
    silent_kill: bool          # unannounced storage death: only the
    #                            failure monitor's ping loop can see it
    tlog_spill: bool           # tiny spill budget + lagging consumer:
    #                            old versions spill by reference and the
    #                            catch-up peek reads them off the queue
    knob_quorum: bool          # dynamic-knob writes race through the
    #                            ConfigNode quorum under a coordinator
    #                            minority kill; the broadcast copy is
    #                            wiped and restored from the quorum
    # admission-control fault classes
    ratekeeper_restart: bool   # kill + restart the Ratekeeper mid-run:
    #                            the GRV front door's stale-budget
    #                            fail-safe decays toward the floor,
    #                            then the budget recovers after restart
    sensor_dropout: bool       # the control loop's sensor feed goes
    #                            stale: the law itself decays fail-safe
    #                            instead of freezing at full speed
    overload_burst: bool       # open-loop burst past a finite resolver
    #                            capacity: throttle + bounded-queue
    #                            shedding engage and RECOVER while the
    #                            other fault classes interleave
    sideband: bool             # Sideband.actor.cpp analog: a commit's
    #                            version handed to a checker must make
    #                            the write visible at exactly that
    #                            version (causal consistency)
    random_clogging: bool      # RandomClogging.actor.cpp analog:
    #                            repeated random role-pair clogs
    atomic_ops: bool           # AtomicOps.actor.cpp analog: concurrent
    #                            atomic adds; acked deltas must sum
    #                            exactly (unknown-result deltas are
    #                            subset-feasible)
    backup_restore: bool       # BackupToDBCorrectness analog: snapshot
    #                            + log backup THROUGH the chaos (worker
    #                            displacement on recoveries), restored
    #                            into a fresh cluster and compared
    # the full-client randomized-correctness layer
    api: bool                  # ApiCorrectness analog: the full client
    #                            API (RYW, reverse/limited ranges,
    #                            atomics, versionstamps, explicit
    #                            conflict ranges, snapshot reads)
    #                            cross-checked against a sequential
    #                            model (testing/api_workload.py)
    api_actors: int            # concurrent api workload actors
    api_rounds: int            # transactions per api actor
    resolver_backend: str      # "cpu" | "cuda": the spec alternates
    #                            backends so the conflict kernels run
    #                            inside the fault ensemble
    spec_name: str             # which spec derived this plan
    # append-only, defaulted (earlier call sites and plans
    # are untouched): the ycsb_d read-latest workload — an insert
    # frontier advancing over CONSECUTIVE fresh keys that persists
    # across rounds, with exponentially-recent reads model-checked
    ycsb_d: bool = False


def plan_for_seed(seed: int, spec=None) -> SeedPlan:
    """Derive a seed's plan from a spec (name, SoakSpec, or None for
    the checked-in default). The probabilities live in
    testing/specs/*.toml — there are none here."""
    from foundationdb_tpu_torch.testing.spec import derive_plan_fields, load_spec

    spec = load_spec(spec if spec is not None else "default")
    return SeedPlan(**derive_plan_fields(seed, spec))


def signature_metrics(sig: tuple) -> dict:
    """Name the positional fields of a run_seed signature tuple that
    feed observability (the soak drill's progress lines,
    drills/soak.py — one decoder instead of magic indices).
    `traced` entries are present only on trace=True runs."""
    out = {
        "seed": sig[0],
        "committed": sig[1],
        "aborted": sig[2],
        "read_checks": sig[3],
        "virtual_seconds": sig[4],
        "epoch": sig[5],
        "api": sig[7],
    }
    if len(sig) > 8:
        out["trace_digest"] = sig[8]
        out["traced_commits"] = sig[9]
    return out


def run_seed(seed: int, spec=None, collect_probes: bool = False,
             _inject_fault=None, _corrupt_api: bool = False,
             perturb: int = 0, _inject_race: bool = False,
             trace: bool = False, _corrupt_trace: bool = False,
             status_probe: bool = False, census: bool = False,
             device=None):
    """Run one ensemble seed under a named spec; returns the
    deterministic signature (and, with collect_probes, the CODE_PROBE
    hit snapshot for ensemble coverage accounting — the Joshua side of
    flow/CodeProbe.h).

    A seed FAILS on any unhandled actor error (an exception that
    escaped its actor and was never consumed by an awaiter,
    Scheduler.unhandled_errors), on any interleaving conflict the
    auditor observes on tracked shared objects (spec policy.audit), on
    any workload model-check mismatch, and — when the plan runs the
    api workload — on any divergence between the real client's
    reads/commit decisions and the sequential model
    (testing/api_workload.py).

    `perturb` > 0 re-runs the SAME seed under seeded randomized
    tie-breaking among equally-runnable actors (runtime/flow.py's
    schedule perturbation): any such order is a legal schedule, so
    every check above must still hold, and each (seed, perturb) pair
    is itself exactly reproducible.

    `device` is where a "cuda" seed's conflict sets live: None is the
    card (and raises without one), "cpu" the plain PyTorch versions of
    the kernels. A "cpu" seed resolves on the host oracle wherever this
    points.

    `_inject_fault` is the gate's self-test hook:
    an async callable(sched, cluster, db) spawned as a fire-and-forget
    actor, so a deliberately crashing injection proves the seed fails.
    `_corrupt_api` is the api checker's self-test hook: it corrupts
    committed api keys on every replica behind the transaction
    system's back, so the model cross-check must fail the seed.
    `_inject_race` is the AUDITOR's self-test hook: two well-behaved-
    looking actors RMW one shared audited key across an await — the
    seed must fail iff the spec's auditor is on.

    `trace=True` runs the seed with commit-path telemetry on: fresh
    TraceLog/TraceBatch/SpanExporter sinks bound to the virtual clock,
    client transactions carrying deterministic debug ids, and the
    SPAN-CHAIN GATE armed — the seed FAILS if any committed transaction
    is missing a pipeline stage (GRV -> commit -> resolve -> tlog ->
    storage), any exported span is an orphan, or any span ends before
    it starts in virtual time (utils/commit_debug.check_chains). The
    returned signature gains a trace digest, so the unseed-determinism
    re-run also proves trace output is bit-identical per
    (seed, perturb). `_corrupt_trace` is the gate's divergence
    self-test: it deletes one pipeline stage's events before the check,
    which must then fail the seed.

    `census=True` arms the resource-census gate (runtime/census.py):
    a snapshot before the cluster is built vs one after it is stopped
    and drained — growth in live scheduler tasks or transport gauges
    fails the seed. fd counts are excluded HERE on purpose: sim seeds
    share one process with lazily-initialized torch/NumPy internals, so
    /proc/self/fd growth is not attributable to the run — the wire
    drills (bench/chaos/elasticity, each owning its process) gate fds.
    Census reads stay out of the signature and the trace digest, so
    an armed gate leaves signatures bit-identical per (seed, perturb)
    (pinned by the JAX package's census tests; tests/test_torch_soak.py
    holds the port's census-armed seed equal to JAX's).

    `status_probe=True` arms the saturation-sensor determinism guard:
    a background actor samples the full `cluster_status()` document
    (every role's saturation() sensors, smoother decay, qos assembly)
    on a virtual-clock cadence during the run. Combined with
    `trace=True`, the digest check proves reading the sensors leaves
    traced output bit-identical per (seed, perturb) — the new gauges
    stay OUT of the trace-digest contract.
    """
    from foundationdb_tpu_torch.cluster.commit_proxy import (
        CommitUnknownResult,
        NotCommitted,
        TransactionTooOldError,
    )
    from foundationdb_tpu_torch.cluster.consistency import check_cluster
    from foundationdb_tpu_torch.cluster.database import ClusterConfig, open_cluster
    from foundationdb_tpu_torch.cluster.grv_proxy import (
        GrvProxyFailedError,
        GrvThrottledError,
    )
    from foundationdb_tpu_torch.runtime.flow import all_of
    from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS

    from foundationdb_tpu_torch.cluster.failure_monitor import ProcessFailedError

    retryable = (
        NotCommitted,
        TransactionTooOldError,
        CommitUnknownResult,
        GrvProxyFailedError,
        # overload shedding at the GRV front door: delayed-or-shed is
        # the admission-control contract; clients back off and retry
        GrvThrottledError,
        # every replica of a team can be transiently dead under composed
        # faults (silent kill + reboot): the read retry budget exhausts
        # and surfaces the process failure — a real client backs off and
        # retries exactly like any other retryable transaction error
        ProcessFailedError,
    )
    from foundationdb_tpu_torch.testing.spec import load_spec

    spec = load_spec(spec if spec is not None else "default")
    plan = plan_for_seed(seed, spec)
    if collect_probes:
        # per-seed accounting: pooled ensemble workers reuse processes,
        # so the global counters must start clean for THIS seed (plain
        # runs leave them accumulating across runs)
        from foundationdb_tpu_torch.utils import probes

        probes.reset()
    SERVER_KNOBS.reset()
    knob_rng = np.random.default_rng(seed ^ 0xBADC0DE)
    if plan.randomize_knobs:
        SERVER_KNOBS.randomize_under_test(knob_rng)
    # the spec decides the conflict backend per seed: "cpu" is the host
    # model, "cuda" the port's conflict set — running the device path
    # INSIDE the fault ensemble, not just in packed-batch parity suites.
    # The knob mirrors the JAX soak; what reaches the resolvers is the
    # explicit resolver_backend/device of every ClusterConfig below.
    SERVER_KNOBS.set("RESOLVER_BACKEND", plan.resolver_backend)
    if plan.duplicate_resolve:
        SERVER_KNOBS.set("BUGGIFY_DUPLICATE_RESOLVE", True)
    if plan.state_squeeze:
        # tiny resolver memory limit: metadata bursts breach it and the
        # backpressure loop must drain via the version chain
        SERVER_KNOBS.set("RESOLVER_STATE_MEMORY_LIMIT", 60)

    window = 1_000_000 if plan.small_window else 5_000_000
    from foundationdb_tpu_torch.cluster.database import ClusterConfig as _CC
    from foundationdb_tpu_torch.runtime.flow import AuditedDict, Scheduler

    kernel_config = _CC.kernel_config.scaled(window_versions=window)
    if plan.resolver_backend == "cuda" and bool(
        spec.policy.get("kernel_range_sweep")
    ):
        # the range-heavy ensemble: EVERY cuda seed arms
        # the sorted-endpoint sweep probe + spill-and-compact pressure
        # handling (range_sweep excludes dedup_reads — they compile the
        # same probe differently). delta_capacity is sized SMALL on
        # purpose: the conservative spill bound (2*max_writes per
        # batch) trips within a couple of batches, so the spill fold
        # runs INSIDE the fault ensemble (resolver.delta_spill probe),
        # never a latch+raise. The sharded alternation below still
        # applies on seed % 4 == 0.
        # compact_interval=0: compaction is PURELY pressure-driven here
        # — a cadence compaction would reset the spill bound before it
        # ever tripped, and the spec exists to run the spill fold (not
        # just the sweep) inside the fault mix
        kernel_config = kernel_config.scaled(
            delta_capacity=4 * kernel_config.max_writes,
            range_sweep=True,
            delta_spill=True,
            compact_interval=0,
        )
        if seed % 4 == 0:
            kernel_config = kernel_config.scaled(n_shards=2)
    elif plan.resolver_backend == "cuda" and seed % 2 == 0:
        # alternate the TIERED kernel (ops/delta.py: delta tier +
        # device-side read dedup + per-group compaction) through the
        # fault ensemble on even cuda seeds — decisions are
        # parity-identical to the classic kernel, so every model check
        # applies unchanged while the new path (incl. the dedup-latch
        # exact-kernel fallback) runs INSIDE the fault mix. Odd seeds
        # keep the classic kernel covered. Deterministic per seed; the
        # spec draw order is untouched.
        kernel_config = kernel_config.scaled(
            delta_capacity=4 * kernel_config.max_writes,
            dedup_reads=kernel_config.max_reads // 4,
            # compact every 2 batches: delta_capacity holds 2 batches'
            # worst-case boundaries, and frequent compaction exercises
            # the compaction boundaries inside the fault ensemble
            compact_interval=2,
        )
        if seed % 4 == 0:
            # every other tiered seed runs the SHARDED tiered kernel
            # (parallel/sharding.py: a keyspace partition into 2 shards,
            # combined with min/sum/max) inside the fault ensemble.
            # Per-shard semantics are the reference's multi-resolver
            # deployment, so every model check applies unchanged (the
            # api workload's strict false-abort audit already tolerates
            # conservative multi-resolver aborts). The JAX soak asks
            # whether its process can build a 2-device virtual CPU mesh
            # and keeps one shard where it cannot; in the port the shard
            # axis is a tensor axis on one device, always available.
            # The JAX test process forces 8 virtual devices, so both
            # packages shard the same seeds there and the parity tests
            # compare like with like.
            kernel_config = kernel_config.scaled(n_shards=2)
    prev_sinks = prev_exporter = None
    try:
        # the scheduler is built HERE (not by open_cluster) so the spec
        # can arm the interleaving auditor and a perturbation id can
        # reseed the tie-break; perturb=0 is byte-identical FIFO order
        sched = Scheduler(
            sim=True,
            audit=bool(spec.policy.get("audit")),
            perturb_seed=(
                None if not perturb
                else (seed * 1_000_003 + perturb) & ((1 << 63) - 1)
            ),
        )
        census_pre = None
        if census:
            from foundationdb_tpu_torch.runtime import census as _census

            # BEFORE the cluster exists: everything it spawns or opens
            # must be gone again by the post-drain snapshot
            census_pre = _census.snapshot(sched)
        _s, cluster, db = open_cluster(
            ClusterConfig(
                n_commit_proxies=plan.n_commit_proxies,
                n_resolvers=plan.n_resolvers,
                n_storage=plan.n_storage,
                replication_factor=plan.replication,
                n_tlogs=plan.n_tlogs,
                sim_seed=seed,
                kernel_config=kernel_config,
                resolver_backend=plan.resolver_backend,
                device=device,
            ),
            sched=sched,
        )
        trace_sinks = None
        if trace:
            from foundationdb_tpu_torch.utils import spans as _spans
            from foundationdb_tpu_torch.utils import trace as _tr

            # fresh per-run sinks on the VIRTUAL clock: ids and times
            # are deterministic, so trace output is bit-reproducible
            # per (seed, perturb) — the unseed-determinism contract
            # extended to telemetry
            tlog_sink = _tr.TraceLog(
                min_severity=_tr.SEV_DEBUG, clock=sched.now,
                max_events=2_000_000,
            )
            tbatch = _tr.TraceBatch(
                clock=sched.now, logger=tlog_sink, enabled=True
            )
            prev_sinks = _tr.install(tlog_sink, tbatch)
            prev_exporter = _spans.set_exporter(
                _spans.SpanExporter(trace_log=tlog_sink,
                                    max_finished=1_000_000)
            )
            db.tracing = True
            trace_sinks = tlog_sink
        rng = np.random.default_rng(seed)
        # `possible` stays a PLAIN dict on purpose: the workload and the
        # laggard deliberately overlap on s29 with carefully-widened
        # allowed-value sets (commit-certainty overwrites are the
        # model's semantics, not a lost update) — auditing it would
        # flag that contract. The counters below have no such contract:
        # any cross-actor RMW interleaving on them IS a bug.
        possible: dict[bytes, set] = {}
        outcome = AuditedDict(
            sched, "soak.outcome",
            {"committed": 0, "aborted": 0, "read_checks": 0},
        )
        if plan.tag_quota:
            # a "batch"-tagged workload slice throttled at the front door
            cluster.ratekeeper.set_tag_quota("batch", 12.0)

        def check(got: dict, lo: bytes, hi: bytes):
            keys = set(got) | {k for k in possible if lo <= k < hi}
            for k in keys:
                allowed = possible.get(k, {None})
                assert got.get(k) in allowed, (
                    f"seed {seed}: key {k!r} = {got.get(k)!r} "
                    f"not in {allowed}"
                )

        async def workload():
            for i in range(plan.rounds):
                txn = db.create_transaction(
                    tag="batch" if plan.tag_quota and i % 3 == 0 else None
                )
                writes: dict = {}
                try:
                    if rng.random() < 0.15 or plan.state_squeeze:
                        # metadata write: a state transaction the
                        # resolvers must forward (and, knob-gated,
                        # materialize as private mutations). Squeeze
                        # seeds write them every round so the resolver's
                        # tiny state-memory limit is breached and the
                        # backpressure loop must drain via the chain.
                        txn.set(b"\xff/soak/%02d" % (i % 4), b"m%d" % i)
                        if plan.state_squeeze:
                            txn.set(b"\xff/soak/big%02d" % (i % 8),
                                    b"x" * 40)
                    if rng.random() < 0.6:
                        a = int(rng.integers(0, 30))
                        b_ = a + int(rng.integers(1, 8))
                        lo, hi = b"s%02d" % a, b"s%02d" % b_
                        got = dict(await txn.get_range(lo, hi))
                        check(got, lo, hi)
                        outcome["read_checks"] += 1
                    for _ in range(int(rng.integers(1, 4))):
                        k = b"s%02d" % int(rng.integers(0, 30))
                        v = b"r%d" % i
                        txn.set(k, v)
                        writes[k] = v
                    await txn.commit()
                    for k, v in writes.items():
                        possible[k] = {v}
                    outcome["committed"] += 1
                except CommitUnknownResult:
                    for k, v in writes.items():
                        possible.setdefault(k, {None}).add(v)
                    outcome["aborted"] += 1
                    await sched.delay(0.01)
                except retryable:
                    outcome["aborted"] += 1
                    await sched.delay(0.01)

        atomic_state = AuditedDict(
            sched, "soak.atomic", {"known": 0, "unknown": []}
        )

        async def atomic_ops():
            """AtomicOps.actor.cpp in miniature: a stream of atomic
            adds against one counter; every ACKED delta must be in the
            final sum exactly once, and unknown-result deltas may be
            in or out (subset-feasibility checked after the run)."""
            for _i in range(plan.rounds):
                txn = db.create_transaction()
                delta = int(rng.integers(1, 100))
                txn.add(b"aa-counter", delta)
                try:
                    await txn.commit()
                    atomic_state["known"] += delta
                except CommitUnknownResult:
                    atomic_state["unknown"].append(delta)
                    await sched.delay(0.01)
                except retryable:
                    await sched.delay(0.01)
                if rng.random() < 0.3:
                    await sched.delay(0.02)

        # ycsb_d soak twin: the
        # read-latest insert-frontier workload under the fault mix.
        # Single-writer state (one actor owns it), so a plain dict:
        # frontier = next fresh index; allowed[idx] = the value set a
        # read may legally observe ({v} definite, {None, v} unknown
        # fate); round_of[idx] = the round that FIRST reserved idx (a
        # later-round read hitting it proves the frontier persisted
        # across batches — the thing bench ycsb_d resets per run).
        yd_state = {"frontier": 0, "allowed": {}, "round_of": {}}

        async def ycsb_d_flow():
            rng_d = np.random.default_rng(seed ^ 0xD00D)
            for i in range(plan.rounds):
                txn = db.create_transaction()
                base = yd_state["frontier"]
                n_ins = int(rng_d.integers(1, 3))
                idxs = list(range(base, base + n_ins))
                try:
                    if base > 0 and rng_d.random() < 0.7:
                        # read-latest: exponentially-recent index
                        # behind the frontier (the YCSB-D access law)
                        off = int(min(base - 1, rng_d.exponential(3.0)))
                        idx = base - 1 - off
                        got = await txn.get(b"yd%06d" % idx)
                        allowed = yd_state["allowed"].get(idx, {None})
                        assert got in allowed, (
                            f"seed {seed}: ycsb_d read idx {idx} = "
                            f"{got!r} not in {allowed}"
                        )
                        code_probe(
                            True, "workload.ycsb_d_read_latest_checked"
                        )
                        # the frontier PERSISTED: the read landed on an
                        # insert from >= 5 rounds ago — state that has
                        # lived through a meaningful slice of the fault
                        # ensemble (any read trivially predates its own
                        # round; a 1-round gap proves nothing)
                        code_probe(
                            i - yd_state["round_of"].get(idx, i) >= 5,
                            "workload.ycsb_d_frontier_persisted",
                        )
                    for idx in idxs:
                        txn.set(b"yd%06d" % idx, b"d%d" % idx)
                    await txn.commit()
                    for idx in idxs:
                        yd_state["allowed"][idx] = {b"d%d" % idx}
                        yd_state["round_of"].setdefault(idx, i)
                    # CONSECUTIVE fresh keys: the frontier advances
                    # over exactly the inserted indices and NEVER
                    # resets — recoveries, kills and throttles included
                    # (re-read at write time: single-writer state, and
                    # the flow.rmw-across-wait discipline holds anyway)
                    yd_state["frontier"] += n_ins
                except CommitUnknownResult:
                    for idx in idxs:
                        yd_state["allowed"].setdefault(idx, {None}).add(
                            b"d%d" % idx
                        )
                        yd_state["round_of"].setdefault(idx, i)
                    # fate unknown: the indices are RESERVED (a later
                    # read must tolerate either outcome), the frontier
                    # still advances monotonically
                    yd_state["frontier"] += n_ins
                    await sched.delay(0.01)
                except retryable:
                    # definite abort: nothing written, the same indices
                    # are retried by the next round at the same values
                    await sched.delay(0.01)
                if rng_d.random() < 0.2:
                    await sched.delay(0.02)

        backup_state = AuditedDict(
            sched, "soak.backup", {"agent": None, "container": None}
        )

        async def backup_flow():
            """BackupToDBCorrectness in miniature: snapshot + log
            backup run THROUGH the chaos; recoveries displace the
            per-epoch BackupWorker mid-stream. The restore comparison
            happens after the run."""
            from foundationdb_tpu_torch.cluster.backup import (
                BackupAgent,
                BackupContainer,
            )

            agent = BackupAgent(db, BackupContainer())
            backup_state["container"] = agent.container
            await sched.delay(0.05)
            for _attempt in range(20):
                try:
                    await agent.snapshot()
                    break
                except retryable:
                    await sched.delay(0.05)
            else:
                # snapshot never landed under this seed's chaos: no
                # backup to verify — starting the log side anyway would
                # make the post-run restore fail on an EMPTY container
                return
            backup_state["agent"] = agent
            agent.start_log_backup(cluster)

        async def sideband():
            """Sideband.actor.cpp in miniature: the committed version is
            the 'sideband message'; a reader pinned AT that version must
            see the write (causality / external consistency). Keys live
            under cb/ — outside the final-verify range on purpose."""
            from foundationdb_tpu_torch.utils.probes import code_probe

            for i in range(10):
                await sched.delay(0.04)
                key = b"cb/sb%02d" % i
                val = b"v%d" % i
                txn = db.create_transaction()
                txn.set(key, val)
                try:
                    cv = await txn.commit()
                except retryable:
                    continue
                t2 = db.create_transaction()
                t2._read_version = cv  # read AT the commit version
                try:
                    got = await t2.get(key)
                except retryable:
                    continue
                assert got == val, (
                    f"seed {seed}: sideband causality violation at "
                    f"{key!r}: read@{cv} saw {got!r}"
                )
                code_probe(True, "workload.sideband_checked")

        async def random_clogging():
            """RandomClogging.actor.cpp: clog random role pairs for
            random durations while the workload runs."""
            procs = ["proxy0", "resolver0", "tlog0"] + [
                f"storage{i}" for i in range(plan.n_storage)
            ]
            for _ in range(6):
                await sched.delay(float(rng.uniform(0.03, 0.12)))
                a, b_ = rng.choice(len(procs), size=2, replace=False)
                cluster.net.clog_pair(
                    procs[int(a)], procs[int(b_)],
                    float(rng.uniform(0.05, 0.25)),
                )

        async def laggard():
            """A transaction whose snapshot ages past the MVCC window:
            the resolver must classify it TOO_OLD (resolver.too_old).
            NO check() here: it runs concurrently with the workload, so
            its (old) snapshot legitimately misses commits the model has
            already recorded — snapshot isolation, not a lost write."""
            await sched.delay(0.25)
            txn = db.create_transaction()
            try:
                await txn.get_range(b"s00", b"s05")
                await sched.delay(window / 1e6 + 1.2)
                txn.set(b"s29", b"laggard")
                await txn.commit()
                outcome["committed"] += 1
                # s29 is also a workload key and reply order across
                # proxies need not match version order — widen the
                # allowed set instead of overwriting it
                possible.setdefault(b"s29", {None}).add(b"laggard")
            except CommitUnknownResult:
                # may or may not have landed
                possible.setdefault(b"s29", {None}).add(b"laggard")
                outcome["aborted"] += 1
            except retryable:
                outcome["aborted"] += 1

        async def coordination_chaos():
            """Quorum outage + a usurping candidate during live operation:
            the coordination/recovery rare paths (quorum_unreachable,
            stale_generation, racing_writer, epoch_lock_failed,
            leadership_lost)."""
            from foundationdb_tpu_torch.cluster.coordination import (
                LeaderElection,
                QuorumUnreachable,
                StaleGeneration,
            )

            if plan.coordinator_outage:
                await sched.delay(0.12)
                cluster.kill_coordinator(0)
                cluster.kill_coordinator(1)
                await sched.delay(0.8)
                cluster.revive_coordinator(0)
                cluster.revive_coordinator(1)
            if plan.usurper:
                from foundationdb_tpu_torch.cluster.coordination import LeaderLease

                await sched.delay(0.1)
                rogues = [
                    LeaderElection(
                        sched, cluster.coordinators, f"rogue-cc{i}",
                        lease=0.4,
                    )
                    for i in (0, 1)
                ]
                for _ in range(3):
                    # Two candidates race the register read-modify-write:
                    # both read, both write — the loser's lock replies
                    # carry the winner's newer write generation
                    # (racing_writer_detected), and the real CC's next
                    # renew/bump fails deposed (leadership_lost /
                    # epoch_lock_failed / stale_generation).
                    views = []
                    for r in rogues:
                        try:
                            views.append((r, await r.cs.read()))
                        except (QuorumUnreachable, StaleGeneration):
                            pass
                    for i, (r, cur) in enumerate(views):
                        if cur is None:
                            continue
                        try:
                            await r.cs.write(LeaderLease(
                                leader=r.candidate_id,
                                epoch=cur.epoch + 1,
                                expires=sched.now() + 0.4,
                            ))
                        except (QuorumUnreachable, StaleGeneration):
                            pass
                    await sched.delay(0.45)

        async def chaos():
            await sched.delay(0.05)
            if plan.clog:
                cluster.net.clog_pair("proxy0", "resolver0", 0.2)
                await sched.delay(0.05)
            if plan.kill_coordinator:
                # a MINORITY: recovery must still go through the quorum
                cluster.kill_coordinator(int(rng.integers(0, 3)))
            if plan.reboot_storage:
                await sched.delay(0.05)
                cluster.reboot_storage(int(rng.integers(0, plan.n_storage)))
            if plan.move_shard:
                await sched.delay(0.05)
                try:
                    await cluster.data_distributor.move_shard(
                        b"s05", b"s15", int(rng.integers(0, plan.n_storage))
                    )
                except Exception as e:
                    # a move aborted by composed chaos unwinds cleanly
                    # (move_shard's own contract) — but log it: a seed
                    # where EVERY move fails is a signal worth seeing
                    from foundationdb_tpu_torch.utils.trace import (
                        SEV_WARN,
                        TraceEvent,
                    )

                    TraceEvent("SoakMoveShardAborted", severity=SEV_WARN) \
                        .detail("Err", repr(e)).log()
            if plan.slow_storage:
                # a slow storage pull loop: lag grows, the ratekeeper's
                # control law must throttle admission and the cluster
                # must stay inside the MVCC window (no unbounded queue).
                # The law's thresholds are tightened for the fault window
                # (the production 2s lag target would need seconds of
                # virtual saturation per seed).
                rk = cluster.ratekeeper
                ss = cluster.storage_servers[0]
                old = (rk.lag_target, rk.lag_limit, rk.interval)
                rk.lag_target, rk.lag_limit, rk.interval = 40_000, 300_000, 0.05
                ss.slowdown = 0.1
                # slow READS too: the client QueueModel must shed load /
                # fire backup requests at the slow-but-alive replica
                ss.read_slowdown = 0.02
                await sched.delay(0.6)
                ss.slowdown = 0.0
                ss.read_slowdown = 0.0
                await sched.delay(0.4)  # drain under throttle
                rk.lag_target, rk.lag_limit, rk.interval = old
            if plan.crash_tlog and plan.n_tlogs > 1:
                # power-loss one log replica mid-traffic: un-fsynced data
                # tears, the DiskQueue recovery scan rebuilds, the peer
                # catch-up restores parity — acked commits must survive
                await sched.delay(0.07)
                cluster.crash_reboot_tlog(
                    plan.n_tlogs - 1,
                    np.random.default_rng(seed ^ 0xD15C),
                )
            if plan.kill_tlog and plan.n_tlogs > 1:
                await sched.delay(0.05)
                cluster.kill_tlog(0)
            if plan.silent_kill and plan.replication >= 2:
                # unannounced death: reads that hit it report via the
                # client fast path, but DETECTION is the ping loop's job
                # (failmon.detected_by_ping); the revived process is
                # marked live by a later ping
                await sched.delay(0.05)
                victim = int(rng.integers(0, plan.n_storage))
                cluster.kill_storage_silent(victim)
                for _ in range(40):
                    await sched.delay(0.05)
                    if cluster.failure_monitor.is_failed(
                        f"storage{victim}"
                    ):
                        break
                cluster.storage_servers[victim].start()
            if plan.tlog_spill:
                # a tiny retained-mutation budget + a briefly-lagging
                # consumer: the tlog must spill old unpopped versions by
                # reference (tlog.spill) and the catch-up peek must read
                # them back off the disk queue (tlog.peek_from_spill)
                SERVER_KNOBS.set("TLOG_SPILL_THRESHOLD", 8)
                lag_ss = cluster.storage_servers[0]
                lag_ss.slowdown = 2.0
                await sched.delay(0.5)
                lag_ss.slowdown = 0.0
                await sched.delay(0.3)  # drain the spilled tail
            if plan.knob_quorum:
                # knob writes race through the ConfigNode quorum while a
                # coordinator minority is down; then the broadcast copy
                # is wiped and must come back from the quorum alone
                from foundationdb_tpu_torch.cluster.config_db import (
                    CONF_PREFIX,
                    PaxosConfigStore,
                    restore_broadcast,
                )
                from foundationdb_tpu_torch.cluster.coordination import (
                    QuorumUnreachable,
                    StaleGeneration,
                )

                await sched.delay(0.06)
                victim = int(rng.integers(0, 3))
                cluster.kill_coordinator(victim)
                ws = [
                    PaxosConfigStore(
                        sched, cluster.config_nodes, f"soak-knob-{i}"
                    )
                    for i in (0, 1)
                ]
                tasks = [
                    sched.spawn(w.set("SOAK_KNOB_%d" % i, b"%d" % i))
                    for i, w in enumerate(ws)
                ]
                landed = {}
                for i, t in enumerate(tasks):
                    try:
                        await t.done
                        landed["SOAK_KNOB_%d" % i] = i
                    except (QuorumUnreachable, StaleGeneration):
                        # composed chaos (coordinator_outage) can take
                        # the quorum below majority: failing loudly is
                        # the write's correct behavior
                        pass
                cluster.revive_coordinator(victim)
                try:
                    txn = db.create_transaction()
                    txn.clear_range(CONF_PREFIX, CONF_PREFIX + b"\xff")
                    await txn.commit()
                    restored = await restore_broadcast(db)
                    # every ACKED quorum write must come back; writes
                    # that failed loudly carry no promise
                    for k, v in landed.items():
                        assert restored.get(k) == v, (k, restored)
                except retryable:
                    pass  # data-plane chaos may abort the broadcast txn
                except (QuorumUnreachable, StaleGeneration):
                    pass  # quorum still degraded at restore time
            if plan.kill_proxy:
                await sched.delay(0.1)
                p = cluster.commit_proxies[0]
                p.failed = RuntimeError("soak kill")
                p.stop()

        async def admission_chaos():
            """Overload-survival scenarios (runs CONCURRENTLY with
            chaos/coordination_chaos/workload, so throttle windows
            interleave with kills and recoveries): the admission loop
            must survive its own death. Ratekeeper kill/restart — the
            GRV front door's stale-budget detector decays the
            effective budget toward the fail-safe floor, then recovers
            after restart; sensor dropout — the law itself fails safe
            on a stale feed; overload burst — open-loop load past a
            finite (virtually-modeled) resolver capacity must engage
            the throttle and the bounded-queue shed, then drain."""
            rk = cluster.ratekeeper
            grv = cluster.grv_proxy
            if plan.sensor_dropout:
                await sched.delay(0.1)
                rk.sensor_dropout = True
                await sched.delay(0.8)
                rk.sensor_dropout = False
            if plan.ratekeeper_restart:
                await sched.delay(0.1)
                rk.stop()
                # past the GRV proxy's staleness threshold (4x the
                # control interval), so the fail-safe decay engages
                # before the restart brings fresh budgets back
                await sched.delay(6.0 * rk.interval)
                rk.start()
            if plan.overload_burst:
                old_q = grv.max_queue
                old_interval = rk.interval
                old_cost = [
                    r.sim_compute_cost_per_txn for r in cluster.resolvers
                ]
                grv.max_queue = 12
                rk.interval = 0.05
                for r in cluster.resolvers:
                    r.sim_compute_cost_per_txn = 0.004

                async def burst_txn(i):
                    txn = db.create_transaction()
                    txn.set(b"ob/%02d" % (i % 16), b"b%d" % i)
                    try:
                        await txn.commit()
                    except retryable:
                        await sched.delay(0.01)

                burst = []
                for i in range(150):
                    # ~500 offered txn/s against ~250/s of capacity:
                    # the GRV queue must fill, shed, and drain
                    burst.append(
                        sched.spawn(burst_txn(i), name=f"burst{i}").done
                    )
                    await sched.delay(0.002)
                await all_of(burst)
                await sched.delay(0.5)  # drain + budget recovery
                grv.max_queue = old_q
                rk.interval = old_interval
                for r, c in zip(cluster.resolvers, old_cost):
                    r.sim_compute_cost_per_txn = c

        api = None
        if plan.api:
            from foundationdb_tpu_torch.testing.api_workload import ApiWorkload

            # phantom resolver state from killed proxies/logs (resolved-
            # committed batches the log never made durable) makes
            # "every NotCommitted has a visible conflicting writer"
            # unsound, so the stronger abort audit only arms on plans
            # without those fault classes — and only with ONE resolver:
            # with more, the ResolutionBalancer's range moves inject
            # synthetic conservative writes over the moved span (the
            # receiving resolver's empty history must not miss stale
            # reads, commit_proxy.conservative_writes), so a read below
            # the transition version aborts with no client writer to
            # explain it. Found by a perturbation sweep at
            # api_correctness seed 60 (pre-existing; pinned in
            # test_soak).
            strict = plan.n_resolvers == 1 and not (
                plan.kill_proxy or plan.kill_tlog or plan.crash_tlog
                or plan.coordinator_outage or plan.usurper
                or plan.duplicate_resolve or plan.knob_quorum
                or plan.silent_kill
            )
            api = ApiWorkload(
                sched, db, seed,
                actors=plan.api_actors, rounds=plan.api_rounds,
                strict_aborts=strict,
            )

        w = sched.spawn(workload(), name="soak-load")
        c = sched.spawn(chaos(), name="soak-chaos")
        cc = sched.spawn(coordination_chaos(), name="soak-coord-chaos")
        ac = sched.spawn(admission_chaos(), name="soak-admission-chaos")
        tasks = [w.done, c.done, cc.done, ac.done]
        if api is not None:
            tasks.extend(
                sched.spawn(coro, name=f"soak-api-{i}").done
                for i, coro in enumerate(api.actor_coros())
            )
        if _inject_race:
            # the auditor's divergence self-test: two actors RMW one
            # audited key across an await — both complete cleanly, so
            # ONLY the interleaving auditor can catch the lost update
            race_d = AuditedDict(sched, "selftest.race", {"n": 0})

            async def racer():
                await sched.delay(0.02)
                v = race_d["n"]
                await sched.delay(0.013)
                # the race is the POINT (the rule and the auditor both
                # catching this same fixture is the layers agreeing)
                race_d["n"] = v + 1  # flowcheck: ignore[flow.rmw-across-wait]

            tasks.append(sched.spawn(racer(), name="race-a").done)
            tasks.append(sched.spawn(racer(), name="race-b").done)
        if _inject_fault is not None:
            # deliberately unobserved: the unhandled-error gate below
            # must catch whatever this actor lets escape
            sched.spawn(  # flowcheck: ignore[actor.fire-and-forget]
                _inject_fault(sched, cluster, db), name="injected-fault"
            )
        if status_probe:
            # saturation-sensor determinism guard: SAMPLE the full
            # status document (every saturation() sensor, the smoothers'
            # _update() decay, the qos assembly) on a cadence DURING the
            # run — the trace-digest check below then proves that
            # reading the sensors leaves traced output bit-identical
            # per (seed, perturb). JSON-serialization is part of the
            # contract (status consumers are JSON readers).
            import json as _status_json

            from foundationdb_tpu_torch.cluster.status import cluster_status

            async def status_sampler():
                # bounded: covers the bulk of a seed's virtual runtime
                # and terminates so all_of(tasks) can complete
                for _ in range(40):
                    doc = cluster_status(cluster)
                    _status_json.dumps(doc)
                    qos = doc["cluster"]["qos"]
                    assert "performance_limited_by" in qos
                    await sched.delay(0.05)

            tasks.append(
                sched.spawn(status_sampler(), name="status-probe").done
            )
        if plan.laggard_txn:
            tasks.append(sched.spawn(laggard(), name="soak-laggard").done)
        if plan.sideband:
            tasks.append(sched.spawn(sideband(), name="soak-sideband").done)
        if plan.random_clogging and cluster.net is not None:
            tasks.append(
                sched.spawn(random_clogging(), name="soak-clogging").done
            )
        if plan.atomic_ops:
            tasks.append(sched.spawn(atomic_ops(), name="soak-atomic").done)
        if plan.ycsb_d:
            tasks.append(sched.spawn(ycsb_d_flow(), name="soak-ycsb-d").done)
        if plan.backup_restore:
            tasks.append(sched.spawn(backup_flow(), name="soak-backup").done)
        sched.run_until(all_of(tasks))
        sched.run_for(2.0)  # settle: recovery tail, deferred drops

        async def final_verify():
            txn = db.create_transaction()
            return dict(await txn.get_range(b"s", b"t"))

        got = sched.run_until(sched.spawn(final_verify()).done)
        check(got, b"s", b"t")

        if plan.atomic_ops:
            import struct as _struct

            async def read_counter():
                txn = db.create_transaction()
                return await txn.get(b"aa-counter")

            raw = sched.run_until(sched.spawn(read_counter()).done)
            total = _struct.unpack("<q", raw)[0] if raw else 0
            residue = total - atomic_state["known"]
            # subset-sum feasibility over the unknown-result deltas
            feasible = {0}
            for d in atomic_state["unknown"]:
                feasible |= {s + d for s in feasible}
            assert residue in feasible, (
                f"seed {seed}: atomic sum {total} != known "
                f"{atomic_state['known']} + subset of "
                f"{atomic_state['unknown']}"
            )
            code_probe(True, "workload.atomic_sum_checked")

        if plan.ycsb_d:
            # end-of-seed durability: every DEFINITELY-committed
            # frontier key must have survived the whole fault ensemble
            # (unknown-fate keys may legally be absent)
            async def read_frontier():
                txn = db.create_transaction()
                return dict(await txn.get_range(b"yd", b"ye"))

            got_yd = sched.run_until(sched.spawn(read_frontier()).done)
            for idx, allowed in yd_state["allowed"].items():
                v = got_yd.get(b"yd%06d" % idx)
                assert v in allowed, (
                    f"seed {seed}: ycsb_d final idx {idx} = {v!r} "
                    f"not in {allowed}"
                )

        if plan.backup_restore and backup_state["agent"] is not None:
            agent = backup_state["agent"]
            # drain the worker through everything committed, then
            # restore into a FRESH cluster and compare the workload
            # range — backup-through-chaos must reproduce the primary
            async def drain():
                target = cluster.tlog.version.get()
                mgr = agent._manager
                while mgr is not None and (
                    mgr.worker is None
                    or mgr.worker.saved_version < target
                ):
                    await sched.delay(0.05)

            sched.run_until(sched.spawn(drain()).done)
            agent.stop_log_backup()
            from foundationdb_tpu_torch.cluster.backup import BackupAgent
            from foundationdb_tpu_torch.cluster.database import (
                ClusterConfig as _CC,
                open_cluster as _oc,
            )

            # the JAX soak builds this target from the knob it set; the
            # port passes the seed's backend and device explicitly
            _s2, cluster2, db2 = _oc(
                _CC(n_commit_proxies=1, n_storage=2,
                    resolver_backend=plan.resolver_backend, device=device),
                sched=sched,
            )
            try:
                agent2 = BackupAgent(db2, backup_state["container"])

                async def restore_and_read():
                    await agent2.restore()
                    txn = db2.create_transaction()
                    return dict(await txn.get_range(b"s", b"t"))

                got2 = sched.run_until(
                    sched.spawn(restore_and_read()).done
                )
                diff = {
                    k: (got.get(k), got2.get(k))
                    for k in set(got) | set(got2)
                    if got.get(k) != got2.get(k)
                }
                assert not diff, (
                    f"seed {seed}: backup/restore divergence "
                    f"(primary, restored): {dict(list(diff.items())[:6])}"
                )
                code_probe(True, "workload.backup_restored")
            finally:
                cluster2.stop()

        if api is not None:
            if _corrupt_api:
                # the divergence self-test: values flipped behind the
                # transaction system's back MUST fail the model check
                api.corrupt_for_selftest(cluster)
            sched.run_until(sched.spawn(api.verify()).done)

        check_cluster(cluster)
        # the interleaving-audit gate: a lost-update conflict on a
        # tracked shared object fails the seed like an unhandled error
        conflicts = sched.audit_conflicts()
        assert not conflicts, (
            f"seed {seed}: {len(conflicts)} interleaving conflict(s): "
            + "; ".join(
                f"{c['label']}[{c['key']!r}]: {c['actor']} wrote from a "
                f"step-{c['read_step']} read over {c['writer']}'s "
                f"step-{c['write_step']} write"
                for c in conflicts[:3]
            )
        )
        # the unhandled-actor-error gate: any exception that escaped an
        # actor with no awaiter ever consuming it fails the seed
        escaped = sched.unhandled_errors()
        assert not escaped, (
            f"seed {seed}: {len(escaped)} unhandled actor error(s): "
            + "; ".join(
                f"{name}: {err!r}" for name, err in escaped[:5]
            )
        )
        if plan.kill_proxy:
            assert cluster.controller.epoch >= 2, "recovery never happened"
        trace_extra = ()
        stopped = False
        if trace:
            import hashlib
            import json as _json

            from foundationdb_tpu_torch.utils import commit_debug as _cdbg
            from foundationdb_tpu_torch.utils.trace import _jsonable

            # teardown BEFORE the span gate: stop() cancels every
            # in-flight actor and the pump below delivers the cancels,
            # so their finally blocks export spans IN-RUN (an in-flight
            # commit batch's span would otherwise stay open while its
            # resolver children exported — a false "orphan" — and the
            # abandoned coroutine's GC-time finalization would leak the
            # span into a LATER run's trace)
            cluster.stop()
            sched.run_for(0.1)
            stopped = True
            events = list(trace_sinks.events)
            if _corrupt_trace:
                # divergence self-test: drop one pipeline stage's
                # events — the chain gate below must fail the seed
                events = [
                    e for e in events
                    if e.get("Location") != _cdbg.RESOLVER_AFTER
                ]
            idx = _cdbg.TraceIndex(events)
            violations = _cdbg.check_chains(idx)
            assert not violations, (
                f"seed {seed} perturb {perturb}: "
                f"{len(violations)} span-chain violation(s): "
                + "; ".join(violations[:5])
            )
            # the trace digest joins the signature: the determinism
            # re-run then proves trace output is BIT-IDENTICAL per
            # (seed, perturb), not merely gate-clean
            # SlowTask is the runtime's WALL-clock watchdog (a host
            # hiccup, not simulation behavior) — the only event class
            # excluded from the bit-reproducibility contract
            digest = hashlib.sha256(
                "\n".join(
                    _json.dumps(_jsonable(e), sort_keys=True)
                    for e in events
                    if e.get("Type") != "SlowTask"
                ).encode()
            ).hexdigest()
            trace_extra = (digest, len(idx.committed_ids()))
        sig = (
            seed,
            outcome["committed"],
            outcome["aborted"],
            outcome["read_checks"],
            round(sched.now(), 6),
            cluster.controller.epoch,
            tuple(sorted(got)),
            api.signature() if api is not None else None,
        ) + trace_extra
        if not stopped:
            cluster.stop()
        if census_pre is not None:
            from foundationdb_tpu_torch.runtime import census as _census

            # pump the loop so stop()'s cancels are DELIVERED (a
            # cancelled-but-not-yet-stepped task is still live), then
            # require every gauge back at its pre-run baseline. The
            # signature is already built: an armed census cannot
            # perturb it (the determinism sweep pins this).
            sched.run_for(0.1)
            _census.check_drained(
                census_pre, _census.snapshot(sched),
                label=f"seed {seed} perturb {perturb}",
                ignore={"fds"},
            )
        if collect_probes:
            from foundationdb_tpu_torch.utils import probes

            return sig, probes.snapshot()
        return sig
    finally:
        SERVER_KNOBS.reset()
        if prev_sinks is not None:
            from foundationdb_tpu_torch.utils import trace as _tr

            _tr.install(*prev_sinks)
        if prev_exporter is not None:
            from foundationdb_tpu_torch.utils import spans as _spans

            _spans.set_exporter(prev_exporter)
