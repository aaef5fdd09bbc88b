"""The Resolver role: the host state machine around the conflict set on
the card (the port of foundationdb_tpu.resolver).

Behavioral mirror of `fdbserver/Resolver.actor.cpp:219-540` (resolveBatch)
and its surrounding actor (`resolverCore` :707): everything the reference
does around `ConflictBatch` — version chaining, duplicate-request replay,
per-proxy state-transaction delivery, MVCC-window GC, metrics — happens
here, while the conflict math itself is one `resolve()` of
`models.conflict_set.TorchConflictSet`.

Key behaviors reproduced:

* **Version chain.** Requests carry (prev_version, version); a request
  waits `version.when_at_least(prev_version)` and only the request whose
  prev_version equals the current version runs the compute phase — others
  are duplicates (Resolver.actor.cpp:271-307, 525).
* **Duplicate replay.** Replies are retained per proxy in
  `outstanding_batches` until the proxy acks them via
  last_received_version; a duplicate request is answered from the cache,
  and an unknown version gets no answer at all ("Never") — :319-321,
  :517-530.
* **State transactions.** Metadata ("state") transactions committed by any
  proxy's batch must reach every other proxy in version order: each reply
  carries the state transactions of versions in [first_unseen_version,
  req.version) (RecentStateTransactionsInfo :59-123, applied :386-431),
  trimmed once every proxy has seen them (oldest_proxy_version sweep
  :449-474).
* **Memory backpressure.** total_state_bytes over the limit delays new
  batches until old state is trimmed (:254-268, knob
  RESOLVER_STATE_MEMORY_LIMIT).
* **Metrics.** The reference's counters (Resolver.actor.cpp:156-213) and
  latency samples (resolver/queueWait/compute distributions) with the same
  names, for the BASELINE p99 comparison.

Backends (models/conflict_set.py's table): `backend="cuda"` builds the
TorchConflictSet on `device` (None = the card, which raises without
one; "cpu" runs the plain PyTorch versions), `backend="cpu"` the host
oracle, and `backend=None` reads the knob SERVER_KNOBS.RESOLVER_BACKEND,
whose "cuda" routes lazily at the first batch: the batch's contention
profile picks the CPU backend or the knob-gated card
(RESOLVER_CUDA_MIN_BATCH).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from foundationdb_tpu_torch.cluster.sampling import key_sample_qos
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.models.conflict_set import (
    KernelStageMetrics,
    _gated_conflict_set,
    backend_for_profile,
    make_conflict_set,
    profile_transactions,
)
from foundationdb_tpu_torch.models.types import (
    CommitTransaction,
    ResolveTransactionBatchReply,
    ResolveTransactionBatchRequest,
    TransactionResult,
    apply_state_mutation,
    is_metadata_mutation,
)
from foundationdb_tpu_torch.runtime.flow import (
    Notified,
    Scheduler,
    Trigger,
    any_of,
)
from foundationdb_tpu_torch.utils import commit_debug as _cd
from foundationdb_tpu_torch.utils import trace
from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS
from foundationdb_tpu_torch.utils.metrics import (
    CounterCollection,
    LatencySample,
    Smoother,
)
from foundationdb_tpu_torch.utils.probes import code_probe, declare
from foundationdb_tpu_torch.utils.spans import Span, SpanContext
from foundationdb_tpu_torch.utils.trace import SEV_WARN, TraceEvent

declare(
    "resolver.duplicate_batch_replayed",
    "resolver.unknown_duplicate_never",
    "resolver.too_old",
    "resolver.backpressure_breached",
    "resolver.state_txn_forwarded",
    "resolver.first_unseen_is_current",
)

#: ServerKnobs.RESOLVER_STATE_MEMORY_LIMIT (fdbclient/ServerKnobs.cpp).
DEFAULT_STATE_MEMORY_LIMIT = 1_000_000

#: key-sample capacity before decay
KEY_SAMPLE_LIMIT = 4096


@dataclasses.dataclass
class StateTransaction:
    """StateTransactionRef (fdbclient/CommitTransaction.h): one metadata
    txn forwarded through resolver replies."""

    committed: bool
    mutations: list[Any]


class _ProxyRequestsInfo:
    """Per-proxy bookkeeping (Resolver.actor.cpp ProxyRequestsInfo)."""

    __slots__ = ("last_version", "outstanding_batches")

    def __init__(self):
        self.last_version: int = -1
        self.outstanding_batches: dict[int, ResolveTransactionBatchReply] = {}


class _RecentStateTransactionsInfo:
    """Version -> state txns retained until all proxies have seen them
    (Resolver.actor.cpp:59-123)."""

    def __init__(self):
        self._by_version: dict[int, list[StateTransaction]] = {}
        self._sizes: list[tuple[int, int]] = []  # (version, bytes), ascending

    def add(self, version: int, txns: list[StateTransaction], nbytes: int) -> None:
        self._by_version[version] = txns
        if nbytes > 0:
            self._sizes.append((version, nbytes))

    def erase_up_to(self, oldest_version: int) -> int:
        for v in [v for v in self._by_version if v <= oldest_version]:
            del self._by_version[v]
        erased = 0
        while self._sizes and self._sizes[0][0] <= oldest_version:
            erased += self._sizes.pop(0)[1]
        return erased

    def apply_to_reply(
        self, reply: ResolveTransactionBatchReply, first_unseen: int, commit_version: int
    ) -> None:
        # Prior versions only: the requesting proxy has this version's state
        # txns already; other proxies will see them as a prior version. One
        # inner list per version — the wire format's nested VectorRef shape
        # (ResolverInterface.h:141) — so the proxy applies version by version.
        for v in sorted(self._by_version):
            if first_unseen <= v < commit_version:
                reply.state_mutations.append(self._by_version[v])

    @property
    def size(self) -> int:
        return len(self._sizes)

    def first_version(self) -> int:
        return self._sizes[0][0] if self._sizes else -1


class Resolver:
    """One resolver role instance (Resolver.actor.cpp:126-213 state)."""

    def __init__(
        self,
        sched: Scheduler,
        config: KernelConfig,
        *,
        resolver_id: int = 0,
        resolver_count: int = 1,
        commit_proxy_count: int = 1,
        state_memory_limit: int = None,  # None -> the server knob
        init_version: int = -1,  # reference: Resolver() : version(-1)
        backend: str = None,  # "cuda" | "cpu" | None: the knob
        num_logs: int = 1,  # tlog count for the version-vector tpcv path
        device=None,  # the card when None; "cpu" for the plain versions
    ):
        self.sched = sched
        self.resolver_id = resolver_id
        self.resolver_count = resolver_count
        self.commit_proxy_count = commit_proxy_count
        self.state_memory_limit = (
            SERVER_KNOBS.RESOLVER_STATE_MEMORY_LIMIT
            if state_memory_limit is None
            else state_memory_limit
        )

        # Contention-profile routing: with the knob's "cuda" the backend
        # is chosen lazily at the first batch, from its contention
        # profile (backend_for_profile), through the knob gate. The
        # choice is one-shot: switching backends later would discard
        # the MVCC history; profile drift after the choice raises a
        # TraceEvent (SevWarn) advising reconfiguration, never a silent
        # switch. An explicit backend is built now, "cuda" ungated.
        self._config = config
        self._backend_requested = backend
        self._device = device
        self._profile: str | None = None
        if backend is None and SERVER_KNOBS.RESOLVER_BACKEND == "cuda":
            self.conflict_set = None  # routed at first resolve
        else:
            self.conflict_set = make_conflict_set(config, backend,
                                                  device=device)
        # kernel-panel fallback: an unrouted conflict set still reports
        # a zeroed qos.kernel block
        self._fallback_kernel_metrics = KernelStageMetrics()
        self.version = Notified(init_version)
        self.needed_version = Notified(-(2**62))
        self.check_needed_version = Trigger()
        # Fired whenever needed_version or total_state_bytes changes — the
        # events the reference's backpressure loop waits on
        # (`totalStateBytes.onChange() || neededVersion.onChange()`, :261).
        self._state_changed = Trigger()
        self.total_state_bytes = 0
        self.recent_state = _RecentStateTransactionsInfo()
        self.proxy_info: dict[Optional[str], _ProxyRequestsInfo] = {}
        # Version-vector state (knob ENABLE_VERSION_VECTOR_TLOG_UNICAST;
        # Resolver.actor.cpp:746-750 tpcvVector): per-tlog previous
        # commit version, lazily initialized to the first batch's
        # prev_version (the :486-488 invalidVersion fill).
        self.num_logs = num_logs
        self.tpcv_vector: Optional[list[int]] = None
        # Knob-gated private-mutations path (Resolver.actor.cpp:372-441 +
        # design/transaction-state-store.md): when on, this resolver
        # materializes committed state-txn mutations into its own
        # txnStateStore at resolve time and returns them as
        # reply.private_mutations, so proxies consume resolver-generated
        # metadata instead of re-deriving it.
        self.private_mutations_enabled = bool(
            SERVER_KNOBS.PROXY_USE_RESOLVER_PRIVATE_MUTATIONS
        )
        self.txn_state_store: dict[bytes, bytes] = {}

        self.counters = CounterCollection(
            "ResolverMetrics",
            [
                "resolveBatchIn",
                "resolveBatchStart",
                "resolveBatchOut",
                "resolvedTransactions",
                "resolvedBytes",
                "resolvedReadConflictRanges",
                "resolvedWriteConflictRanges",
                "transactionsAccepted",
                "transactionsTooOld",
                "transactionsConflicted",
                "resolvedStateTransactions",
                "resolvedStateMutations",
                "resolvedStateBytes",
            ],
        )
        self.resolver_latency = LatencySample("resolverLatency")
        self.queue_wait_latency = LatencySample("queueWaitLatency")
        self.compute_time = LatencySample("computeTime")
        self.queue_depth = LatencySample("queueDepth")
        # busy-fraction smoother (the Ratekeeper's resolver-occupancy
        # input): compute seconds as a decayed rate on the VIRTUAL
        # clock — deterministic per seed, ~0 in sim unless a scenario
        # models compute delay, ~1.0 on a saturated wire resolver
        self.occupancy = Smoother(2.0, clock=sched.now)
        #: virtual per-transaction resolution cost (seconds of VIRTUAL
        #: clock awaited per transaction before the conflict check).
        #: 0.0 in ordinary sims (resolution is instantaneous in virtual
        #: time, so a sim cluster has no finite capacity to saturate);
        #: saturation/overload scenarios set it so offered load past
        #: 1/cost txn/s genuinely backs up — the occupancy Smoother
        #: then reads a true busy fraction, which is the Ratekeeper's
        #: resolver_busy input.
        self.sim_compute_cost_per_txn = 0.0
        # iops sample feeding the ResolutionBalancer (Resolver.actor.cpp:
        # 337-344). Bounded: the reference samples with decay; an
        # unbounded dict leaks on long multi-resolver soaks.
        self._key_sample: dict[bytes, int] = {}

    def _set_needed_version(self, v: int) -> None:
        if v > self.needed_version.get():
            self.needed_version.set(v)
            self._state_changed.trigger()

    # -- the resolve endpoint --------------------------------------------

    def _route_backend(self, transactions) -> None:
        self._profile = profile_transactions(transactions)
        # config-aware: with read dedup or the endpoint sweep configured
        # the hot_key and range_heavy profiles stay on the card too
        chosen = backend_for_profile(self._profile, self._config)
        self.conflict_set = (
            make_conflict_set(self._config, "cpu") if chosen == "cpu"
            else _gated_conflict_set(self._config, self._device)
        )
        TraceEvent("ResolverBackendRouted").detail(
            "Profile", self._profile
        ).detail("Backend", type(self.conflict_set).__name__).log()

    async def resolve(
        self, req: ResolveTransactionBatchRequest
    ) -> Optional[ResolveTransactionBatchReply]:
        """Handle one ResolveTransactionBatchRequest.

        Returns the reply, or None for the reference's `Never()` (an
        unknown duplicate whose reply was already acked — the proxy will
        retry elsewhere or die).
        """
        request_time = self.sched.now()
        span = Span(
            f"resolver{self.resolver_id}.resolveBatch",
            parent=SpanContext(*req.span) if req.span else None,
            clock=self.sched.now,
        ).attribute("version", req.version)
        try:
            return await self._resolve_spanned(req, span, request_time)
        finally:
            span.finish()  # failure/cancellation paths still export

    async def _resolve_spanned(self, req, span, request_time):
        proxy_key = req.proxy_id if req.prev_version >= 0 else None
        proxy_info = self.proxy_info.setdefault(proxy_key, _ProxyRequestsInfo())
        self.counters.add("resolveBatchIn")
        # Same micro-event locations as the reference, for commit-path
        # latency debugging (Resolver.actor.cpp:244,266,320,509); the
        # strings live in utils/commit_debug.py — the reconstructor and
        # this emitter must never drift.
        if req.debug_id is not None:
            trace.g_trace_batch.add_event(
                "CommitDebug", req.debug_id, _cd.RESOLVER_BEFORE
            )

        # Memory backpressure (Resolver.actor.cpp:254-268): wait for
        # needed_version / total_state_bytes to move.
        code_probe(
            self.total_state_bytes > self.state_memory_limit,
            "resolver.backpressure_breached",
        )
        while (
            self.total_state_bytes > self.state_memory_limit
            and self.recent_state.size
            and proxy_info.last_version > self.recent_state.first_version()
            and req.version > self.needed_version.get()
        ):
            await self._state_changed.on_trigger()
        if req.debug_id is not None:
            trace.g_trace_batch.add_event(
                "CommitDebug", req.debug_id, _cd.RESOLVER_AFTER_QUEUE
            )

        # Version chain (:271-293). The loop re-evaluates needed_version on
        # every check_needed_version trigger (the reference's choose/when),
        # so a stalled chain can be broken by raising needed_version.
        while True:
            if (
                self.recent_state.size
                and proxy_info.last_version <= self.recent_state.first_version()
            ):
                self._set_needed_version(
                    max(self.needed_version.get(), req.prev_version)
                )
            waiters = self.version.num_waiting()
            if self.version.get() < req.prev_version:
                waiters += 1
            self.queue_depth.sample(waiters)
            idx, _ = await any_of(
                [
                    self.version.when_at_least(req.prev_version),
                    self.check_needed_version.on_trigger(),
                ]
            )
            if idx == 0:
                self.queue_depth.sample(self.version.num_waiting())
                break
        self.queue_wait_latency.sample(self.sched.now() - request_time)
        if req.debug_id is not None:
            trace.g_trace_batch.add_event(
                "CommitDebug", req.debug_id, _cd.RESOLVER_AFTER_ORDERER
            )

        if (
            self.sim_compute_cost_per_txn
            and req.transactions
            # a redelivered duplicate (version already advanced past
            # this batch's prev) takes the cached-reply path below and
            # must not re-pay the service delay or re-count busy time
            and self.version.get() == req.prev_version
        ):
            # virtual service time (saturation scenarios): awaited
            # BEFORE the version check below so the duplicate-batch
            # dispatch decision still happens after the last await —
            # the compute phase proper must stay await-free. Successor
            # batches stay blocked on the version chain throughout, so
            # service is serialized and capacity is 1/cost txn/s.
            cost = self.sim_compute_cost_per_txn * len(req.transactions)
            await self.sched.delay(cost)
            # the modeled compute seconds feed the busy-fraction
            # smoother exactly like measured compute in dt_compute
            self.occupancy.add_delta(cost)

        if self.version.get() == req.prev_version:
            # ---- compute phase (no awaits until version.set) -----------
            begin_compute = self.sched.now()
            self.counters.add("resolveBatchStart")
            self.counters.add("resolvedTransactions", len(req.transactions))
            self.counters.add(
                "resolvedBytes", sum(_txn_bytes(tr) for tr in req.transactions)
            )

            if proxy_info.last_version > 0:
                for v in [
                    v
                    for v in proxy_info.outstanding_batches
                    if v <= req.last_received_version
                ]:
                    del proxy_info.outstanding_batches[v]

            first_unseen_version = proxy_info.last_version + 1
            proxy_info.last_version = req.version

            reply = ResolveTransactionBatchReply(debug_id=req.debug_id)
            proxy_info.outstanding_batches[req.version] = reply

            for tr in req.transactions:
                self.counters.add(
                    "resolvedReadConflictRanges", len(tr.read_conflict_ranges)
                )
                self.counters.add(
                    "resolvedWriteConflictRanges", len(tr.write_conflict_ranges)
                )
                # the ResolutionBalancer's key sample, armed on every
                # resolver: the balancer and the hotspot sensors need
                # conflict-range density on single-resolver clusters too
                for b, _e in tr.read_conflict_ranges + tr.write_conflict_ranges:
                    self._key_sample[b] = self._key_sample.get(b, 0) + 1
                if len(self._key_sample) > KEY_SAMPLE_LIMIT:
                    self._decay_key_sample()

            if self.conflict_set is None:
                self._route_backend(req.transactions)
            elif self._profile is not None and req.transactions:
                drifted = profile_transactions(req.transactions)
                if drifted != self._profile:
                    TraceEvent(
                        "ResolverContentionDrift", severity=SEV_WARN
                    ).detail("Chosen", self._profile).detail(
                        "Observed", drifted
                    ).log()
                    self._profile = drifted  # warn once per change
            result = self.conflict_set.resolve(req.transactions, req.version)
            reply.committed = result.verdicts
            reply.conflicting_key_range_map = result.conflicting_key_ranges
            n_committed = sum(
                1 for v in result.verdicts if v == TransactionResult.COMMITTED
            )
            n_too_old = sum(
                1 for v in result.verdicts if v == TransactionResult.TOO_OLD
            )
            self.counters.add("transactionsAccepted", n_committed)
            self.counters.add("transactionsTooOld", n_too_old)
            code_probe(n_too_old > 0, "resolver.too_old")
            self.counters.add(
                "transactionsConflicted",
                len(req.transactions) - n_committed - n_too_old,
            )

            # ---- state transactions (:386-431) -------------------------
            assert req.prev_version >= 0 or not req.txn_state_transactions
            state_txns: list[StateTransaction] = []
            state_bytes = 0
            for t in req.txn_state_transactions:
                tr = req.transactions[t]
                committed = reply.committed[t] == TransactionResult.COMMITTED
                state_txns.append(
                    StateTransaction(
                        committed=committed,
                        mutations=list(tr.mutations),
                    )
                )
                if committed and self.private_mutations_enabled:
                    # private-mutations path (:372-441): emit candidate
                    # metadata for the proxy (which filters by the GLOBAL
                    # min-combined verdict) and, in single-resolver
                    # configurations — where the local verdict IS the
                    # global one — materialize into this resolver's
                    # txnStateStore. Multi-resolver stores stay passive:
                    # a resolver cannot know the global verdict at
                    # resolve time (the reference's knob path shares this
                    # limitation; it ships default-off,
                    # ServerKnobs.cpp:549).
                    metas = [
                        m for m in tr.mutations if is_metadata_mutation(m)
                    ]
                    if metas:
                        reply.private_mutations[t] = metas
                        if self.resolver_count == 1:
                            for m in metas:
                                self._apply_state_mutation(m)
                state_bytes += sum(_mutation_bytes(m) for m in tr.mutations)
                self.counters.add("resolvedStateMutations", len(tr.mutations))
            self.counters.add("resolvedStateTransactions", len(req.txn_state_transactions))
            self.counters.add("resolvedStateBytes", state_bytes)
            self.recent_state.add(req.version, state_txns, state_bytes)
            self.recent_state.apply_to_reply(reply, first_unseen_version, req.version)
            code_probe(len(state_txns) > 0, "resolver.state_txn_forwarded")
            code_probe(
                first_unseen_version == req.version,
                "resolver.first_unseen_is_current",
            )

            # ---- trim state every proxy has seen (:449-474) ------------
            # The map holds one entry per proxy plus the master's (key None,
            # created by the recovery request with prev_version < 0); state
            # is only trimmed once every expected peer has reported in.
            assert len(self.proxy_info) <= self.commit_proxy_count + 1
            oldest_proxy_version = req.version
            for key, info in self.proxy_info.items():
                if key is not None:
                    oldest_proxy_version = min(info.last_version, oldest_proxy_version)
            any_popped = False
            if (
                first_unseen_version <= oldest_proxy_version
                and len(self.proxy_info) == self.commit_proxy_count + 1
            ):
                erased = self.recent_state.erase_up_to(oldest_proxy_version)
                any_popped = erased > 0
                state_bytes -= erased

            # ---- version-vector tpcvMap (:475-495, knob-gated) ---------
            if (
                SERVER_KNOBS.ENABLE_VERSION_VECTOR_TLOG_UNICAST
                and self.num_logs
            ):
                # state/metadata batches broadcast to every log; plain
                # batches touch only the written tags' log locations
                # (tag -> log via round-robin, our LogSystem's layout)
                if state_txns or reply.private_mutations:
                    written_tlogs = set(range(self.num_logs))
                else:
                    written_tlogs = {
                        t % self.num_logs for t in req.written_tags
                    }
                # the reference refills while tpcvVector[0] ==
                # invalidVersion (-1): a recovery batch's prev_version
                # of -1 leaves the vector "uninitialized" so the first
                # real batch seeds it with ITS prev_version (:486-488)
                if self.tpcv_vector is None or self.tpcv_vector[0] == -1:
                    self.tpcv_vector = [req.prev_version] * self.num_logs
                for tl in sorted(written_tlogs):
                    reply.tpcv_map[tl] = self.tpcv_vector[tl]
                    self.tpcv_vector[tl] = req.version
                reply.written_tags = frozenset(req.written_tags)

            self.version.set(req.version)
            breached = (
                self.total_state_bytes <= self.state_memory_limit
                < self.total_state_bytes + state_bytes
            )
            self.total_state_bytes += state_bytes
            self._state_changed.trigger()
            if any_popped or breached:
                self.check_needed_version.trigger()
            dt_compute = self.sched.now() - begin_compute
            self.compute_time.sample(dt_compute)
            self.occupancy.add_delta(dt_compute)
        else:
            # duplicate resolve batch request (:513)
            code_probe(
                req.version in proxy_info.outstanding_batches,
                "resolver.duplicate_batch_replayed",
            )

        self.counters.add("resolveBatchOut")
        self.resolver_latency.sample(self.sched.now() - request_time)
        if req.debug_id is not None:
            trace.g_trace_batch.add_event(
                "CommitDebug", req.debug_id, _cd.RESOLVER_AFTER
            )
        out = proxy_info.outstanding_batches.get(req.version)
        code_probe(out is None, "resolver.unknown_duplicate_never")
        span.attribute("txns", len(req.transactions))
        return out  # None == the reference's Never()

    # -- saturation sensors (the Ratekeeper's resolver occupancy input) ----

    def saturation(self) -> dict:
        """The resolver's qos sensor block: the reference's exact four
        distributions (resolverLatencyDist / queueWaitLatencyDist /
        computeTimeDist / queueDepthDist, Resolver.actor.cpp:156-213)
        plus state-memory pressure and — on kernel backends — the card's
        occupancy summary from KernelStageMetrics. All virtual-clock
        samples: deterministic per seed, safe next to trace digests."""
        out = {
            "queue_depth": self.version.num_waiting(),
            "occupancy": self.occupancy.smooth_rate(),
            "queue_depth_dist": self.queue_depth.as_dict(),
            "queue_wait_dist": self.queue_wait_latency.as_dict(),
            "compute_time_dist": self.compute_time.as_dict(),
            "resolver_latency_dist": self.resolver_latency.as_dict(),
            "state_bytes": self.total_state_bytes,
            "state_memory_limit": self.state_memory_limit,
            "state_pressure": (
                self.total_state_bytes / self.state_memory_limit
                if self.state_memory_limit else 0.0
            ),
            # the conflict-range key sample: the
            # ResolutionBalancer's split input, surfaced as a sensor —
            # top conflict-range begin keys by touch count
            "key_sample": self._key_sample_qos(),
        }
        # kernel panel: always present — an unrouted backend reports
        # the zeroed fallback (which still carries the process-wide
        # kernel build counters), never a missing key
        metrics = (
            getattr(self.conflict_set, "metrics", None)
            or self._fallback_kernel_metrics
        )
        out["kernel"] = metrics.qos()
        return out

    # -- balancer endpoints (ResolverInterface metrics/split) -------------

    def _apply_state_mutation(self, m) -> None:
        """Materialize one metadata mutation into the resolver-side
        txnStateStore (the LogSystemDiskQueueAdapter-materialized store,
        design/transaction-state-store.md)."""
        apply_state_mutation(self.txn_state_store, m)

    def _key_sample_qos(self) -> dict:
        """The key-sample sensor block (cluster/sampling.key_sample_qos)."""
        return key_sample_qos(self._key_sample)

    def _decay_key_sample(self) -> None:
        """Halve all counts, dropping zeros; if the key set itself is too
        wide, keep the heaviest half. Split points stay representative
        (hot boundaries survive decay by construction) while memory stays
        O(KEY_SAMPLE_LIMIT) forever."""
        self._key_sample = {
            k: c // 2 for k, c in self._key_sample.items() if c // 2 > 0
        }
        if len(self._key_sample) > KEY_SAMPLE_LIMIT:
            top = sorted(self._key_sample.items(), key=lambda kv: -kv[1])
            self._key_sample = dict(top[: KEY_SAMPLE_LIMIT // 2])

    def metrics(self) -> int:
        """ResolutionMetricsRequest: total sampled conflict-range ops."""
        return sum(self._key_sample.values())

    def split_point(self, begin: bytes, end: bytes, offset_fraction: float) -> bytes:
        """ResolutionSplitRequest: a key splitting the sampled load in
        [begin, end) at the given fraction (ResolutionBalancer semantics)."""
        keys = sorted(k for k in self._key_sample if begin <= k < end)
        if not keys:
            return begin
        total = sum(self._key_sample[k] for k in keys)
        target = total * offset_fraction
        acc = 0
        for k in keys:
            acc += self._key_sample[k]
            if acc >= target:
                return k
        return keys[-1]


def _mutation_bytes(m: Any) -> int:
    try:
        return len(m[1]) + len(m[2]) + 8  # (type, param1, param2)
    except Exception:
        return 32


def _txn_bytes(tr: CommitTransaction) -> int:
    """CommitTransactionRef::expectedSize analog (conflict ranges + mutations)."""
    n = sum(
        len(b) + len(e)
        for b, e in tr.read_conflict_ranges + tr.write_conflict_ranges
    )
    return n + sum(_mutation_bytes(m) for m in tr.mutations)
