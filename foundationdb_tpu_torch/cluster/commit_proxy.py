"""CommitProxy: the 5-phase commit pipeline.

Behavioral mirror of `fdbserver/CommitProxyServer.actor.cpp`:

* `commit_batcher` (:361): accumulates client CommitTransactionRequests
  into batches bounded by count/bytes/interval.
* `commit_batch` (:2516-2555) phases:
  1. pre-resolution (:812): batches are version-ordered; get the
     (prev_version, version] pair from the Sequencer.
  2. resolution (:959): ResolutionRequestBuilder splits every txn's
     conflict ranges across resolvers by the key_resolvers partition
     (:105-261) — each resolver sees only the pieces in its partition but
     every resolver sees every batch version (the version chain); state
     transactions go to all resolvers.
  3. post-resolution (:2045): committed = min over the verdicts of the
     resolvers each txn touched (determineCommittedTransactions
     :1551-1567); metadata mutations of committed state txns apply to the
     txn-state store (applyMetadataToCommittedTransactions :1596);
     mutations get storage tags by key_servers shard
     (assignMutationsToStorageServers :1861).
  4. transaction logging (:2294): one TLog push per batch, version chained.
  5. reply (:2333): report the live committed version to the Sequencer,
     then answer clients (committed version / not_committed with the
     conflicting-range report).

Batch pipelining: successive batches overlap; ordering is enforced by the
latest_batch_resolving / latest_batch_logging Notified chains
(:822-853, 1020), exactly the reference's NotifiedVersion discipline.

The port's own copy of foundationdb_tpu.cluster.commit_proxy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from foundationdb_tpu_torch.models.types import (
    CommitTransaction,
    ResolveTransactionBatchRequest,
    TransactionResult,
)
from foundationdb_tpu_torch.runtime.flow import (
    Notified,
    Promise,
    PromiseStream,
    Scheduler,
    all_of,
)
from foundationdb_tpu_torch.utils import commit_debug as _cd
from foundationdb_tpu_torch.utils import trace as _trace
from foundationdb_tpu_torch.utils.metrics import (
    COMMIT_LATENCY_BANDS,
    CounterCollection,
    LatencyBands,
    LatencySample,
)
from foundationdb_tpu_torch.utils.probes import code_probe, declare

declare("proxy.conservative_write_injected", "proxy.min_combine_abort")

from foundationdb_tpu_torch.models.types import (  # noqa: F401 (re-export)
    SYSTEM_PREFIX,
    is_metadata_mutation as _is_metadata_shared,
)


#: the databaseLocked key (cluster/dr.py writes it; the reference's
#: analog is \xff/dbLocked consulted by proxies via the txnStateStore)
DB_LOCK_KEY = b"\xff/dr/locked"


class DatabaseLockedError(Exception):
    """error_code_database_locked: commits refused while the database is
    locked (DR destination / retired DR source)."""


class NotCommitted(Exception):
    """error_code_not_committed; carries the conflicting read-range report."""

    def __init__(self, conflicting_ranges: Optional[list[int]] = None):
        super().__init__("transaction conflict")
        self.conflicting_ranges = conflicting_ranges


class TransactionTooOldError(Exception):
    """error_code_transaction_too_old from the resolver verdict."""


class CommitUnknownResult(Exception):
    """error_code_commit_unknown_result: the proxy died mid-commit; the
    transaction may or may not have committed (retryable, as in the
    reference's client onError)."""


@dataclasses.dataclass
class CommitID:
    """Commit reply payload (the reference's CommitID): the version plus
    the 10-byte versionstamp (8B big-endian version + 2B batch order)."""

    version: int
    versionstamp: bytes


@dataclasses.dataclass
class CommitRequest:
    transaction: CommitTransaction
    reply: Promise  # -> CommitID, or error
    # arrival time (virtual) — commit latency bands; None for synthetic
    # requests (conservative writes) that never came from a client
    start: Optional[float] = None


@dataclasses.dataclass
class KeyPartition:
    """Static key-range partition: boundaries[i] starts shard i+1.

    Stands in for the dynamic keyResolvers / keyServers maps
    (CommitProxyServer.actor.cpp:147-196, fdbclient/SystemData.cpp).
    """

    boundaries: list[bytes]

    @property
    def n_shards(self) -> int:
        return len(self.boundaries) + 1

    def shard_of(self, key: bytes) -> int:
        s = 0
        for b in self.boundaries:
            if key >= b:
                s += 1
            else:
                break
        return s

    def clip(self, begin: bytes, end: bytes, shard: int):
        lo = self.boundaries[shard - 1] if shard > 0 else b""
        hi = self.boundaries[shard] if shard < len(self.boundaries) else None
        cb = max(begin, lo)
        ce = end if hi is None else min(end, hi)
        return (cb, ce) if cb < ce else None

    def shards_of_range(self, begin: bytes, end: bytes) -> list[int]:
        return [
            s for s in range(self.n_shards)
            if self.clip(begin, end, s) is not None
        ]


class CommitProxy:
    def __init__(
        self,
        sched: Scheduler,
        proxy_id: str,
        sequencer,
        resolvers: list,            # objects with .resolve(req) coroutine
        tlog,                       # TLog
        key_resolvers: KeyPartition,
        key_servers: KeyPartition,
        *,
        epoch: int = 1,
        batch_interval: float = 0.005,
        max_batch_txns: int = 512,
        on_state_mutation: Optional[Callable[[Any], None]] = None,
        txn_state_view: Optional[dict] = None,
    ):
        self.sched = sched
        self.epoch = epoch
        self.proxy_id = proxy_id
        self.sequencer = sequencer
        self.resolvers = resolvers
        self.tlog = tlog
        self.key_resolvers = key_resolvers
        self.key_servers = key_servers
        self.batch_interval = batch_interval
        self.max_batch_txns = max_batch_txns
        # Adaptive batching (the reference's dynamic commitBatcher):
        # ctor args seed the controller — batch_interval is the initial
        # accumulation window, max_batch_txns the initial count target —
        # and the knob bounds cap every excursion. See cluster/batching.
        from foundationdb_tpu_torch.cluster.batching import AdaptiveBatchSizer
        from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS as _K

        # max_interval is capped at the ctor interval: adaptivity only
        # SHRINKS the window under load and relaxes back to the
        # configured cadence — idle behavior is byte-identical to a
        # fixed-interval proxy (existing sims keep their schedules).
        self.batch_sizer = AdaptiveBatchSizer(
            interval=batch_interval,
            min_interval=min(
                batch_interval, _K.COMMIT_TRANSACTION_BATCH_INTERVAL_MIN
            ),
            max_interval=min(
                batch_interval,
                _K.COMMIT_TRANSACTION_BATCH_INTERVAL_MAX,
            ),
            target_count=max_batch_txns,
            max_count=max(
                max_batch_txns, _K.COMMIT_TRANSACTION_BATCH_COUNT_MAX
            ),
            max_bytes=_K.COMMIT_TRANSACTION_BATCH_BYTES_MAX,
            latency_budget=_K.COMMIT_BATCH_STAGE_LATENCY_BUDGET,
            alpha=_K.COMMIT_TRANSACTION_BATCH_INTERVAL_SMOOTHER_ALPHA,
            latency_fraction=_K.COMMIT_TRANSACTION_BATCH_INTERVAL_LATENCY_FRACTION,
        )
        self.on_state_mutation = on_state_mutation
        # read-only view of the materialized txn-state store: the
        # dbLocked check consults it so EVERY client handle is covered
        self.txn_state_view = txn_state_view if txn_state_view is not None else {}

        self.requests = PromiseStream()
        self._batch_num = 0
        self._request_num = 0
        self.latest_batch_resolving = Notified(0)
        self.latest_batch_logging = Notified(0)
        self.last_received_version = 0
        self.committed_version = Notified(0)
        self.counters = CounterCollection(
            "ProxyMetrics",
            ["txnCommitIn", "txnCommitOut", "txnConflicts", "commitBatchIn"],
        )
        # commit latency distribution + reference-style bands
        # (CommitProxyServer.actor.cpp commitLatencyBands): request
        # arrival -> reply, in virtual time
        self.commit_latency = LatencySample("commitLatency")
        self.latency_bands = LatencyBands(
            "CommitLatencyMetrics", COMMIT_LATENCY_BANDS
        )
        # busiest-write-tag sensor: committed mutation bytes
        # per tag prefix, virtual-clock smoothed (deterministic)
        from foundationdb_tpu_torch.cluster.sampling import TagCounter

        self.write_tags = TagCounter(clock=sched.now)
        self.failed: Optional[BaseException] = None
        # Ranges recently moved between resolvers (ResolutionBalancer):
        # the next batch injects a synthetic blind write over each so the
        # receiving resolver's empty history can't miss stale-read
        # conflicts (the reference applies resolverChanges with the same
        # conservative effect at the transition version).
        self.conservative_writes: list[tuple[bytes, bytes]] = []
        self._task = None
        # INSERTION-ORDERED (dict-as-set, not set): stop() cancels these
        # tasks in iteration order, and a set of Task OBJECTS iterates
        # in id()-hash order — allocation addresses, which vary run to
        # run. A recovery killing a proxy with two in-flight batches
        # then cancels them in varying order, the clients' unknown-
        # result deliveries swap, and the simulation DIVERGES between
        # identical seeds (found by a seed ensemble's determinism
        # re-runs at 3/2000 seeds; reproduced + bisected via scheduler
        # event-stream diffing).
        self._inflight: dict = {}
        self._collecting: list[CommitRequest] = []
        # BUGGIFY_DUPLICATE_RESOLVE: recent resolve requests kept for
        # replay (a proxy retry after a lost reply). Old entries replay
        # as requests the resolver has pruned from its reply window.
        self._replay_ring: list = []
        # armed stream waiter carried across idle batcher rounds
        self._pending_next = None

    def start(self) -> None:
        self._task = self.sched.spawn(self._batcher(), name=f"{self.proxy_id}-batcher")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        # In-flight batches may be wedged on a dead peer's version chain
        # (e.g. a partitioned resolver); cancel them — the error path
        # answers their clients with commit_unknown_result.
        for task in list(self._inflight):
            task.cancel()
        self._inflight.clear()
        # Queued, collected-but-undispatched, or in-stream requests would
        # otherwise dangle forever; the reference's clients see
        # broken_promise from a dead proxy.
        for req in self._collecting:
            if not req.reply.is_set:
                req.reply.send_error(CommitUnknownResult())
        self._collecting = []
        # a request captured by the armed idle waiter must not dangle
        if self._pending_next is not None:
            if self._pending_next.is_ready and not self._pending_next.is_error:
                req = self._pending_next.get()
                if not req.reply.is_set:
                    req.reply.send_error(CommitUnknownResult())
            self._pending_next = None
        queue = self.requests.stream._queue
        while queue:
            req = queue.pop(0)
            if not req.reply.is_set:
                req.reply.send_error(CommitUnknownResult())

    # -- saturation sensors ------------------------------------------------

    def saturation(self) -> dict:
        """The commit proxy's qos sensor block: in-flight batch depth
        (the pipelined-batch overlap the Notified chains order), queued
        and mid-accumulation requests, and the AdaptiveBatchSizer's live
        interval/count/bytes targets — the control surface the future
        Ratekeeper reads before deciding a txn/s budget."""
        return {
            "inflight_batches": len(self._inflight),
            "queued_requests": (
                len(self.requests.stream._queue) + len(self._collecting)
            ),
            "batches_started": self._batch_num,
            "batches_logged": self.latest_batch_logging.get(),
            "batch_sizer": self.batch_sizer.as_dict(),
            # scale-out sensors, shared schema with the wire proxy:
            # grants = GetCommitVersion round-trips to the sequencer;
            # tag_partitioned reports the log front's REAL per-tag
            # fan-out state (LogSystem.tag_partitioned), so the sensor
            # means the same thing the wire pipeline's does
            "version_grants": self._request_num,
            "tag_partitioned": bool(
                getattr(self.tlog, "tag_partitioned", False)
            ),
            "failed": self.failed is not None,
            # busiest-write-tag: committed bytes by tag
            # prefix as assigned to storage tags in _assign_mutations
            "busiest_write_tag": self.write_tags.busiest(),
        }

    # -- client entry -----------------------------------------------------

    def commit(self, txn: CommitTransaction) -> Promise:
        p = Promise()
        self.counters.add("txnCommitIn")
        if self.failed is not None or self._task is None:
            # Dead/stopped proxy: the retryable commit_unknown_result, as
            # the reference's clients see while recovery replaces the
            # generation (fdbserver/ClusterRecovery.actor.cpp).
            p.send_error(CommitUnknownResult())
            return p
        self.requests.send(CommitRequest(txn, p, start=self.sched.now()))
        return p

    # -- phase 0: batching (commitBatcher :361) ----------------------------

    async def _batcher(self) -> None:
        from foundationdb_tpu_torch.cluster.batching import commit_txn_bytes
        from foundationdb_tpu_torch.runtime.flow import any_of

        while True:
            # Wait for traffic, but never idle past the forced-batch
            # interval: an idle proxy still emits EMPTY batches so its
            # lastVersion keeps advancing at every resolver — otherwise
            # retained state transactions (consumed only once every proxy
            # has passed them) pin resolver memory and the backpressure
            # loop can wedge the whole pipeline on one quiet proxy
            # (the reference's commitBatcher forced-batch behavior,
            # CommitProxyServer.actor.cpp commitBatcher's
            # MAX_COMMIT_BATCH_INTERVAL).
            # The head request always comes through the tracked armed
            # waiter: send() delivers values INTO waiter futures, so a
            # stop() between delivery and resumption would orphan an
            # untracked one (stop recovers self._pending_next).
            sizer = self.batch_sizer
            ok, first = self.requests.stream.try_next()
            if not ok:
                if self._pending_next is None:
                    self._pending_next = self.requests.stream.next()
                idx, val = await any_of(
                    [
                        self._pending_next,
                        self.sched.delay(10 * sizer.interval),
                    ]
                )
                if idx == 1:
                    self._spawn_batch([])  # idle forced empty batch
                    continue
                self._pending_next = None
                first = val
            # self._collecting is visible to stop(): requests gathered but
            # not yet dispatched must not die silently with the batcher.
            batch = self._collecting = [first]
            # adaptive targets, snapshotted at batch open (the controller
            # moves between batches, never mid-accumulation)
            count_target = min(sizer.target_count, self.max_batch_txns)
            bytes_target = sizer.target_bytes
            batch_bytes = commit_txn_bytes(first.transaction)
            deadline = self.sched.now() + sizer.interval

            def drain():
                nonlocal batch_bytes
                while (
                    len(batch) < count_target
                    and batch_bytes < bytes_target
                ):
                    ok, req = self.requests.stream.try_next()
                    if not ok:
                        return
                    batch.append(req)
                    batch_bytes += commit_txn_bytes(req.transaction)

            def full() -> bool:
                return (
                    len(batch) >= count_target
                    or batch_bytes >= bytes_target
                )

            drain()
            # allow a short accumulation window
            while not full() and self.sched.now() < deadline:
                await self.sched.delay(sizer.interval / 4)
                drain()
            self._collecting = []
            # dispatch-side feedback: a full batch means traffic outran
            # the window (shrink it); an underfull interval-expiry batch
            # relaxes it back toward the MAX knob
            if full():
                sizer.batch_full()
            else:
                sizer.batch_underfull(len(batch))
            self._spawn_batch(batch, was_full=full())

    def _spawn_batch(self, batch: list, was_full: bool = False) -> None:
        self._batch_num += 1
        task = self.sched.spawn(
            self._commit_batch(batch, self._batch_num, was_full),
            name=f"{self.proxy_id}-batch{self._batch_num}",
        )
        self._inflight[task] = None
        task.done.add_done_callback(
            lambda _f, t=task: self._inflight.pop(t, None)
        )

    # -- phases 1-5 (commitBatch :2516) ------------------------------------

    async def _commit_batch(
        self, batch: list[CommitRequest], batch_num: int,
        was_full: bool = False,
    ) -> None:
        try:
            await self._commit_batch_impl(batch, batch_num, was_full)
        except BaseException as e:
            # An internal failure must not strand the clients (their reply
            # futures) nor leave the error invisible. The version chain may
            # now have a hole, so the proxy marks itself broken — the
            # reference's equivalent outcome is a recovery.
            self.failed = e
            for r in batch:
                if not r.reply.is_set:
                    r.reply.send_error(CommitUnknownResult())
            raise

    async def _commit_batch_impl(
        self, batch: list[CommitRequest], batch_num: int,
        was_full: bool = False,
    ) -> None:
        self.counters.add("commitBatchIn")
        # span per commit batch (the reference's commitBatch span,
        # Tracing.actor.cpp); children: the resolution requests. The
        # span parents on the first traced transaction's client span
        # (the reference's multi-parent span collapsed to one edge), so
        # a trace runs client -> proxy -> resolver.
        from foundationdb_tpu_torch.utils.spans import Span, SpanContext

        parent = next(
            (
                SpanContext(*r.transaction.span)
                for r in batch
                if r.transaction.span is not None
            ),
            None,
        )
        batch_span = Span(
            f"{self.proxy_id}.commitBatch", parent=parent,
            clock=self.sched.now,
        ).attribute("txns", len(batch))
        # batch debug id (deterministic — the reference draws one at
        # random and attaches every member txn's id to it): emitted only
        # when some member is traced
        dbg = None
        if any(r.transaction.debug_id is not None for r in batch):
            dbg = f"{self.proxy_id}-b{batch_num}"
            for r in batch:
                if r.transaction.debug_id is not None:
                    _trace.g_trace_batch.add_attach(
                        "CommitAttachID", r.transaction.debug_id, dbg
                    )
            _trace.g_trace_batch.add_event(
                "CommitDebug", dbg, _cd.BATCH_BEFORE
            )
        try:
            await self._commit_batch_spanned(
                batch, batch_num, batch_span, dbg, was_full
            )
        finally:
            # failure paths (dead resolver, recovery kill) still export
            batch_span.finish()

    async def _commit_batch_spanned(
        self, batch, batch_num, batch_span, dbg, was_full=False
    ):
        # databaseLocked (NativeAPI's commit check against \xff/dbLocked,
        # here proxy-side via the materialized txn-state store so no
        # client handle can bypass it): non-lock-aware txns fail fast.
        if self.txn_state_view.get(DB_LOCK_KEY) is not None:
            passing = []
            for r in batch:
                if getattr(r.transaction, "lock_aware", False):
                    passing.append(r)
                else:
                    r.reply.send_error(DatabaseLockedError())
            batch = passing
            if not batch:
                # the batch-ordering chains must still advance — IN ORDER
                # (set() without awaiting the predecessor would violate
                # the monotonic Notified contract when an earlier batch
                # is still mid-flight)
                await self.latest_batch_resolving.when_at_least(batch_num - 1)
                self.latest_batch_resolving.set(batch_num)
                await self.latest_batch_logging.when_at_least(batch_num - 1)
                self.latest_batch_logging.set(batch_num)
                return
        txns = [r.transaction for r in batch]
        # Phase 1: order batches, get the version pair.
        await self.latest_batch_resolving.when_at_least(batch_num - 1)
        if dbg is not None:
            _trace.g_trace_batch.add_event(
                "CommitDebug", dbg, _cd.BATCH_GETTING_VERSION
            )
        self._request_num += 1
        vreply = await self.sequencer.get_commit_version(
            self.proxy_id, self._request_num, self._request_num
        )
        prev_version, version = vreply.prev_version, vreply.version
        if dbg is not None:
            _trace.g_trace_batch.add_event(
                "CommitDebug", dbg, _cd.BATCH_GOT_VERSION
            )

        # Phase 2: resolution.
        if self.conservative_writes:
            code_probe(True, "proxy.conservative_write_injected")
            moved, self.conservative_writes = self.conservative_writes, []
            # PREPENDED: intra-batch conflicts only see lower-indexed
            # writers, so the synthetic write must come before every user
            # transaction to abort same-batch stale reads of the moved
            # span (the reference applies resolverChanges before the
            # batch's transactions).
            batch = [
                CommitRequest(
                    CommitTransaction(write_conflict_ranges=list(moved)),
                    Promise(),
                )
            ] + batch
            txns = [r.transaction for r in batch]
        reqs, txn_resolver_map, range_maps = self._build_resolution_requests(
            txns, prev_version, version
        )
        for rq in reqs:
            rq.span = batch_span.context.as_tuple()
            rq.debug_id = dbg
        self.latest_batch_resolving.set(batch_num)
        _t_resolve = self.sched.now()
        replies = await all_of(
            [
                self.sched.spawn(res.resolve(req)).done
                for res, req in zip(self.resolvers, reqs)
            ]
        )
        _resolve_s = self.sched.now() - _t_resolve
        self.last_received_version = version
        if dbg is not None:
            _trace.g_trace_batch.add_event(
                "CommitDebug", dbg, _cd.BATCH_AFTER_RESOLUTION
            )
        from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS

        if SERVER_KNOBS.BUGGIFY_DUPLICATE_RESOLVE:
            # Re-send resolve requests the resolver has already answered —
            # the retry-after-lost-reply path (Resolver.actor.cpp:513
            # returns the cached reply; requests pruned from the reply
            # window return Never(), so replays are fire-and-forget).
            async def _replay(res, req):
                try:
                    await res.resolve(req)
                # a replayed duplicate is BUGGIFY noise by contract: the
                # real request's error path already ran
                except Exception:  # flowcheck: ignore[actor.swallow]
                    pass

            self._replay_ring.append((self.resolvers[0], reqs[0]))
            if version % 2 == 0:
                # fire-and-forget by design: _replay contains its errors
                self.sched.spawn(_replay(self.resolvers[0], reqs[0]))  # flowcheck: ignore[actor.fire-and-forget]
            if len(self._replay_ring) > 6 and version % 3 == 0:
                res_old, req_old = self._replay_ring.pop(0)
                self.sched.spawn(_replay(res_old, req_old))  # flowcheck: ignore[actor.fire-and-forget]
            del self._replay_ring[:-8]

        # Phase 3: post-resolution (order by logging chain).
        await self.latest_batch_logging.when_at_least(batch_num - 1)
        verdicts, conflict_reports = self._determine_committed(
            txns, replies, txn_resolver_map, range_maps
        )

        # State mutations from other proxies' prior versions first, then
        # this batch's own committed metadata mutations. With the
        # PROXY_USE_RESOLVER_PRIVATE_MUTATIONS knob on, the batch's own
        # metadata arrives resolver-generated (reply.private_mutations,
        # Resolver.actor.cpp:372-441) instead of being re-derived here —
        # the resolver's materialized txnStateStore is authoritative.
        if self.on_state_mutation is not None:
            for group in replies[0].state_mutations:
                for st in group:
                    if st.committed:
                        for m in st.mutations:
                            # a state txn may mix user mutations in; only
                            # metadata belongs in the txn-state store
                            if _is_metadata(m):
                                self.on_state_mutation(m)
            if replies[0].private_mutations:
                # resolver-generated candidates, filtered by the GLOBAL
                # verdict (a locally-committed state txn may be aborted
                # by another resolver's shard)
                for t, tr in enumerate(txns):
                    if verdicts[t] != TransactionResult.COMMITTED:
                        continue
                    local = txn_resolver_map[t].get(0)
                    if local is None:
                        continue
                    for m in replies[0].private_mutations.get(local, []):
                        self.on_state_mutation(m)
            else:
                for t, tr in enumerate(txns):
                    if verdicts[t] == TransactionResult.COMMITTED:
                        for m in tr.mutations:
                            if _is_metadata(m):
                                self.on_state_mutation(m)

        messages = self._assign_mutations(txns, verdicts, version)

        # Phase 4: push to the log system.
        from foundationdb_tpu_torch.cluster.tlog import LOG_STREAM_TAG, TLogCommitRequest

        if dbg is not None:
            # the batch-id -> commit-version join record: storage applies
            # are keyed by version, this is how commit_debug ties them in
            _trace.TraceEvent(
                "CommitDebugVersion", severity=_trace.SEV_DEBUG
            ).detail("ID", dbg).detail("Version", version).detail(
                "Messages",
                sum(1 for tag in messages if tag != LOG_STREAM_TAG),
            ).log()
        _t_log = self.sched.now()
        await self.tlog.commit(
            TLogCommitRequest(
                prev_version=prev_version, version=version, messages=messages,
                epoch=self.epoch, debug_id=dbg,
                span=batch_span.context.as_tuple(),
            )
        )
        self.latest_batch_logging.set(batch_num)
        if batch:
            # completion-side feedback: count/bytes targets follow the
            # measured resolve+log stage seconds (empty idle batches
            # carry no sizing evidence and are excluded)
            self.batch_sizer.observe_stage_latency(
                _resolve_s + (self.sched.now() - _t_log), full=was_full
            )
        if dbg is not None:
            _trace.g_trace_batch.add_event(
                "CommitDebug", dbg, _cd.BATCH_AFTER_LOG_PUSH
            )

        # Phase 5: reply.
        batch_span.attribute("version", version)
        self.sequencer.report_live_committed_version(version)
        self.committed_version.set(version)
        now = self.sched.now()
        for t, req in enumerate(batch):
            v = verdicts[t]
            if req.start is not None:
                dt = now - req.start
                self.commit_latency.sample(dt)
                self.latency_bands.add(dt)
            if v == TransactionResult.COMMITTED:
                self.counters.add("txnCommitOut")
                req.reply.send(CommitID(version, _stamp(version, t)))
            elif v == TransactionResult.TOO_OLD:
                req.reply.send_error(TransactionTooOldError())
            else:
                self.counters.add("txnConflicts")
                req.reply.send_error(NotCommitted(conflict_reports.get(t)))

    # -- ResolutionRequestBuilder (:105-261) --------------------------------

    def _build_resolution_requests(self, txns, prev_version, version):
        n_res = len(self.resolvers)
        per_res_txns: list[list[CommitTransaction]] = [[] for _ in range(n_res)]
        per_res_state: list[list[int]] = [[] for _ in range(n_res)]
        txn_resolver_map: list[dict[int, int]] = []  # t -> {resolver: local idx}
        range_maps: list[dict[int, list[int]]] = []  # t -> {res: local->orig read idx}

        for t, tr in enumerate(txns):
            is_state = any(_is_metadata(m) for m in tr.mutations)
            targets: dict[int, CommitTransaction] = {}
            ridx: dict[int, list[int]] = {}
            for i, (b, e) in enumerate(tr.read_conflict_ranges):
                for s in self.key_resolvers.shards_of_range(b, e):
                    lt = targets.setdefault(
                        s,
                        CommitTransaction(
                            read_snapshot=tr.read_snapshot,
                            report_conflicting_keys=tr.report_conflicting_keys,
                        ),
                    )
                    lt.read_conflict_ranges.append(self.key_resolvers.clip(b, e, s))
                    ridx.setdefault(s, []).append(i)
            for b, e in tr.write_conflict_ranges:
                for s in self.key_resolvers.shards_of_range(b, e):
                    lt = targets.setdefault(
                        s,
                        CommitTransaction(
                            read_snapshot=tr.read_snapshot,
                            report_conflicting_keys=tr.report_conflicting_keys,
                        ),
                    )
                    lt.write_conflict_ranges.append(self.key_resolvers.clip(b, e, s))
            if is_state:
                # state txns go to every resolver (with their mutations)
                for s in range(n_res):
                    lt = targets.setdefault(
                        s,
                        CommitTransaction(
                            read_snapshot=tr.read_snapshot,
                            report_conflicting_keys=tr.report_conflicting_keys,
                        ),
                    )
                    lt.mutations = list(tr.mutations)
            tmap: dict[int, int] = {}
            for s, lt in targets.items():
                tmap[s] = len(per_res_txns[s])
                per_res_txns[s].append(lt)
                if is_state:
                    per_res_state[s].append(tmap[s])
            txn_resolver_map.append(tmap)
            range_maps.append(ridx)

        # version-vector path (knob-gated): ship the batch's written
        # storage tags so resolvers can answer tpcvMap
        # (ResolverInterface.h:139 writtenTags)
        from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS

        written_tags: frozenset = frozenset()
        if SERVER_KNOBS.ENABLE_VERSION_VECTOR_TLOG_UNICAST:
            tags: set = set()
            for tr in txns:
                for b, e in tr.write_conflict_ranges:
                    tags.update(self.key_servers.tags_of_range(b, e))
            written_tags = frozenset(tags)

        reqs = [
            ResolveTransactionBatchRequest(
                prev_version=prev_version,
                version=version,
                last_received_version=self.last_received_version,
                transactions=per_res_txns[s],
                txn_state_transactions=per_res_state[s],
                proxy_id=self.proxy_id,
                written_tags=written_tags,
            )
            for s in range(n_res)
        ]
        return reqs, txn_resolver_map, range_maps

    # -- determineCommittedTransactions (:1551-1567) -------------------------

    def _determine_committed(self, txns, replies, txn_resolver_map, range_maps):
        verdicts: list[TransactionResult] = []
        reports: dict[int, list[int]] = {}
        for t in range(len(txns)):
            v = TransactionResult.COMMITTED
            locals_seen = []
            for s, local in txn_resolver_map[t].items():
                locals_seen.append(int(replies[s].committed[local]))
                v = min(v, replies[s].committed[local])
            # a txn one resolver would commit but another aborts: the
            # min-combine doing real cross-shard work
            code_probe(
                len(locals_seen) > 1
                and v != TransactionResult.COMMITTED
                and any(x == TransactionResult.COMMITTED for x in locals_seen),
                "proxy.min_combine_abort",
            )
            verdicts.append(TransactionResult(v))
            if v == TransactionResult.CONFLICT and txns[t].report_conflicting_keys:
                idxs: set[int] = set()
                for s, local in txn_resolver_map[t].items():
                    lmap = range_maps[t].get(s)  # local read idx -> original
                    for li in replies[s].conflicting_key_range_map.get(local, []):
                        idxs.add(lmap[li] if lmap is not None else li)
                reports[t] = sorted(idxs)
        return verdicts, reports

    # -- assignMutationsToStorageServers (:1861) ------------------------------

    def _assign_mutations(self, txns, verdicts, version: int) -> dict[int, list[Any]]:
        messages: dict[int, list[Any]] = {}
        # full-stream tag for log-consuming workers (backup/DR): each
        # committed mutation EXACTLY ONCE, in commit order — per-storage
        # tags duplicate a mutation per team replica, which would
        # double-apply atomics on replay (BackupWorker's dedicated tags
        # exist for the same reason)
        from foundationdb_tpu_torch.cluster.sampling import tag_of_key
        from foundationdb_tpu_torch.cluster.tlog import LOG_STREAM_TAG

        emit_stream = self.tlog.has_log_consumers()
        for t, tr in enumerate(txns):
            if verdicts[t] != TransactionResult.COMMITTED:
                continue
            for m in tr.mutations:
                kind = m[0]
                if kind == "vs_key":
                    # SetVersionstampedKey: splice the commit stamp into
                    # the key, then it is an ordinary set.
                    _, prefix, suffix, value = m
                    m = ("set", prefix + _stamp(version, t) + suffix, value)
                    kind = "set"
                elif kind == "vs_value":
                    _, key, value_prefix = m
                    m = ("set", key, value_prefix + _stamp(version, t))
                    kind = "set"
                if kind == "set":
                    span = (m[1], m[1] + b"\x00")
                    shards = list(self.key_servers.team_of(m[1]))
                elif kind == "atomic":
                    span = (m[2], m[2] + b"\x00")
                    shards = list(self.key_servers.team_of(m[2]))
                elif kind == "clear":
                    span = (m[1], m[2])
                    shards = self.key_servers.tags_of_range(m[1], m[2])
                else:
                    raise ValueError(f"unknown mutation {m!r}")
                # dual-tag state lives on the SHARED shard map so it
                # survives proxy-generation changes (see ShardMap)
                for b, e, tag in self.key_servers.extra_tag_ranges:
                    if span[0] < e and b < span[1] and tag not in shards:
                        shards.append(tag)
                for s in shards:
                    messages.setdefault(s, []).append(m)
                if emit_stream:
                    messages.setdefault(LOG_STREAM_TAG, []).append(m)
                # busiest-write-tag sensor: committed bytes
                # by tag prefix, counted once per mutation (not per
                # replica — the client wrote it once)
                try:
                    nb = 8 + len(m[1]) + len(m[2])
                except Exception:
                    nb = 32
                self.write_tags.note(tag_of_key(span[0]), nb)
        return messages


def _stamp(version: int, order: int) -> bytes:
    """10-byte versionstamp: 8B big-endian commit version + 2B txn order."""
    return version.to_bytes(8, "big") + order.to_bytes(2, "big")


def _is_metadata(m) -> bool:
    """Metadata mutations target the \xff system keyspace
    (the applyMetadataToCommittedTransactions condition)."""
    return _is_metadata_shared(m)
