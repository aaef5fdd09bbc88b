"""GrvProxy: batched read-version service.

Behavioral mirror of `fdbserver/GrvProxyServer.actor.cpp`:

* Requests queue and are answered in batches (`transactionStarter` :824)
  on a short interval — one live-committed-version fetch serves the whole
  batch (the reference's GRV batching amortizes the master round-trip and
  the TLog epoch-liveness quorum).
* The reply version is the Sequencer's live committed version
  (`getLiveCommittedVersion` :617): every commit at or below it is
  durable, so reads at this version are causally consistent.
* Admission control (Ratekeeper budget, :364) hooks in as a configurable
  per-batch budget; the v0 Ratekeeper grants infinity.

The port's own copy of foundationdb_tpu.cluster.grv_proxy.
"""

from __future__ import annotations

from foundationdb_tpu_torch.runtime.flow import Promise, PromiseStream, Scheduler
from foundationdb_tpu_torch.utils import commit_debug as _cd
from foundationdb_tpu_torch.utils import trace as _trace
from foundationdb_tpu_torch.utils.metrics import (
    GRV_LATENCY_BANDS,
    CounterCollection,
    LatencyBands,
    LatencySample,
)
from foundationdb_tpu_torch.utils.probes import declare

declare("ratekeeper.tag_throttled", "grv.throttled")


class GrvProxyFailedError(Exception):
    """Retryable: this GRV proxy generation died (recovery replaced it);
    the client's retry loop re-resolves the current generation."""


class GrvThrottledError(Exception):
    """Retryable: the GRV queue is over its bound under admission
    control — the front door SHEDS the request instead of queueing it
    unboundedly (the reference's GRV proxy drops requests past
    START_TRANSACTION_MAX_QUEUE_SIZE the same way). Clients back off
    and retry; offered load past capacity degrades into delayed admits
    plus retryable sheds, never into an unbounded promise queue."""


class GrvProxy:
    def __init__(
        self,
        sched: Scheduler,
        sequencer,
        *,
        ratekeeper=None,
        batch_interval: float = 0.001,
        max_queue: int = None,
    ):
        self.sched = sched
        self.sequencer = sequencer
        self.ratekeeper = ratekeeper
        self.batch_interval = batch_interval
        from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS as _SK

        #: bounded GRV queue: requests past this depth are SHED with the
        #: retryable GrvThrottledError instead of queued (overload must
        #: degrade gracefully, not accumulate an unbounded promise list)
        self.max_queue = (
            max_queue if max_queue is not None
            else _SK.GRV_PROXY_MAX_QUEUE
        )
        # fail-safe state: when the Ratekeeper's budget goes STALE (the
        # loop died or stopped updating), the effective budget decays
        # toward the Ratekeeper's conservative floor instead of
        # freezing at the last (possibly full-speed) value
        self._failsafe_budget: float | None = None
        self._effective_tps: float = float("inf")
        self._budget_stale = False
        # Adaptive GRV batching (GrvProxyServer's START_TRANSACTION_
        # BATCH_* discipline): the accumulation interval shrinks while
        # requests keep arriving faster than batches go out and relaxes
        # when the queue drains underfull — same controller as the
        # commit proxy (cluster/batching.py), knob-bounded.
        from foundationdb_tpu_torch.cluster.batching import AdaptiveBatchSizer
        from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS as _K

        # max_interval capped at the ctor interval: the controller only
        # shrinks the window under load; idle cadence is unchanged
        self.batch_sizer = AdaptiveBatchSizer(
            interval=batch_interval,
            min_interval=min(
                batch_interval, _K.START_TRANSACTION_BATCH_INTERVAL_MIN
            ),
            max_interval=min(
                batch_interval, _K.START_TRANSACTION_BATCH_INTERVAL_MAX
            ),
            target_count=_K.START_TRANSACTION_BATCH_COUNT_MAX,
            max_count=_K.START_TRANSACTION_BATCH_COUNT_MAX,
            alpha=_K.START_TRANSACTION_BATCH_INTERVAL_SMOOTHER_ALPHA,
        )
        self.requests = PromiseStream()
        self.counters = CounterCollection(
            "GrvProxyMetrics",
            ["txnRequestIn", "txnRequestOut", "grvBatches", "grvShed"],
        )
        # GRV latency distribution + reference-style latency bands
        # (GrvProxyServer.actor.cpp grvLatencyBands), in virtual time
        self.grv_latency = LatencySample("grvLatency")
        self.latency_bands = LatencyBands(
            "GRVLatencyMetrics", GRV_LATENCY_BANDS
        )
        self._pending: list[Promise] = []
        self._task = None
        self._armed = None  # the starter's in-flight stream waiter
        self._tag_tokens: dict[str, float] = {}  # per-tag throttle buckets

    def start(self) -> None:
        self._task = self.sched.spawn(self._starter(), name="grv-starter")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        # Fail everything queued or batched: a dangling read-version
        # promise would strand its client forever across a recovery.
        for p in self._pending:
            if not p.is_set:
                p.send_error(GrvProxyFailedError())
        self._pending = []
        # A request delivered into the starter's armed stream waiter but
        # not yet consumed (the cancel landed between send() and the
        # task's resumption) is invisible to both _pending and the
        # queue — recover it from the tracked waiter.
        if self._armed is not None:
            if self._armed.is_ready and not self._armed.is_error:
                p = self._armed.get()
                if not p.is_set:
                    p.send_error(GrvProxyFailedError())
            self._armed = None
        queue = self.requests.stream._queue
        while queue:
            p = queue.pop(0)
            if not p.is_set:
                p.send_error(GrvProxyFailedError())

    def saturation(self) -> dict:
        """The GRV proxy's qos sensor block: read-version queue depth
        (requests admitted but not yet answered — the front-door queue
        the Ratekeeper budget throttles), the live batch-sizer targets,
        and the tags currently metered by a throttle bucket."""
        tps = self._effective_tps
        return {
            "queued_requests": (
                len(self._pending) + len(self.requests.stream._queue)
            ),
            "max_queue": self.max_queue,
            "transactions_per_second_limit": (
                tps if tps != float("inf") else None
            ),
            "budget_stale": self._budget_stale,
            "sheds": self.counters.get("grvShed"),
            "batch_sizer": self.batch_sizer.as_dict(),
            "throttled_tags": sorted(
                t for t, tok in self._tag_tokens.items()
                if tok != float("inf")
            ),
        }

    def get_read_version(self, tag: str = None) -> Promise:
        """tag: optional transaction tag; tagged requests are metered
        against the Ratekeeper's per-tag quota (GlobalTagThrottler's
        enforcement point) on top of the global budget."""
        p = Promise()
        # normalize falsy tags (e.g. "") to None: the admit loop and the
        # refill set must agree on what counts as "tagged", or an
        # empty-string tag reaches the bucket dict without a bucket
        p.tag = tag or None
        p.debug_id = None  # the client sets it before yielding (tracing)
        p.grv_start = self.sched.now()
        self.counters.add("txnRequestIn")
        if self._task is None:
            # Stopped proxy (the recovery window between the old
            # generation stopping and the new one starting): a request
            # queued into the dead stream would strand its client
            # forever — fail fast with the retryable error instead.
            p.send_error(GrvProxyFailedError())
            return p
        if (
            self.max_queue is not None
            and len(self._pending) + len(self.requests.stream._queue)
            >= self.max_queue
        ):
            # bounded front-door queue: shed with the retryable
            # throttle error — delayed-or-shed at GRV is the ONLY
            # admission-control enforcement point (decision parity:
            # an admitted transaction resolves identically to the
            # unthrottled path)
            from foundationdb_tpu_torch.utils.probes import code_probe

            self.counters.add("grvShed")
            code_probe(True, "grv.throttled")
            p.send_error(GrvThrottledError())
            return p
        self.requests.send(p)
        return p

    async def _starter(self) -> None:
        # Token bucket fed by the Ratekeeper budget (transactionStarter's
        # "transactionRate" accounting, GrvProxyServer.actor.cpp:824).
        # Queue accesses go through self._pending directly: stop()
        # REASSIGNS the list after failing the queued promises, and a
        # pre-await alias here would keep feeding the dead list if a
        # step ever interleaved with stop() (flow.stale-read-across-wait
        # caught the alias; cancellation only masks it today).
        tokens = 0.0
        last = self.sched.now()
        while True:
            if not self._pending:
                self._armed = self.requests.stream.next()
                # await FIRST, then touch the queue: in
                # `self._pending.append(await ...)` the bound method
                # holds the pre-await list object, which is exactly the
                # stale alias this function no longer keeps (stop()
                # reassigns the list while we are suspended here)
                p = await self._armed
                self._pending.append(p)
                self._armed = None
            await self.sched.delay(self.batch_sizer.interval)
            while True:
                ok, p = self.requests.stream.try_next()
                if not ok:
                    break
                self._pending.append(p)

            now = self.sched.now()
            dt = now - last
            last = now
            if self.ratekeeper is not None:
                tps = self.ratekeeper.get_rate_info()
                # fail-safe: a dead/flapping Ratekeeper (control loop
                # not updating) must not be trusted at full speed — the
                # effective budget decays toward the conservative
                # failsafe floor until fresh budgets flow again
                age_fn = getattr(self.ratekeeper, "budget_age", None)
                stale_after = 4.0 * getattr(
                    self.ratekeeper, "interval", 0.25
                )
                stale = (
                    age_fn is not None and age_fn(now) > stale_after
                )
                if stale:
                    import math as _math

                    from foundationdb_tpu_torch.cluster.ratekeeper import (
                        FAILSAFE_TAU,
                    )
                    from foundationdb_tpu_torch.utils.probes import code_probe

                    floor = getattr(
                        self.ratekeeper, "failsafe_tps", 10.0
                    )
                    tau = getattr(
                        self.ratekeeper, "failsafe_tau", FAILSAFE_TAU
                    )
                    if self._failsafe_budget is None:
                        self._failsafe_budget = max(tps, floor)
                        code_probe(True, "ratekeeper.failsafe")
                    self._failsafe_budget = max(
                        floor,
                        self._failsafe_budget
                        * _math.exp(-max(dt, 0.0) / tau),
                    )
                    tps = min(tps, self._failsafe_budget)
                else:
                    self._failsafe_budget = None
                self._budget_stale = stale
                self._effective_tps = tps
                # token bucket with a burst cap: at most ~100ms of
                # budget (never less than one token) accumulates idle
                tokens = min(
                    tokens + tps * dt, max(tps * 0.1, 1.0)
                )
            else:
                self._budget_stale = False
                self._effective_tps = float("inf")
                tokens = float(len(self._pending))
            n = min(len(self._pending), int(tokens))
            if n == 0:
                continue
            tokens -= n
            batch = self._pending[:n]
            del self._pending[:n]
            # per-tag metering: requests over their tag's quota are
            # deferred back to the queue (the tag throttle delays, never
            # drops — GlobalTagThrottler semantics)
            if self.ratekeeper is not None and any(
                getattr(p, "tag", None) for p in batch
            ):
                from foundationdb_tpu_torch.utils.probes import code_probe

                # refill each tag's bucket ONCE per interval (not per
                # request — that would scale the quota by queue depth)
                tags = {p.tag for p in batch if getattr(p, "tag", None)}
                for tag in tags:
                    quota = self.ratekeeper.get_tag_quota(tag)
                    if quota == float("inf"):
                        self._tag_tokens[tag] = float("inf")
                        continue
                    self._tag_tokens[tag] = min(
                        self._tag_tokens.get(tag, 0.0)
                        + quota * max(dt, 1e-9),
                        max(quota * 0.5, 1.0),
                    )
                admit, defer = [], []
                for p in batch:
                    tag = getattr(p, "tag", None)
                    if tag is None or self._tag_tokens[tag] >= 1.0:
                        if tag is not None:
                            self._tag_tokens[tag] -= 1.0
                            # busyness signal for the auto tag throttler
                            self.ratekeeper.note_tag_admission(tag)
                        admit.append(p)
                    else:
                        code_probe(True, "ratekeeper.tag_throttled")
                        defer.append(p)
                # deferred requests were never started: refund their
                # global tokens so a throttled tag flood cannot starve
                # untagged traffic
                tokens += len(defer)
                self._pending.extend(defer)
                batch = admit
                if not batch:
                    continue
            version = self.sequencer.get_live_committed_version()
            self.counters.add("grvBatches")
            ctx = next(
                (p.span_ctx for p in batch
                 if getattr(p, "span_ctx", None) is not None),
                None,
            )
            if ctx is not None:
                # one span per GRV batch, parented on the first traced
                # request's client span (the commitBatch discipline)
                from foundationdb_tpu_torch.utils.spans import Span

                with Span(
                    "GrvProxy.transactionStarter", parent=ctx,
                    clock=self.sched.now,
                ) as s:
                    s.attribute("Txns", len(batch))
            for p in batch:
                self.counters.add("txnRequestOut")
                dt = now - getattr(p, "grv_start", now)
                self.grv_latency.sample(dt)
                self.latency_bands.add(dt)
                if getattr(p, "debug_id", None) is not None:
                    _trace.g_trace_batch.add_event(
                        "TransactionDebug", p.debug_id, _cd.GRV_REPLY
                    )
                p.send(version)
            # interval feedback: requests still waiting after a dispatch
            # mean the window is too long (shrink toward the MIN knob);
            # a drained queue relaxes it back to the configured cadence
            if self._pending or self.requests.stream._queue:
                self.batch_sizer.batch_full()
            else:
                self.batch_sizer.batch_underfull(len(batch))
