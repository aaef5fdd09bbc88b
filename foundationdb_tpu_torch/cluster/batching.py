"""Adaptive batch sizing: the dynamic commitBatcher feedback controller
(the port's own copy of foundationdb_tpu.cluster.batching).

Behavioral mirror of the reference's CommitProxy batching policy
(fdbserver/CommitProxyServer.actor.cpp:361 `commitBatcher` +
ServerKnobs COMMIT_TRANSACTION_BATCH_*): batches are bounded by a
count target, a bytes target and an accumulation interval, and all
three MOVE with load instead of being fixed knobs:

* the **interval tracks the measured downstream stage latency**
  (resolve + tlog-push seconds per batch) at the reference's
  COMMIT_TRANSACTION_BATCH_INTERVAL_LATENCY_FRACTION, clamped by the
  MIN/MAX knobs: a slow stage (e.g. a kernel resolver's fixed
  per-dispatch cost) earns a longer accumulation window — bigger
  batches amortize the dispatch — while a fast pipeline shrinks the
  window back for low-latency dispatch. Before any latency is
  observed, full batches shrink the window and underfull interval-
  expiry dispatches relax it (the idle/cold-start heuristic).
* the **count/bytes targets grow on evidence** (a batch that filled to
  target and still finished under the latency budget shows headroom),
  capped by the *_MAX knobs.

The controller is deterministic (pure arithmetic over observed
latencies — virtual time under simulation, wall clock on the wire) and
used here by the multiprocess wire ProxyPipeline.
"""

from __future__ import annotations


class AdaptiveBatchSizer:
    """Feedback-controlled (interval, count target, bytes target)."""

    def __init__(
        self,
        *,
        interval: float,
        min_interval: float,
        max_interval: float,
        target_count: int,
        max_count: int,
        target_bytes: int = 1 << 20,
        max_bytes: int = 8 << 20,
        latency_budget: float = 0.1,
        alpha: float = 0.1,
        latency_fraction: float = 0.1,
    ):
        self.interval = min(max(interval, min_interval), max_interval)
        self.min_interval = min_interval
        self.max_interval = max_interval
        self.target_count = max(1, min(target_count, max_count))
        self.max_count = max_count
        self.target_bytes = min(target_bytes, max_bytes)
        self.max_bytes = max_bytes
        self.latency_budget = latency_budget
        self.alpha = alpha
        #: the reference's COMMIT_TRANSACTION_BATCH_INTERVAL_LATENCY_
        #: FRACTION: once stage latency is observed, the accumulation
        #: interval TRACKS fraction * smoothed latency (clamped by the
        #: MIN/MAX knobs) — a slow downstream stage (e.g. a fixed
        #: per-dispatch kernel cost) earns BIGGER batches, never a
        #: frantic cadence of tiny ones
        self.latency_fraction = latency_fraction
        #: smoothed resolve+log seconds per batch (None until observed)
        self.smoothed_stage_latency: float | None = None

    # -- dispatch-side feedback (called by the batcher) -------------------

    def batch_full(self) -> None:
        """A batch hit its count/bytes target before the interval
        expired: traffic outruns the dispatch cadence — shrink the
        accumulation window (the reference's interval *= 1-SMOOTHER).
        Once stage latency is flowing, the latency fraction owns the
        interval (observe_stage_latency) and this is a no-op."""
        if self.smoothed_stage_latency is None:
            self.interval = max(
                self.min_interval, self.interval * (1.0 - self.alpha)
            )

    def batch_underfull(self, n_txns: int) -> None:
        """A batch went out on interval expiry well under target: relax
        the window back toward the MAX knob so idle periods don't keep
        paying the loaded cadence. No-op once the latency signal owns
        the interval (see batch_full)."""
        if (
            self.smoothed_stage_latency is None
            and n_txns * 2 <= self.target_count
        ):
            self.interval = min(
                self.max_interval, self.interval * (1.0 + self.alpha / 2)
            )

    # -- completion-side feedback (called when a batch finishes) ----------

    def observe_stage_latency(self, seconds: float, *, full: bool) -> None:
        """Feed back one batch's measured resolve+log stage seconds.

        The interval follows the reference's latency-fraction rule:
        interval = clamp(LATENCY_FRACTION * smoothed stage seconds).
        High downstream latency means each dispatch carries a fixed
        cost worth amortizing — the window grows (toward the MAX knob)
        so batches get bigger; a fast pipeline shrinks the window back
        toward the MIN knob for low-latency dispatch.

        Count/bytes targets only GROW (toward the *_MAX knobs), and
        only on evidence: a batch that filled to target AND finished
        under budget shows headroom at the current size (`full` = the
        batch had reached its count/bytes target — an underfull batch
        finishing fast says nothing about headroom)."""
        s = self.smoothed_stage_latency
        self.smoothed_stage_latency = (
            seconds if s is None else s * (1.0 - self.alpha) + seconds * self.alpha
        )
        lat = self.smoothed_stage_latency
        self.interval = min(
            self.max_interval,
            max(self.min_interval, self.latency_fraction * lat),
        )
        if full and lat < self.latency_budget:
            self.target_count = min(
                self.max_count, max(self.target_count + 1,
                                    int(self.target_count * 1.1))
            )
            self.target_bytes = min(
                self.max_bytes, int(self.target_bytes * 1.1)
            )

    def as_dict(self) -> dict:
        return {
            "interval": self.interval,
            "target_count": self.target_count,
            "target_bytes": self.target_bytes,
            "smoothed_stage_latency": self.smoothed_stage_latency,
        }


def commit_txn_bytes(txn) -> int:
    """Cheap wire-size estimate of one CommitTransaction: conflict-range
    keys + mutation params + fixed per-field overhead. Used for the
    bytes target only — never exact serialization length."""
    n = 64
    for b, e in txn.read_conflict_ranges:
        n += 8 + len(b) + len(e)
    for b, e in txn.write_conflict_ranges:
        n += 8 + len(b) + len(e)
    for m in txn.mutations:
        if isinstance(m, tuple):
            for part in m[1:]:
                n += 5 + (len(part) if isinstance(part, bytes) else 8)
        else:
            n += 9 + len(m.param1) + len(m.param2)
    return n
