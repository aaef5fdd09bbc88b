"""ResolutionBalancer: dynamic key-range rebalancing across resolvers.

Behavioral mirror of `fdbserver/ResolutionBalancer.actor.cpp:30-188`:
the sequencer-side control loop polls each resolver's sampled load
(ResolutionMetricsRequest — our Resolver.metrics()), and when the
busiest resolver carries more than its fair share it asks it for a
split key (ResolutionSplitRequest — Resolver.split_point()) and moves
the boundary toward the less-loaded neighbor. Changes apply atomically
to the shared KeyPartition that proxies consult when splitting conflict
ranges (the reference piggybacks resolverChanges on
GetCommitVersionReply; here proxies read the live partition object).

The port's own copy of foundationdb_tpu.cluster.balancer.
"""

from __future__ import annotations

from foundationdb_tpu_torch.runtime.flow import ActorCancelled, Scheduler
from foundationdb_tpu_torch.utils.metrics import CounterCollection

MIN_BALANCE_TIME = 0.2
IMBALANCE_RATIO = 1.5  # rebalance when max load > ratio * average


class ResolutionBalancer:
    def __init__(
        self,
        sched: Scheduler,
        resolvers: list,
        key_resolvers,   # cluster's KeyPartition (mutated in place)
        commit_proxies: list = (),
        *,
        interval: float = 0.5,
    ):
        self.sched = sched
        self.resolvers = resolvers
        self.key_resolvers = key_resolvers
        self.commit_proxies = list(commit_proxies)
        self.interval = interval
        self.counters = CounterCollection("BalancerMetrics", ["loops", "moves"])
        self._last_move = -float("inf")
        self._task = None

    def start(self) -> None:
        if len(self.resolvers) > 1:
            self._task = self.sched.spawn(self._loop(), name="resolution-balancer")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()

    def rebalance_once(self) -> bool:
        """One balancing decision (resolutionBalancing_impl :115): shed
        load from the busiest resolver to its LESS-loaded adjacent
        neighbor, rate-limited by MIN_BALANCE_TIME."""
        now = self.sched.now()
        if now - self._last_move < MIN_BALANCE_TIME:
            return False
        loads = [r.metrics() for r in self.resolvers]
        total = sum(loads)
        if total == 0:
            return False
        avg = total / len(loads)
        busiest = max(range(len(loads)), key=lambda i: loads[i])
        if loads[busiest] <= IMBALANCE_RATIO * avg:
            return False
        b = self.key_resolvers.boundaries
        lo = b[busiest - 1] if busiest > 0 else b""
        hi = b[busiest] if busiest < len(b) else b"\xff" * 64
        # candidate recipients: adjacent shards, lightest (and lighter than
        # average) first — never push load onto another hot shard
        neighbors = [
            i for i in (busiest - 1, busiest + 1)
            if 0 <= i < len(loads) and loads[i] < avg
        ]
        for nb in sorted(neighbors, key=lambda i: loads[i]):
            split = self.resolvers[busiest].split_point(lo, hi, 0.5)
            if not (lo < split < hi):
                continue
            if nb == busiest + 1:
                b[busiest] = split          # give the upper part rightward
                self._moved(split, hi)
            else:
                b[busiest - 1] = split      # give the lower part leftward
                self._moved(lo, split)
            self._last_move = now
            return True
        return False

    def _moved(self, begin: bytes, end: bytes) -> None:
        """Queue the conservative write over the moved span on every proxy
        (the receiving resolver has no history for it yet)."""
        self.counters.add("moves")
        for p in self.commit_proxies:
            p.conservative_writes.append((begin, end))

    async def _loop(self) -> None:
        try:
            while True:
                await self.sched.delay(self.interval)
                self.counters.add("loops")
                self.rebalance_once()
        except ActorCancelled:
            raise
