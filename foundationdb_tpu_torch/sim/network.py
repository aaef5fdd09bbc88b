"""Simulated network: seeded latency, clogging, partitions between roles.

The Sim2 analog (fdbrpc/sim2.actor.cppp): role-to-role calls go through a
SimNetwork that injects deterministic, seeded delivery delays, can "clog"
pairs of processes (RandomClogging workload semantics:
fdbserver/workloads/RandomClogging.actor.cpp), and can partition them
outright. Because the scheduler's event order is fully determined by
(time, priority, seq), two runs with the same seed execute identically —
the determinism-is-the-race-detector property (SURVEY.md §5.2).

Roles stay plain objects; `wrap(proc, obj)` returns a proxy whose async
methods pay a delivery delay on the way in (request hop) and on the way
out (reply hop), exactly where the reference's FlowTransport would sit.

The port's own copy of foundationdb_tpu.sim.network.
"""

from __future__ import annotations

import numpy as np

from foundationdb_tpu_torch.runtime.flow import Scheduler


class PartitionedError(Exception):
    """Delivery failed: the two processes are partitioned."""


class SimNetwork:
    def __init__(self, sched: Scheduler, seed: int = 0, *,
                 base_latency: float = 0.0005, jitter: float = 0.002):
        self.sched = sched
        self.rng = np.random.default_rng(seed)
        self.base_latency = base_latency
        self.jitter = jitter
        # (src, dst) -> clog end time (virtual); symmetric entries stored
        # one-way so asymmetric clogs are possible, like Sim2's.
        self._clogged: dict[tuple[str, str], float] = {}
        self._partitioned: set[frozenset] = set()

    # -- fault injection ---------------------------------------------------

    def clog_pair(self, a: str, b: str, seconds: float) -> None:
        until = self.sched.now() + seconds
        for pair in ((a, b), (b, a)):
            self._clogged[pair] = max(self._clogged.get(pair, 0.0), until)

    def partition(self, a: str, b: str) -> None:
        self._partitioned.add(frozenset((a, b)))

    def heal(self, a: str, b: str) -> None:
        self._partitioned.discard(frozenset((a, b)))

    # -- delivery ----------------------------------------------------------

    async def deliver(self, src: str, dst: str) -> None:
        """One message hop src -> dst: latency + clog wait, or failure."""
        if src == dst:
            return
        if frozenset((src, dst)) in self._partitioned:
            raise PartitionedError(f"{src} -/-> {dst}")
        lat = self.base_latency + float(self.rng.random()) * self.jitter
        clog_until = self._clogged.get((src, dst), 0.0)
        wake = max(self.sched.now() + lat, clog_until + lat)
        await self.sched.delay(wake - self.sched.now())
        if frozenset((src, dst)) in self._partitioned:
            raise PartitionedError(f"{src} -/-> {dst}")

    def wrap(self, src: str, dst: str, obj, methods: list[str]):
        """Proxy `obj` so the named async methods pay request+reply hops."""
        net = self

        class _Proxy:
            def __getattr__(self, name):
                return getattr(obj, name)

        proxy = _Proxy()
        for m in methods:
            inner = getattr(obj, m)

            def make(inner):
                async def call(*args, **kwargs):
                    await net.deliver(src, dst)
                    result = await inner(*args, **kwargs)
                    await net.deliver(dst, src)
                    return result

                return call

            setattr(proxy, m, make(inner))
        return proxy
