"""Ping-driven address-level failure monitoring, shared cluster-wide.

Behavioral mirror of fdbrpc/FailureMonitor.actor.cpp + the cluster
controller's failureDetectionServer: every registered endpoint is pinged
on an interval; an endpoint that has not answered for `failure_delay`
(virtual) seconds is marked FAILED in a view every consumer shares
(clients skip failed replicas, the ratekeeper drops them from its lag
set, data distribution repairs their teams); a ping answered after a
failure marks it live again.

Two detection paths, as in the reference:

* the PING LOOP (this module) — catches silent deaths and network
  partitions (pings ride the SimNetwork when the cluster runs under
  simulation, so a partitioned-but-alive process is correctly seen as
  failed from the controller's vantage);
* CLIENT REPORTS (`report_failed`) — a request that throws
  ProcessFailedError marks the endpoint failed immediately, the
  IFailureMonitor::endpointNotFound fast path that keeps client
  failover latency at one round trip instead of one detection window.

The port's own copy of foundationdb_tpu.cluster.failure_monitor.
"""

from __future__ import annotations

from typing import Callable

from foundationdb_tpu_torch.runtime.flow import ActorCancelled, Scheduler
from foundationdb_tpu_torch.utils.probes import declare, code_probe

declare("failmon.detected_by_ping", "failmon.recovered")


class ProcessFailedError(Exception):
    """A request reached a dead process (connection refused / reset).

    Clients catch this, report the endpoint to the failure monitor, and
    fail over to another replica — the loadBalance error path."""


class FailureMonitor:
    def __init__(
        self,
        sched: Scheduler,
        *,
        ping_interval: float = 0.05,
        failure_delay: float = 0.15,
    ):
        self.sched = sched
        self.ping_interval = ping_interval
        self.failure_delay = failure_delay
        # addr -> async ping callable (returns truthy when alive; raising
        # or returning falsy counts as a miss)
        self._pings: dict[str, Callable] = {}
        self._last_ok: dict[str, float] = {}
        self._failed: dict[str, bool] = {}
        self._reported_at: dict[str, float] = {}
        # addr -> callbacks fired on (addr, failed) state transitions
        self._on_change: list[Callable] = []
        self._task = None

    # -- registry ---------------------------------------------------------

    def register(self, addr: str, ping: Callable) -> None:
        self._pings[addr] = ping
        self._last_ok[addr] = self.sched.now()
        self._failed.setdefault(addr, False)

    def on_change(self, cb: Callable) -> None:
        self._on_change.append(cb)

    # -- the shared view --------------------------------------------------

    def is_failed(self, addr: str) -> bool:
        return self._failed.get(addr, False)

    def report_failed(self, addr: str) -> None:
        """Client fast path: a request just failed against this address."""
        self._set(addr, True)
        # an explicit report opens a COOLDOWN: the ping loop may not
        # mark the address live again until failure_delay has passed
        # since the report, so a flapping process (answers pings, errors
        # on requests) cannot oscillate back into the read path every
        # ping interval
        self._last_ok[addr] = -1e18
        self._reported_at[addr] = self.sched.now()

    def report_alive(self, addr: str) -> None:
        """A replacement process came up at this address (reboot)."""
        self._last_ok[addr] = self.sched.now()
        self._reported_at.pop(addr, None)
        self._set(addr, False)

    def _set(self, addr: str, failed: bool) -> None:
        if self._failed.get(addr) == failed:
            return
        self._failed[addr] = failed
        for cb in self._on_change:
            cb(addr, failed)

    # -- the ping loop ----------------------------------------------------

    def start(self) -> None:
        if self._task is None:
            self._task = self.sched.spawn(self._loop(), name="failmon")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        try:
            while True:
                await self.sched.delay(self.ping_interval)
                now = self.sched.now()
                for addr, ping in list(self._pings.items()):
                    ok = False
                    try:
                        ok = bool(await ping())
                    except ActorCancelled:
                        raise
                    except Exception:
                        ok = False  # partitioned / dead / erroring
                    if ok:
                        self._last_ok[addr] = now
                        in_cooldown = (
                            now - self._reported_at.get(addr, -1e18)
                            < self.failure_delay
                        )
                        if self._failed.get(addr) and not in_cooldown:
                            code_probe(True, "failmon.recovered")
                            self._set(addr, False)
                    elif (
                        not self._failed.get(addr)
                        and now - self._last_ok[addr] >= self.failure_delay
                    ):
                        code_probe(True, "failmon.detected_by_ping")
                        self._set(addr, True)
        except ActorCancelled:
            raise
