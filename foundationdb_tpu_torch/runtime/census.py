"""Live resource census of a process (the port's own copy of
foundationdb_tpu.runtime.census).

Four cheap process-wide gauges:

* **fds**: live file descriptors, read off /proc/self/fd;
* **connections / servers**: live RpcConnections and RpcServers, bumped
  at activation and dropped at release by the transport itself
  (wire/transport.py);
* **tasks**: the Scheduler's live-task count (`run_loop_stats()
  ["tasks_live"]`: incremented at Task construction, retired exactly
  once at the terminal done-set), when `snapshot` is given the
  Scheduler. A role process's status block puts its asyncio task count
  there instead.

The gate is a pre/post compare: snapshot before work, drain, snapshot
after; growth in any gauge is a leak, named (`growth`,
`check_drained`). Census reads never land in traces: gauge values
depend on wall-clock scheduling of real I/O.
"""

from __future__ import annotations

import os
from typing import Optional


class Gauge:
    """One process-wide up/down counter. Deliberately not thread-safe:
    every mutator runs on the owning process's event loop."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self) -> None:
        self.value += 1

    def dec(self) -> None:
        self.value -= 1


#: live activated RpcConnections in this process (client side)
CONNECTIONS = Gauge("connections")
#: live started RpcServers in this process
SERVERS = Gauge("servers")


def live_fds() -> int:
    """Count of open file descriptors, from /proc/self/fd. Returns -1
    where /proc is unavailable (non-Linux) — callers treat a negative
    census as "not measurable", never as a leak."""
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1


def snapshot(sched=None) -> dict:
    """One census reading: {fds, connections, servers, tasks}. Pass the
    owning Scheduler to include its live-task count (0 without one)."""
    tasks = 0
    if sched is not None:
        tasks = int(sched.run_loop_stats().get("tasks_live", 0))
    return {
        "fds": live_fds(),
        "connections": CONNECTIONS.value,
        "servers": SERVERS.value,
        "tasks": tasks,
    }


def growth(pre: dict, post: dict, *,
           ignore: Optional[set] = None) -> list[str]:
    """Gauges that grew between two snapshots: the leak report. A
    metric absent from either snapshot, or negative (unmeasurable) in
    either, is skipped; equality and shrinkage are clean."""
    leaks: list[str] = []
    for key in sorted(pre.keys() & post.keys()):
        if ignore and key in ignore:
            continue
        a, b = pre[key], post[key]
        if a < 0 or b < 0:
            continue
        if b > a:
            leaks.append(f"{key} grew {a} -> {b}")
    return leaks


def check_drained(pre: dict, post: dict, *, label: str = "census",
                  ignore: Optional[set] = None) -> None:
    """Raise RuntimeError naming every gauge that failed to return to
    its pre-run baseline — the census gate the drills arm."""
    leaks = growth(pre, post, ignore=ignore)
    if leaks:
        raise RuntimeError(
            f"{label}: resource census did not return to baseline "
            f"after drain: {'; '.join(leaks)}"
        )
