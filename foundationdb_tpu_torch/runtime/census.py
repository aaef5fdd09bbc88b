"""Live resource census of a process (the port's own copy of `Gauge`,
`CONNECTIONS`, `SERVERS`, `live_fds` and `snapshot` from
foundationdb_tpu.runtime.census).

Three cheap process-wide gauges:

* **fds**: live file descriptors, read off /proc/self/fd;
* **connections / servers**: live RpcConnections and RpcServers, bumped
  at activation and dropped at release by the transport itself
  (wire/transport.py).

The JAX package's census also counts its Scheduler's live tasks
(`run_loop_stats()["tasks_live"]`); the port's runtime/flow.py keeps no
such count, so the port's snapshot has no "tasks" gauge. A role
process's status block adds its asyncio task count beside it.
"""

from __future__ import annotations

import os


class Gauge:
    """One process-wide up/down counter. Not thread-safe: every mutator
    runs on the owning process's event loop."""

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
    """Count of open file descriptors, from /proc/self/fd; -1 where
    /proc is unavailable (read as "not measurable", never as a leak)."""
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1


def snapshot() -> dict:
    """One census reading: {fds, connections, servers}."""
    return {
        "fds": live_fds(),
        "connections": CONNECTIONS.value,
        "servers": SERVERS.value,
    }
