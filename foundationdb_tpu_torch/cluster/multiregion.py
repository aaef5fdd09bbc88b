"""Multi-region skeleton: a remote DC fed by a log router, with failover.

The reference's multi-region HA (fdbserver/TagPartitionedLogSystem.actor.cpp
+ fdbserver/LogRouter.actor.cpp + documentation/sphinx/source/
ha-write-path.rst): the primary region commits as usual; LOG ROUTERS pull
the primary logs' mutation stream and feed the remote region's logs,
whose storage servers apply asynchronously — the remote trails by a
bounded version lag and can take over when the primary dies.

This skeleton keeps those moving parts and their contracts:

* `LogRouter` registers as a full-stream consumer on the PRIMARY log
  system (the same retained-stream mechanism backup/DR workers use,
  cluster/tlog.py LOG_STREAM_TAG) and pushes each version into the
  REMOTE LogSystem as an ordinary version-chained commit. Remote
  storage servers then pull the remote logs exactly like primary ones
  pull theirs — one storage implementation, both regions.
* `RemoteDC.lag()` reports the version distance primary -> remote (the
  reference's remoteDCIsHealthy / datacenterVersionDifference check,
  fdbserver/ClusterRecovery + Ratekeeper's GetHealthMetrics path).
* `RemoteDC.failover()` is the DR-promote path: recover the acked
  suffix from the primary's SATELLITE logs (if configured), stop
  routing, let remote storages drain, and return the takeover version.
  With satellites (cluster/logsystem.py: commits ack only after the
  stream is durable in the second in-region failure domain), a whole
  primary-DC death loses NOTHING — RPO=0, the reference's HA write
  path (ha-write-path.rst). Without satellites, a primary death serves
  the router watermark — a consistent prefix.

The port's own copy of foundationdb_tpu.cluster.multiregion.
"""

from __future__ import annotations

from typing import Optional

from foundationdb_tpu_torch.cluster.logsystem import LogSystem
from foundationdb_tpu_torch.cluster.storage import StorageServer
from foundationdb_tpu_torch.cluster.tlog import LOG_STREAM_TAG, TLogCommitRequest
from foundationdb_tpu_torch.runtime.flow import ActorCancelled, Scheduler
from foundationdb_tpu_torch.utils.probes import declare, code_probe

declare("multiregion.failover", "multiregion.router_caught_up",
        "multiregion.satellite_recovery")


class LogRouter:
    """Pulls the primary's full mutation stream into the remote logs.

    LogRouter.actor.cpp's role: a pull cursor on the primary log system
    (peek LOG_STREAM_TAG), a version-chained push into the remote log
    system, and pop acknowledgment so the primary can trim.
    """

    def __init__(
        self,
        sched: Scheduler,
        primary: LogSystem,
        remote: LogSystem,
        *,
        name: str = "log-router",
        key_tags,  # callable key -> remote storage tag
        n_remote_tags: int = 1,
        poll_interval: float = 0.02,
    ):
        self.sched = sched
        self.primary = primary
        self.remote = remote
        self.name = name
        self.key_tags = key_tags
        self.n_remote_tags = n_remote_tags
        self.poll_interval = poll_interval
        self.pulled_version = remote.version.get()
        self._task = None

    def start(self) -> None:
        self.primary.register_consumer(self.name)
        self._task = self.sched.spawn(self._pull(), name=self.name)

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        try:
            self.primary.unregister_consumer(self.name)
        except Exception as e:
            # primary may be dead at failover time — expected then, but
            # worth a trace line anywhere else
            from foundationdb_tpu_torch.utils.trace import SEV_WARN, TraceEvent

            TraceEvent("RemoteUnregisterFailed", severity=SEV_WARN) \
                .detail("Router", self.name).detail("Err", repr(e)).log()

    async def _pull(self) -> None:
        while True:
            try:
                entries, _v = await self.primary.peek(
                    LOG_STREAM_TAG, self.pulled_version
                )
                for v, msgs in entries:
                    if v <= self.pulled_version:
                        continue
                    await self._push_remote(v, msgs)
                    self.pulled_version = v
                    self.primary.pop(
                        LOG_STREAM_TAG, v, consumer=self.name
                    )
                if not entries:
                    await self.sched.delay(self.poll_interval)
            except ActorCancelled:
                raise
            except Exception:
                # primary unreachable/dead (possibly discovered mid-pop):
                # keep what we have and keep polling — the failover path
                # takes it from here. The router must never die silently.
                await self.sched.delay(self.poll_interval)

    async def _push_remote(self, version: int, msgs) -> None:
        """Re-tag the full stream for the remote region's storages and
        push as an ordinary version-chained remote commit."""
        tagged: dict = {t: [] for t in range(self.n_remote_tags)}
        for m in msgs:
            for t in self._tags_of(m):
                tagged[t].append(m)
        await self.remote.commit(TLogCommitRequest(
            prev_version=self.remote.version.get(),
            version=version,
            messages=tagged,
            epoch=self.remote.epoch,
        ))

    def _tags_of(self, m) -> set:
        # sim mutations: ("set", key, value) / ("clear", begin, end) / ...
        if m[0] == "clear":
            # a range clear may span any number of remote shards:
            # broadcast (the reference computes exact intersecting tags;
            # broadcast is conservative and correct)
            return set(range(self.n_remote_tags))
        return {self.key_tags(m[1])}


class RemoteDC:
    """The remote region: its own log system + async storage replicas."""

    def __init__(
        self,
        sched: Scheduler,
        primary: LogSystem,
        *,
        n_tlogs: int = 1,
        n_storage: int = 1,
        storage_boundaries: Optional[list] = None,
        window_versions: int = 5_000_000,
    ):
        self.sched = sched
        self.primary = primary
        base = primary.version.get()
        self.logs = LogSystem(sched, n_tlogs, recovery_version=base)
        self.boundaries = storage_boundaries or []
        if len(self.boundaries) != n_storage - 1:
            raise ValueError(
                f"{len(self.boundaries)} boundaries for {n_storage} remote "
                f"storages: need n_storage-1 (a key mapping past the tag "
                f"table would kill the router)"
            )

        def key_tag(key: bytes) -> int:
            t = 0
            for b in self.boundaries:
                if key >= b:
                    t += 1
            return t

        self.storages = [
            StorageServer(
                sched, self.logs, tag=t, recovery_version=base,
                window_versions=window_versions,
            )
            for t in range(n_storage)
        ]
        self.router = LogRouter(
            sched, primary, self.logs,
            key_tags=key_tag, n_remote_tags=n_storage,
        )
        self._failed_over = False

    def start(self) -> None:
        self.router.start()
        for s in self.storages:
            s.start()

    def stop(self) -> None:
        self.router.stop()
        for s in self.storages:
            s.stop()

    def lag(self) -> int:
        """Primary->remote version distance (datacenterVersionDifference)."""
        return max(0, self.primary.version.get() - self.logs.version.get())

    async def wait_caught_up(self, *, to_version: int = None) -> None:
        """Block until the router has pulled (and remote logs hold)
        everything the primary acked up to `to_version` (default: the
        primary's current version)."""
        target = (
            self.primary.version.get() if to_version is None else to_version
        )
        await self.logs.version.when_at_least(target)
        code_probe(True, "multiregion.router_caught_up")

    async def failover(self) -> int:
        """Promote the remote region: recover any acked suffix from the
        primary's SATELLITE logs, stop routing, drain storages to the
        remote log version, lock the remote logs for a new epoch.

        Returns the takeover version. With satellites configured
        (ClusterConfig.n_satellite_logs > 0) this is RPO=0 even after a
        whole-primary-DC death: commits acked only after satellite
        durability, and the satellite stream replays here
        (TagPartitionedLogSystem + ha-write-path.rst). Without
        satellites, a primary death serves the router watermark — a
        consistent prefix (async-replication RPO > 0)."""
        code_probe(True, "multiregion.failover")
        # BEFORE stopping the router: stopping unregisters its consumer
        # from the primary system (satellites included), which releases
        # the retained stream we are about to replay.
        sat = next(
            (
                t
                for t, alive in zip(
                    self.primary.satellites, self.primary.satellite_live
                )
                if alive
            ),
            None,
        )
        if sat is not None:
            wm = self.logs.version.get()
            if sat.version.get() > wm:
                # the satellite holds acked versions the router never
                # pulled before the primary died: replay them through
                # the same re-tagging push (duplicates the router also
                # managed to push are version-deduped by the remote log)
                entries, _v = await sat.peek(LOG_STREAM_TAG, wm)
                for v, msgs in entries:
                    if v > self.logs.version.get():
                        await self.router._push_remote(v, msgs)
                code_probe(True, "multiregion.satellite_recovery")
        self.router.stop()
        takeover = self.logs.version.get()
        # drain: every remote storage applies through the takeover version
        for s in self.storages:
            await s.version.when_at_least(takeover)
        self.logs.lock(self.logs.epoch + 1)
        self._failed_over = True
        return takeover

    async def read_at(self, key: bytes, version: int):
        """Read from the remote replicas (post-failover serving path)."""
        tag = self.router.key_tags(key)
        return await self.storages[tag].get_value(key, version)
