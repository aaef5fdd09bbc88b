"""LogSystem: replicated transaction logs.

Behavioral mirror of the reference's TagPartitionedLogSystem
(fdbserver/TagPartitionedLogSystem.actor.cpp) at its core contract: a
commit is durable only when EVERY (live) log replica has it (the push
quorum is all-of-policy in the reference too — lagging/dead logs force
recovery, they never silently reduce durability); peeks are served by
any live replica (they hold identical streams); pops forward to all; the
epoch lock applies to the whole generation.

The LogSystem exposes the same surface as a single TLog (commit / peek /
pop / version / lock / consumer registration), so storage servers,
backup workers, and commit proxies use it unchanged.

The port's own copy of foundationdb_tpu.cluster.logsystem.
"""

from __future__ import annotations

from foundationdb_tpu_torch.cluster.tlog import TLog, TLogCommitRequest
from foundationdb_tpu_torch.runtime.flow import Notified, Scheduler, all_of


class AllLogsDeadError(Exception):
    """No live log replica remains — the cluster cannot commit."""


class LogSystem:
    def __init__(self, sched: Scheduler, n_logs: int = 1, *,
                 recovery_version: int = 0, durable: bool = True,
                 n_satellites: int = 0):
        from foundationdb_tpu_torch.sim.diskqueue import SimDiskQueue

        self.sched = sched
        # Every sim replica writes through a SimDiskQueue so simulation
        # seeds exercise the DiskQueue recovery-scan path (the
        # one-abstraction-two-backends discipline; the multiprocess
        # deployment uses the native queue, native/diskqueue.cpp).
        self.tlogs = [
            TLog(
                sched,
                recovery_version=recovery_version,
                durable=SimDiskQueue() if durable else None,
            )
            for _ in range(n_logs)
        ]
        self.live = [True] * n_logs
        # Satellite logs: replicas in a SECOND failure domain of the
        # primary region that hold only the full mutation stream
        # (ha-write-path.rst: "satellite transaction logs only store the
        # log router tags"). Commits ack only after satellites are
        # durable too, so a whole-primary-DC death leaves the acked
        # suffix recoverable from them (RPO=0).
        self.satellites = [
            TLog(
                sched,
                recovery_version=recovery_version,
                durable=SimDiskQueue() if durable else None,
            )
            for _ in range(n_satellites)
        ]
        self.satellite_live = [True] * n_satellites
        # The system-level durable version: set once every live replica
        # has acked a push (what proxies/storages chain on).
        self.version = Notified(recovery_version)
        self.epoch = 1

    # -- replica selection -------------------------------------------------

    def _live_logs(self) -> list[TLog]:
        logs = [t for t, alive in zip(self.tlogs, self.live) if alive]
        if not logs:
            raise AllLogsDeadError()
        return logs

    def kill(self, i: int) -> None:
        """Mark log replica i dead (its state freezes; it no longer
        participates in pushes, peeks, or pops)."""
        self.live[i] = False
        self._live_logs()  # raises if that was the last one

    def kill_dc(self) -> None:
        """Whole-primary-DC death: EVERY main log replica dies at once
        (no last-replica guard — this is the disaster, not an operation).
        Satellites live in a different failure domain and survive;
        subsequent commits/peeks raise AllLogsDeadError until a region
        failover promotes the remote."""
        self.live = [False] * len(self.live)

    def _live_satellites(self) -> list[TLog]:
        return [
            t for t, alive in zip(self.satellites, self.satellite_live)
            if alive
        ]

    def kill_satellite(self, i: int) -> None:
        self.satellite_live[i] = False

    def crash_and_reboot(self, i: int, rng=None) -> None:
        """Power-loss the replica's simulated disk (un-fsynced data may
        tear — AsyncFileNonDurable semantics), run the DiskQueue
        recovery scan, then catch the replica up from a live peer and
        return it to service. The sim analog of a tlog process reboot."""
        t = self.tlogs[i]
        # find the peer BEFORE marking dead: if none exists, refuse
        # without corrupting the live set (the replica is still healthy)
        peer = next(
            (
                tl
                for j, (tl, alive) in enumerate(zip(self.tlogs, self.live))
                if alive and j != i
            ),
            None,
        )
        if peer is None:
            raise AllLogsDeadError("no live peer to catch up from")
        self.live[i] = False
        if t.dq is not None:
            t.dq.crash(rng)
            t.restore_from_disk()
        t.catch_up_from(peer)
        self.live[i] = True

    # -- the TLog-compatible surface --------------------------------------

    async def commit(self, req: TLogCommitRequest) -> int:
        # span-threaded push: one child of the proxy's commitBatch span
        # per log-system push (not per replica — the replicas share the
        # ack barrier below)
        span = None
        if req.span is not None:
            from foundationdb_tpu_torch.utils.spans import Span, SpanContext

            span = Span(
                "tlog.push", parent=SpanContext(*req.span),
                clock=self.sched.now,
            ).attribute("Version", req.version)
        try:
            return await self._commit_spanned(req)
        finally:
            if span is not None:
                span.finish()

    async def _commit_spanned(self, req: TLogCommitRequest) -> int:
        logs = self._live_logs()
        tasks = [self.sched.spawn(t.commit(req)).done for t in logs]
        if self.satellites:
            # Satellite push rides the SAME ack barrier as the main
            # replicas: the commit is not acked until the stream is
            # durable in the second failure domain (the HA write path's
            # RPO=0 contract). Satellites store only the full-stream
            # tag — per-storage tags never leave the main DC.
            from foundationdb_tpu_torch.cluster.tlog import LOG_STREAM_TAG

            sat_msgs = {}
            if LOG_STREAM_TAG in req.messages:
                sat_msgs[LOG_STREAM_TAG] = req.messages[LOG_STREAM_TAG]
            sat_req = TLogCommitRequest(
                prev_version=req.prev_version,
                version=req.version,
                messages=sat_msgs,
                known_committed_version=req.known_committed_version,
                epoch=req.epoch,
            )
            tasks += [
                self.sched.spawn(t.commit(sat_req)).done
                for t in self._live_satellites()
            ]
        results = await all_of(tasks)
        v = max(results)
        if v > self.version.get():
            self.version.set(v)
        return v

    async def peek(self, tag: int, after_version: int):
        # any live replica serves (identical streams); wait on the
        # system version so a mid-wait kill cannot strand the waiter on
        # a frozen replica's Notified
        await self.version.when_at_least(after_version + 1)
        return await self._live_logs()[0].peek(tag, after_version)

    def pop(self, tag: int, up_to_version: int, consumer: str = "storage"):
        for t in self._live_logs():
            t.pop(tag, up_to_version, consumer)
        for t in self._live_satellites():
            t.pop(tag, up_to_version, consumer)

    def tag_backlog_bytes(self, tag: int, consumer: str = "storage") -> int:
        """Worst retained bytes for one consumer's tag across live
        replicas (the per-storage write-queue sensor: replicas hold the
        same stream, so the slowest-trimmed one is the honest depth).
        Dead replicas don't report — a frozen log isn't a queue."""
        return max(
            (
                t.tag_backlog_bytes(tag, consumer)
                for t, alive in zip(self.tlogs, self.live)
                if alive
            ),
            default=0,
        )

    def has_log_consumers(self) -> bool:
        return any(t.has_log_consumers() for t in self._live_logs())

    @property
    def tag_partitioned(self) -> bool:
        """The REAL per-tag fan-out state: True once commits have fanned out to more than one
        per-storage tag stream inside this log front. The wire pipeline
        reports True when its tlogs are key-range partitioned; here the
        partitioning lives inside the replicas' tag-keyed streams — the
        sensor means "mutations are routed per tag" on both paths."""
        from foundationdb_tpu_torch.cluster.tlog import LOG_STREAM_TAG

        tags: set = set()
        for t, alive in zip(self.tlogs, self.live):
            if alive:
                tags.update(t._messages)
                tags.update(t._spilled)
        tags.discard(LOG_STREAM_TAG)
        return len(tags) > 1

    def register_consumer(self, name: str) -> None:
        for t in self.tlogs + self.satellites:
            t.register_consumer(name)

    def register_tag_mirror(self, tag: int, name: str) -> None:
        for t in self.tlogs + self.satellites:
            t.register_tag_mirror(tag, name)

    def unregister_tag_mirror(self, tag: int, name: str) -> None:
        for t in self.tlogs + self.satellites:
            t.unregister_tag_mirror(tag, name)

    def unregister_consumer(self, name: str) -> None:
        for t in self.tlogs + self.satellites:
            t.unregister_consumer(name)

    def lock(self, epoch: int, recovery_version: int = None) -> None:
        self.epoch = max(self.epoch, epoch)
        # dead replicas and satellites lock too: no zombie pushes
        for t in self.tlogs + self.satellites:
            t.lock(epoch, recovery_version)
        if recovery_version is not None and recovery_version > self.version.get():
            self.version.set(recovery_version)
