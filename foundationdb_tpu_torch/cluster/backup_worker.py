"""BackupWorker: the per-epoch log-tailing backup role.

Capability match for fdbserver/BackupWorker.actor.cpp: a worker is
recruited FOR ONE LOG EPOCH, tails the full mutation stream into log
files in the backup container, advances a saved-version watermark (the
"popped" position other components may garbage-collect behind), and on
recovery is DISPLACED — it drains exactly what its epoch committed,
writes the tail, and exits so the next epoch's worker continues from
its watermark. The epoch manager mirrors the cluster controller's
recruitment loop (worker.actor.cpp backup recruitment): one worker per
epoch, chained watermarks, no gap and no double-write across the
recovery boundary.
"""

from __future__ import annotations

from foundationdb_tpu_torch.runtime.flow import ActorCancelled, Promise
from foundationdb_tpu_torch.utils.probes import code_probe, declare
from foundationdb_tpu_torch.utils.trace import TraceEvent

declare("backup_worker.displaced")


class BackupWorker:
    """Tails LOG_STREAM_TAG for one epoch into `container`."""

    def __init__(self, sched, tlog, container, *, epoch: int,
                 start_version: int = 0, consumer: str = "backup",
                 own_consumer: bool = True):
        self.sched = sched
        self.tlog = tlog
        self.container = container
        self.epoch = epoch
        self.saved_version = start_version
        self.consumer = consumer
        # Under a manager, the MANAGER owns the consumer registration:
        # if the displaced worker unregistered on stop, any mutation
        # committed between its last peek and the successor's
        # registration would be trimmed from the tlog — a silent,
        # permanent gap in the backup log. Standalone
        # workers (tests) still own their registration.
        self.own_consumer = own_consumer
        self.displaced = Promise()
        self._task = None

    def start(self) -> None:
        if self.own_consumer:
            self.tlog.register_consumer(self.consumer)
        self._task = self.sched.spawn(
            self._pull(), name=f"backup-worker-e{self.epoch}"
        )

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
        if self.own_consumer:
            self.tlog.unregister_consumer(self.consumer)

    def _write(self, entries: dict) -> None:
        if not entries:
            return
        # zero-padded version keys: restore sorts these strings, so
        # unpadded digits would replay out of numeric order
        self.container.write_file(
            f"logs/{min(entries):016d}",
            {f"{v:016d}": m for v, m in sorted(entries.items())},
        )

    async def _pull(self) -> None:
        from foundationdb_tpu_torch.cluster.tlog import LOG_STREAM_TAG

        try:
            after = self.saved_version
            while True:
                displaced = self.tlog.epoch > self.epoch
                got, log_version = await self.tlog.peek(
                    LOG_STREAM_TAG, after
                )
                entries = {v: msgs for v, msgs in got if msgs}
                self._write(entries)
                after = max(log_version, max(entries, default=0))
                self.saved_version = after
                self.tlog.pop(LOG_STREAM_TAG, after, consumer=self.consumer)
                if displaced or self.tlog.epoch > self.epoch:
                    # drained through the lock version: everything this
                    # epoch committed is in the container — hand off
                    code_probe(True, "backup_worker.displaced")
                    TraceEvent("BackupWorkerDone").detail(
                        "Epoch", self.epoch
                    ).detail("SavedVersion", after).log()
                    break
                await self.tlog.version.when_at_least(after + 1)
        except ActorCancelled:
            raise
        finally:
            if not self.displaced.is_set:
                self.displaced.send(self.saved_version)


class BackupWorkerManager:
    """Recruit one BackupWorker per log epoch, chaining watermarks —
    the CC's backup-recruitment loop in miniature. Survives recoveries:
    when the epoch bumps, the displaced worker finishes its epoch and
    the manager recruits the next one from its watermark."""

    CONSUMER = "backup"

    def __init__(self, sched, cluster_ref, container,
                 start_version: int = 0):
        self.sched = sched
        self._cluster = cluster_ref  # callable -> cluster (tlog may change)
        self.container = container
        self.saved_version = start_version
        self.worker: BackupWorker | None = None
        self._task = None
        self._tlog = None

    def start(self) -> None:
        self._task = self.sched.spawn(self._manage(), name="backup-manager")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
        if self.worker is not None:
            self.worker.stop()
        if self._tlog is not None:
            self._tlog.unregister_consumer(self.CONSUMER)

    async def _manage(self) -> None:
        try:
            prev = None
            while True:
                tlog = self._cluster().tlog
                # the registration is CONTINUOUS across worker swaps —
                # registering the (possibly new) tlog BEFORE stopping
                # the displaced worker means no commit can be trimmed
                # in the handoff window
                tlog.register_consumer(self.CONSUMER)
                self._tlog = tlog
                if prev is not None:
                    prev.stop()
                self.worker = BackupWorker(
                    self.sched, tlog, self.container,
                    epoch=tlog.epoch, start_version=self.saved_version,
                    consumer=self.CONSUMER, own_consumer=False,
                )
                self.worker.start()
                # prev deliberately holds the PREVIOUS epoch's worker
                # across the displacement wait — a stale handle is the
                # point (the successor stops its predecessor)
                prev = self.worker  # flowcheck: ignore[flow.stale-read-across-wait]
                self.saved_version = await self.worker.displaced.future
        except ActorCancelled:
            raise
