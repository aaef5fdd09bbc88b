"""Backup and restore: snapshot + mutation-log backup into a container.

Behavioral mirror of the reference's backup stack in miniature
(fdbclient/FileBackupAgent.actor.cpp + BackupContainer*.cpp +
fdbserver/BackupWorker.actor.cpp): a backup is (a) a range snapshot of
the keyspace at a version, written as range files, plus (b) a continuous
mutation log pulled from the TLog, written as log files; restore loads
the newest snapshot at-or-below the target version and replays the
mutation log up to it. Containers abstract the storage medium (the
reference's file/S3/azure backends): here an in-memory dict container
and a local-directory container (JSON files).
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional


class BackupContainer:
    """In-memory container (the IBackupContainer shape)."""

    def __init__(self):
        self.files: dict[str, Any] = {}

    def write_file(self, name: str, data) -> None:
        self.files[name] = data

    def read_file(self, name: str):
        return self.files[name]

    def list_files(self, prefix: str = "") -> list[str]:
        return sorted(n for n in self.files if n.startswith(prefix))


class DirBackupContainer(BackupContainer):
    """Local-directory container (file:// URLs in the reference)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def write_file(self, name: str, data) -> None:
        full = os.path.join(self.path, name)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        with open(full, "w") as f:
            json.dump(_jsonable(data), f)

    def read_file(self, name: str):
        with open(os.path.join(self.path, name)) as f:
            return _unjsonable(json.load(f))

    def list_files(self, prefix: str = "") -> list[str]:
        out = []
        for root, _dirs, files in os.walk(self.path):
            for fn in files:
                rel = os.path.relpath(os.path.join(root, fn), self.path)
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)


def _jsonable(x):
    if isinstance(x, bytes):
        return {"__b": x.decode("latin-1")}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    return x


def _unjsonable(x):
    if isinstance(x, dict):
        if set(x) == {"__b"}:
            return x["__b"].encode("latin-1")
        return {k: _unjsonable(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_unjsonable(v) for v in x]
    return x


def select_snapshot(container, target_version=None) -> int:
    """Newest snapshot at-or-below target (shared by the sequential
    and parallel restore paths — one eligibility rule, not two)."""
    snaps = [
        int(n.split("/")[1])
        for n in container.list_files("snapshots/")
        if n.endswith("/manifest")
    ]
    if not snaps:
        raise ValueError("container has no snapshots")
    eligible = [
        v for v in snaps if target_version is None or v <= target_version
    ]
    if not eligible:
        raise ValueError(
            f"no snapshot at or below target version {target_version}"
        )
    return max(eligible)


class BackupAgent:
    """Drives snapshot + log backup against a live cluster."""

    def __init__(self, db, container: BackupContainer):
        self.db = db
        self.container = container
        self._manager = None
        self.log_version = 0

    # -- snapshot (range files; FileBackupAgent range tasks) ---------------

    def register_log_consumer(self, cluster) -> None:
        """Must precede (or coincide with) the snapshot: proxies emit the
        full-stream tag only while a log consumer is registered, so a
        mutation between the snapshot's read version and registration
        would otherwise be on neither the snapshot nor the stream."""
        cluster.tlog.register_consumer("backup")
        self._tlog = cluster.tlog

    async def _stream_barrier(self, cluster) -> None:
        """Close the registration race: a batch IN FLIGHT when the
        consumer registers may have assigned its tags pre-registration
        while committing ABOVE the snapshot's read version — on neither
        the snapshot nor the stream (found by the soak's
        BackupToDBCorrectness workload, seed 6). Each proxy's pipeline
        assigns batches serially, so one barrier commit PER PROXY after
        registration guarantees every later-version batch on that proxy
        emits the stream tag; the snapshot read version, taken after
        the barriers, then covers everything that didn't. The reference
        gets the same fence from writing the backup config through a
        transaction the proxies apply at a version."""
        # Fence EACH proxy that existed at registration with a PINNED
        # commit — round-robin adjacency is broken by concurrent
        # traffic (second review pass). A proxy replaced by recovery
        # needs no fence: post-registration proxies see the consumer
        # from their first batch.
        fence_set = list(getattr(cluster, "commit_proxies", []))
        for i, proxy in enumerate(fence_set):
            last = None
            for _attempt in range(60):
                if proxy not in getattr(cluster, "commit_proxies", []):
                    break  # replaced by a post-registration generation
                txn = self.db.create_transaction()
                txn.set(b"\xff/backup/barrier", b"%d" % i)
                txn._pin_proxy = proxy
                try:
                    await txn.commit()
                    break
                except Exception as e:
                    last = e
                    await self.db.sched.delay(0.02)
            else:
                # permanent failure (e.g. a LOCKED DR destination) must
                # surface, not hang the snapshot forever
                raise last if last is not None else RuntimeError(
                    "stream barrier could not commit"
                )

    async def snapshot(self, *, chunk: int = 1000) -> int:
        """Full range snapshot at one read version; returns that version."""
        cluster = getattr(self.db, "cluster", None)
        if cluster is not None:
            self.register_log_consumer(cluster)
            await self._stream_barrier(cluster)
        txn = self.db.create_transaction()
        version = await txn.get_read_version()
        items = await txn.get_range(b"", b"\xff")
        for i in range(0, max(len(items), 1), chunk):
            part = items[i : i + chunk]
            self.container.write_file(
                f"snapshots/{version:016d}/range_{i // chunk:06d}",
                [[k, v] for k, v in part],
            )
        self.container.write_file(
            f"snapshots/{version:016d}/manifest",
            {"version": version, "files": (len(items) + chunk - 1) // chunk},
        )
        return version

    # -- continuous mutation log (BackupWorker roles) ---------------------

    def start_log_backup(self, cluster) -> None:
        """Recruit per-epoch BackupWorkers (cluster/backup_worker.py):
        the full-stream tag — every committed mutation exactly once, in
        commit order — flows into log files, and recoveries hand off
        between workers with chained watermarks (the reference's
        BackupWorker displacement discipline)."""
        from foundationdb_tpu_torch.cluster.backup_worker import (
            BackupWorkerManager,
        )

        self.register_log_consumer(cluster)
        self._manager = BackupWorkerManager(
            self.db.sched, lambda: cluster, self.container,
            start_version=self.log_version,
        )
        self._manager.start()

    def stop_log_backup(self) -> None:
        if self._manager is not None:
            self.log_version = self._manager.saved_version
            if self._manager.worker is not None:
                self.log_version = max(
                    self.log_version, self._manager.worker.saved_version
                )
            self._manager.stop()  # owns the consumer registration
            self._manager = None

    # -- restore (parallel-restore roles, compressed to one pass) ----------

    async def restore(self, *, target_version: Optional[int] = None) -> int:
        """Clear the keyspace and restore snapshot + logs up to target."""
        base = select_snapshot(self.container, target_version)
        manifest = self.container.read_file(f"snapshots/{base:016d}/manifest")

        txn = self.db.create_transaction()
        txn.clear_range(b"", b"\xff")
        for i in range(manifest["files"]):
            for k, v in self.container.read_file(
                f"snapshots/{base:016d}/range_{i:06d}"
            ):
                txn.set(bytes(k), bytes(v))
        # replay mutation log (base, target]
        restored = base
        for name in self.container.list_files("logs/"):
            for vs, msgs in sorted(self.container.read_file(name).items()):
                v = int(vs)
                if v <= base:
                    continue
                if target_version is not None and v > target_version:
                    continue
                for m in msgs:
                    kind = m[0]
                    if kind == "set":
                        txn.set(bytes(m[1]), bytes(m[2]))
                    elif kind == "clear":
                        txn.clear_range(bytes(m[1]), bytes(m[2]))
                    elif kind == "atomic":
                        txn.atomic_op(m[1], bytes(m[2]), bytes(m[3]))
                restored = max(restored, v)
        await txn.commit()
        return restored
