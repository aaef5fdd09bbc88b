"""Blob granules: key ranges materialized as snapshot + delta files.

Behavioral mirror of the reference's largest subsystem absent until now
(fdbserver/BlobManager.actor.cpp, fdbserver/BlobWorker.actor.cpp,
fdbclient/BlobGranuleFiles.cpp): the keyspace is carved into GRANULES;
a BlobWorker tails the log system and materializes each granule as a
base SNAPSHOT file plus ordered DELTA files in a blob container, so a
reader can reconstruct the granule's contents at any version in the
retention window WITHOUT touching the storage servers — cheap analytics
scans and time travel off the hot path.

Shape notes vs the reference:
* Files live in the existing BackupContainer abstraction (memory or
  dir) — the reference's S3/azure containers are a transport detail.
* The worker consumes the tlog's full-stream tag exactly like the
  backup agent (one copy of each mutation, commit order), routes
  mutations to granules by key, and flushes a granule's delta buffer
  once it crosses DELTA_FLUSH_BYTES (BlobWorker.actor.cpp's
  writeDeltaFile trigger).
* Re-snapshotting: once a granule's accumulated delta bytes pass
  SNAPSHOT_AT_DELTA_BYTES, the worker folds snapshot+deltas into a new
  snapshot file at the flush version (granule compaction,
  BlobWorker.actor.cpp:compactBlobGranule); older files stay for time
  travel until pruned.
* The BlobManager owns the granule map, persists it under
  `\\xff/blobGranuleMapping/`, and SPLITS a granule whose materialized
  size crosses SPLIT_BYTES (BlobManager.actor.cpp's
  maybeSplitRange) — split points come from the granule's own sorted
  keys, so halves are balanced by bytes, not keyspace.

File naming (sortable, version-zero-padded like the backup layout):
  granules/<gid>/snapshot/<v16>      json {key_hex: value_hex}
  granules/<gid>/delta/<v16>         json [[v, [mutation...]], ...]

The port's own copy of foundationdb_tpu.cluster.blob_granules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from foundationdb_tpu_torch.runtime.flow import ActorCancelled, Scheduler
from foundationdb_tpu_torch.utils.probes import code_probe, declare

declare(
    "blob.delta_flushed",
    "blob.resnapshotted",
    "blob.granule_split",
    "blob.time_travel_read",
)

MAPPING_PREFIX = b"\xff/blobGranuleMapping/"


def _hex(b: bytes) -> str:
    return b.hex()


def _unhex(s: str) -> bytes:
    return bytes.fromhex(s)


@dataclasses.dataclass
class Granule:
    gid: int
    begin: bytes
    end: bytes  # b"" = unbounded
    #: in-memory tail: mutations at versions newer than the last flush
    buffer: list  # [(version, mutation)]
    buffer_bytes: int = 0
    #: bytes of delta files since the last snapshot (re-snapshot trigger)
    delta_bytes_since_snapshot: int = 0
    last_flush_version: int = 0
    #: materialized bytes of the last snapshot file (cheap size estimate)
    snapshot_bytes: int = 0
    #: (version, gid) file refs — gid names the DIRECTORY holding the
    #: file, which is an ANCESTOR's for refs inherited across a split
    #: (time travel below the split version reads the parent's files)
    snapshot_versions: list = dataclasses.field(default_factory=list)
    delta_versions: list = dataclasses.field(default_factory=list)

    def covers(self, key: bytes) -> bool:
        return self.begin <= key and (self.end == b"" or key < self.end)


class BlobWorker:
    """Materializes assigned granules from the log stream
    (fdbserver/BlobWorker.actor.cpp)."""

    DELTA_FLUSH_BYTES = 4 << 10
    SNAPSHOT_AT_DELTA_BYTES = 16 << 10

    def __init__(self, sched: Scheduler, tlog, container, *,
                 name: str = "blobworker0"):
        from foundationdb_tpu_torch.cluster.tlog import LOG_STREAM_TAG

        self.sched = sched
        self.tlog = tlog
        self.container = container
        self.name = name
        self.granules: dict[int, Granule] = {}
        self.version = 0  # granule data complete through this version
        self._tag = LOG_STREAM_TAG
        self._task = None
        self.manager: Optional["BlobManager"] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if hasattr(self.tlog, "register_consumer"):
            self.tlog.register_consumer(self.name)
        self._task = self.sched.spawn(self._pull(), name=self.name)

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if hasattr(self.tlog, "unregister_consumer"):
            # a stopped worker must not pin the full log stream: its pop
            # mark would freeze the tlog's trim floor forever
            self.tlog.unregister_consumer(self.name)

    def assign(self, g: Granule) -> None:
        self.granules[g.gid] = g

    def unassign(self, gid: int) -> "Granule | None":
        return self.granules.pop(gid, None)

    # -- the log tail ----------------------------------------------------

    async def _pull(self) -> None:
        after = self.version
        while True:
            got, log_version = await self.tlog.peek(self._tag, after)
            for v, msgs in got:
                for m in msgs:
                    self._route(v, m)
            after = max(log_version, max((v for v, _ in got), default=0))
            self.version = after
            # snapshot the dict: a flush can trigger a manager split
            # that assigns the new child granule to this worker
            for g in list(self.granules.values()):
                if g.buffer_bytes >= self.DELTA_FLUSH_BYTES:
                    self._flush_delta(g)
            self.tlog.pop(self._tag, after, consumer=self.name)
            await self.tlog.version.when_at_least(after + 1)

    def _route(self, v: int, m) -> None:
        if m[0] == "set":
            for g in self.granules.values():
                if g.covers(m[1]):
                    g.buffer.append((v, m))
                    g.buffer_bytes += len(m[1]) + len(m[2]) + 16
                    break
        else:  # clear range: may straddle granules; clip per granule
            # (no unbounded-clear convention exists in the mutation
            # stream: clear ends are always concrete keys)
            _, cb, ce = m
            for g in self.granules.values():
                lo = max(cb, g.begin)
                hi = ce if g.end == b"" else min(ce, g.end)
                if lo < hi:
                    g.buffer.append((v, ("clear", lo, hi)))
                    g.buffer_bytes += len(lo) + len(hi) + 16

    # -- files -----------------------------------------------------------

    def _flush_delta(self, g: Granule) -> None:
        if not g.buffer:
            return
        v = max(ver for ver, _ in g.buffer)
        payload = [
            [ver, [mut[0]] + [_hex(x) for x in mut[1:]]]
            for ver, mut in g.buffer
        ]
        self.container.write_file(
            f"granules/{g.gid}/delta/{v:016d}", payload
        )
        code_probe(True, "blob.delta_flushed")
        g.delta_versions.append((v, g.gid))
        g.delta_bytes_since_snapshot += g.buffer_bytes
        g.buffer = []
        g.buffer_bytes = 0
        g.last_flush_version = v
        if g.delta_bytes_since_snapshot >= self.SNAPSHOT_AT_DELTA_BYTES:
            self._resnapshot(g, v)
        if self.manager is not None:
            self.manager.note_granule_size(g)

    def _resnapshot(self, g: Granule, v: int) -> None:
        """Fold snapshot+deltas into a fresh snapshot at v (granule
        compaction). Old files remain for time travel."""
        kvs = self.materialize(g, v)
        self.container.write_file(
            f"granules/{g.gid}/snapshot/{v:016d}",
            {_hex(k): _hex(val) for k, val in kvs.items()},
        )
        code_probe(True, "blob.resnapshotted")
        g.snapshot_versions.append((v, g.gid))
        g.snapshot_bytes = sum(len(k) + len(x) for k, x in kvs.items())
        g.delta_bytes_since_snapshot = 0

    def snapshot_granule(self, g: Granule, kvs: dict, v: int) -> None:
        """Initial materialization from a storage snapshot (the
        BlobWorker's opening snapshot when a granule is first assigned)."""
        self.container.write_file(
            f"granules/{g.gid}/snapshot/{v:016d}",
            {_hex(k): _hex(val) for k, val in kvs.items()},
        )
        g.snapshot_versions.append((v, g.gid))
        g.snapshot_bytes = sum(len(k) + len(x) for k, x in kvs.items())
        g.last_flush_version = max(g.last_flush_version, v)

    def force_flush(self, version: int) -> None:
        """Flush every granule's buffer so files cover `version` (the
        read path's flush-before-read, BlobWorker readBlobGranule)."""
        # list(): a flush can trigger a split that assigns a new child
        for g in list(self.granules.values()):
            if g.buffer and g.last_flush_version < version:
                self._flush_delta(g)

    # -- reads -----------------------------------------------------------

    def materialize(self, g: Granule, version: int) -> dict[bytes, bytes]:
        """Granule contents at `version` from FILES + the memory tail
        (fdbclient/BlobGranuleFiles.cpp materializeBlobGranule)."""
        base = {}
        snaps = [(sv, gid) for sv, gid in g.snapshot_versions
                 if sv <= version]
        snap_v, snap_gid = max(snaps) if snaps else (0, g.gid)
        if snaps:
            raw = self.container.read_file(
                f"granules/{snap_gid}/snapshot/{snap_v:016d}"
            )
            base = {_unhex(k): _unhex(val) for k, val in raw.items()}
        for dv, dgid in sorted(g.delta_versions):
            if dv <= snap_v:
                continue  # folded into the snapshot already
            raw = self.container.read_file(f"granules/{dgid}/delta/{dv:016d}")
            for ver, mut in raw:
                if snap_v < ver <= version:
                    self._apply(base, mut[0], *(_unhex(x) for x in mut[1:]))
        for ver, mut in g.buffer:
            if snap_v < ver <= version:
                self._apply(base, mut[0], *mut[1:])
        # clip to the granule's CURRENT range: after a split the parent's
        # older files still span the pre-split range, and those foreign
        # keys now belong to (and may be stale vs) the sibling granule
        return {k: v for k, v in base.items() if g.covers(k)}

    @staticmethod
    def _apply(base: dict, op: str, *args) -> None:
        if op == "set":
            base[args[0]] = args[1]
        else:
            b, e = args
            for k in [k for k in base if k >= b and (e == b"" or k < e)]:
                del base[k]


class BlobManager:
    """Owns the granule map: assignment, persistence, splitting
    (fdbserver/BlobManager.actor.cpp)."""

    SPLIT_BYTES = 48 << 10

    def __init__(self, db, workers: list[BlobWorker]):
        self.db = db
        self.workers = workers
        self.granules: dict[int, Granule] = {}
        self.assignment: dict[int, BlobWorker] = {}
        self._next_gid = 0
        for w in workers:
            w.manager = self

    # -- range management ------------------------------------------------

    async def blobbify(self, begin: bytes, end: bytes,
                       snapshot: dict, version: int) -> Granule:
        """Start materializing [begin, end): create the granule, write
        its opening snapshot, persist the mapping. Clamped to the NORMAL
        keyspace — the system keyspace is never blobbified (the
        reference's blobbifiable range check, BlobManager.actor.cpp:
        isRangeValid), not least because the granule mapping itself
        lives there."""
        if end == b"" or end > b"\xff":
            end = b"\xff"
        for other in self.granules.values():
            if begin < other.end and other.begin < end:
                raise ValueError(
                    f"range overlaps granule {other.gid} "
                    f"[{other.begin!r}, {other.end!r})"
                )
        g = Granule(self._next_gid, begin, end, [])
        self._next_gid += 1
        self.granules[g.gid] = g
        w = self.workers[g.gid % len(self.workers)]
        w.assign(g)
        self.assignment[g.gid] = w
        w.snapshot_granule(
            g,
            {k: v for k, v in snapshot.items() if g.covers(k)},
            version,
        )
        await self._persist_mapping()
        return g

    async def _persist_mapping(self) -> None:
        txn = self.db.create_transaction()
        txn.clear_range(MAPPING_PREFIX, MAPPING_PREFIX + b"\xff")
        for g in self.granules.values():
            txn.set(
                MAPPING_PREFIX + b"%08d" % g.gid,
                repr((g.begin, g.end, self.assignment[g.gid].name)).encode(),
            )
        await txn.commit()

    async def _persist_mapping_bg(self) -> None:
        """Background persist for the post-split path: a mapping write
        racing data-plane chaos must not become an escaped actor error —
        the in-memory mapping is authoritative and the next persist
        rewrites the full keyspace anyway."""
        try:
            await self._persist_mapping()
        except ActorCancelled:
            raise
        except Exception as e:
            from foundationdb_tpu_torch.utils.trace import SEV_WARN, TraceEvent

            TraceEvent("BlobMappingPersistFailed", severity=SEV_WARN) \
                .detail("Err", repr(e)).log()

    def note_granule_size(self, g: Granule) -> None:
        """Worker size report: split when materialized size crosses
        SPLIT_BYTES (BlobManager maybeSplitRange). Split is local and
        synchronous; the mapping re-persists asynchronously."""
        w = self.assignment.get(g.gid)
        if w is None:
            return
        # cheap estimate FIRST (snapshot + deltas since): the full
        # materialize below is O(granule) and must not run per 4KB flush
        if g.snapshot_bytes + g.delta_bytes_since_snapshot < self.SPLIT_BYTES:
            return
        kvs = w.materialize(g, w.version)
        size = sum(len(k) + len(v) for k, v in kvs.items())
        if size < self.SPLIT_BYTES or len(kvs) < 2:
            return
        keys = sorted(kvs)
        # byte-balanced split point from the granule's own keys
        acc, half = 0, size // 2
        split = keys[len(keys) // 2]
        for k in keys:
            acc += len(k) + len(kvs[k])
            if acc >= half:
                split = k
                break
        if split <= g.begin or (g.end != b"" and split >= g.end):
            return
        code_probe(True, "blob.granule_split")
        right = Granule(self._next_gid, split, g.end, [])
        self._next_gid += 1
        v = w.version
        # buffered mutations are all <= w.version and therefore folded
        # into the children's opening snapshots below: buffers restart
        # empty on both sides
        g.end, g.buffer, g.buffer_bytes = split, [], 0
        # the right child INHERITS the parent's file refs: time travel
        # below the split version reads the parent's files (clipped to
        # the child's range by materialize)
        right.snapshot_versions = list(g.snapshot_versions)
        right.delta_versions = list(g.delta_versions)
        self.granules[right.gid] = right
        w.assign(right)
        self.assignment[right.gid] = w
        w.snapshot_granule(
            g, {k: val for k, val in kvs.items() if k < split}, v)
        w.snapshot_granule(
            right, {k: val for k, val in kvs.items() if k >= split}, v)
        g.delta_bytes_since_snapshot = 0
        # fire-and-forget by design (the split already happened; the next
        # assign/split re-persists the full mapping) — _persist_mapping_bg
        # contains its own errors so chaos can't crash the manager
        self.db.sched.spawn(self._persist_mapping_bg(), name="blob-mapping")  # flowcheck: ignore[actor.fire-and-forget]

    # -- reads -----------------------------------------------------------

    def read(self, begin: bytes, end: bytes,
             version: Optional[int] = None) -> dict[bytes, bytes]:
        """Point-in-time read of [begin, end) from granule files alone
        (readBlobGranules). None = newest materialized version."""
        out = {}
        if version is None:
            # one version for the WHOLE read: per-worker versions would
            # tear a cross-granule transaction when granules live on
            # different workers
            workers = {self.assignment[g.gid] for g in self.granules.values()}
            version_eff = min((w.version for w in workers), default=0)
        else:
            version_eff = version
        code_probe(version is not None, "blob.time_travel_read")
        # flush FIRST, then snapshot the granule list: a flush-triggered
        # split narrows a parent and creates a child, and a list taken
        # before the flush would miss the child's half of the keyspace.
        # Only workers owning RANGE-OVERLAPPING granules flush (children
        # stay on the parent's worker), and dict.fromkeys keeps the
        # iteration order deterministic — a set of objects would flush
        # in id() order and let split gid allocation diverge between
        # same-seed runs
        overlapping = [
            self.assignment[g.gid]
            for g in list(self.granules.values())
            if not (g.end != b"" and g.end <= begin)
            and not (end != b"" and g.begin >= end)
        ]
        for w in dict.fromkeys(overlapping):
            w.force_flush(version_eff)
        for g in list(self.granules.values()):
            if g.end != b"" and g.end <= begin:
                continue
            if end != b"" and g.begin >= end:
                continue
            w = self.assignment[g.gid]
            for k, val in w.materialize(g, version_eff).items():
                if k >= begin and (end == b"" or k < end):
                    out[k] = val
        return out
