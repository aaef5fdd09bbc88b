"""TLog: the replicated, version-ordered durable mutation log.

Behavioral mirror of `fdbserver/TLogServer.actor.cpp`:

* `commit` (tLogCommit :2311): mutations arrive tagged per storage
  server; versions must arrive in order (prev_version chain); a commit is
  durable once appended (the in-memory deque stands in for the DiskQueue
  ring file — fdbserver/DiskQueue.actor.cpp).
* `peek` (per-tag peek cursors, LogSystemPeekCursor.actor.cpp): a storage
  server reads messages for its tag strictly after a version, blocking
  until the log advances past it.
* `pop` (:popped bookkeeping): once a storage server durably applied a
  version, the prefix can be discarded.

The version chain uses the same Notified pattern as the resolver; commits
with a stale prev_version wait, duplicates are idempotent.

The port's own copy of foundationdb_tpu.cluster.tlog.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from foundationdb_tpu_torch.runtime.flow import Notified, Scheduler
from foundationdb_tpu_torch.utils.probes import declare

declare("tlog.diskqueue_recovery", "simdisk.torn_tail",
        "tlog.spill", "tlog.peek_from_spill")

Tag = int  # storage tag (the reference's Tag{locality, id})


def _mut_bytes(m) -> int:
    """Cheap per-mutation byte estimate (the queue-bytes sensor's unit;
    MutationRef::expectedSize analog — never exact serialization)."""
    try:
        return 8 + len(m[1]) + len(m[2])
    except Exception:
        return 32


@dataclasses.dataclass
class TLogCommitRequest:
    prev_version: int
    version: int
    # tag -> list of mutations for that storage server
    messages: dict[Tag, list[Any]]
    known_committed_version: int = 0
    epoch: int = 1  # generation of the pushing proxy
    # commit-path telemetry: the pushing batch's debug id + span context
    # (TLogCommitRequest.debugID / spanContext in the reference)
    debug_id: Any = None
    span: Any = None


#: The full-stream tag: carries each version's COMPLETE ordered mutation
#: list for log-consuming workers (backup/DR) — the role of the
#: reference's dedicated backup mutation tags (BackupWorker.actor.cpp).
#: Emitted by proxies only while such a consumer is registered; retained
#: only for non-storage consumers (storage never reads it).
LOG_STREAM_TAG: Tag = -1


class TLogStoppedError(Exception):
    """error_code_tlog_stopped: a previous-generation push after the log
    was locked by recovery (TagPartitionedLogSystem epoch locking)."""


class TLog:
    """One tlog instance.

    With `durable` set (a sim.diskqueue.SimDiskQueue), every commit is
    written-ahead to the queue and "fsynced" before the in-memory state
    updates — the native DiskQueue discipline (native/diskqueue.cpp) on
    the simulated disk, so simulation seeds exercise the recovery scan
    (crash -> restore_from_disk -> peer catch-up) exactly like the
    reference's simulated files reach its DiskQueue code
    (fdbrpc/sim2.actor.cpp simulated disk + AsyncFileNonDurable).
    """

    def __init__(self, sched: Scheduler, *, recovery_version: int = 0,
                 durable=None):
        self.sched = sched
        self.epoch = 1
        self.version = Notified(recovery_version)
        self.dq = durable
        # version -> dq seq of its record (for physical pops)
        self._seq_of_version: list[tuple[int, int]] = []
        # tag -> list of (version, mutations)
        self._messages: dict[Tag, list[tuple[int, list[Any]]]] = {}
        # consumer -> tag -> popped-through version. Messages are retained
        # until EVERY registered consumer has popped them (the reference's
        # per-tag popped bookkeeping generalized to backup workers, which
        # read every tag — fdbserver/BackupWorker.actor.cpp).
        self._popped: dict[str, dict[Tag, int]] = {"storage": {}}
        # TSS mirror consumers per tag (design/tss.md): a mirror reads
        # a STORAGE tag with its own pop cursor — retention for that
        # tag floors at the SLOWEST of the pair, and mirror consumers
        # never constrain LOG_STREAM_TAG (they don't read it; letting
        # their never-popped stream marks pin it would leak the log)
        self._tag_mirrors: dict[Tag, set[str]] = {}
        # SPILL state (TLogServer.actor.cpp:2311 spill-by-reference):
        # when retained mutations exceed SERVER_KNOBS.TLOG_SPILL_THRESHOLD,
        # the OLDEST unpopped versions are evicted from memory and
        # replaced by per-tag (version, dq seq) index entries; peeks for
        # spilled versions read the records back off the DiskQueue. A
        # lagging consumer therefore bounds tlog MEMORY, not disk.
        self._spilled: dict[Tag, list[tuple[int, int]]] = {}
        self._mem_mutations = 0
        # -- saturation sensors (the Ratekeeper's TLogQueueInfo inputs:
        # Ratekeeper.actor.cpp tracks each log's queue bytes through a
        # Smoother before computing the txn/s budget) -----------------
        # retained mutation BYTES, maintained incrementally alongside
        # _mem_mutations (same update sites)
        self._mem_bytes = 0
        from foundationdb_tpu_torch.utils.metrics import Smoother

        #: smoothed retained-queue bytes on the VIRTUAL clock (sim
        #: determinism: identical per seed, safe next to trace digests)
        self.smoothed_queue_bytes = Smoother(1.0, clock=sched.now)
        #: smoothed input bytes/s (the reference's smoothInputBytes)
        self.smoothed_input_bytes = Smoother(1.0, clock=sched.now)

    def saturation(self) -> dict:
        """The tlog's qos sensor block (status JSON `processes.*.qos`):
        retained queue depth/bytes (smoothed + instantaneous) and the
        durability lag — how far the slowest storage pop cursor trails
        this log's version."""
        storage_marks = [
            self._popped["storage"].get(tag, 0)
            for tag in set(self._messages) | set(self._spilled)
            if tag != LOG_STREAM_TAG
        ]
        v = self.version.get()
        return {
            "queue_mutations": self._mem_mutations,
            "queue_bytes": self._mem_bytes,
            "smoothed_queue_bytes": self.smoothed_queue_bytes.smooth_total(),
            "input_bytes_per_s": self.smoothed_input_bytes.smooth_rate(),
            "spilled_versions": sum(
                len(e) for e in self._spilled.values()
            ),
            "durability_lag_versions": (
                v - min(storage_marks) if storage_marks else 0
            ),
        }

    def tag_backlog_bytes(self, tag: Tag, consumer: str = "storage") -> int:
        """Bytes this log still retains for one consumer's tag — the
        per-storage write-queue depth (the reference's storage queue =
        bytesInput - bytesDurable, measured here at the log because the
        sim storage applies synchronously once it pulls). Spilled
        versions count at the estimate used when they were spilled."""
        mark = self._popped.get(consumer, {}).get(tag, 0)
        n = sum(
            _mut_bytes(m)
            for v, msgs in self._messages.get(tag, [])
            if v > mark
            for m in msgs
        )
        # spilled entries carry no byte estimate; charge a flat floor
        # per spilled VERSION entry so the backlog never reads as zero
        n += 32 * sum(
            1 for v, _seq in self._spilled.get(tag, []) if v > mark
        )
        return n

    def lock(self, epoch: int, recovery_version: int = None) -> None:
        """Recovery locks the log to a new generation: pushes from older
        epochs fail from here on (the coordinated-state lock step). When
        the new generation's recovery version is known, the log version
        jumps to it (lastEpochEnd completion) so the first new-epoch push
        (prev_version == recovery_version) can chain."""
        self.epoch = max(self.epoch, epoch)
        if recovery_version is not None and recovery_version > self.version.get():
            self.version.set(recovery_version)

    async def commit(self, req: TLogCommitRequest) -> int:
        """Append one version's messages; returns the durable version."""
        from foundationdb_tpu_torch.utils import commit_debug as _cd
        from foundationdb_tpu_torch.utils import trace as _trace

        if req.epoch < self.epoch:
            raise TLogStoppedError(f"epoch {req.epoch} < locked {self.epoch}")
        if req.debug_id is not None:
            _trace.g_trace_batch.add_event(
                "CommitDebug", req.debug_id, _cd.TLOG_BEFORE_WAIT
            )
        await self.version.when_at_least(req.prev_version)
        if req.epoch < self.epoch:  # may have been locked while waiting
            raise TLogStoppedError(f"epoch {req.epoch} < locked {self.epoch}")
        if self.version.get() >= req.version:
            return self.version.get()  # duplicate (already durable)
        if self.dq is not None:
            # write-ahead + "fsync" BEFORE the in-memory apply: the ack
            # this commit produces must imply durability (the DiskQueue
            # commit-before-ack contract)
            import pickle

            seq = self.dq.push(
                pickle.dumps((req.prev_version, req.version, req.messages))
            )
            self.dq.commit()
            self._seq_of_version.append((req.version, seq))
        for tag, msgs in req.messages.items():
            self._messages.setdefault(tag, []).append((req.version, msgs))
            self._mem_mutations += len(msgs)
            nb = sum(_mut_bytes(m) for m in msgs)
            self._mem_bytes += nb
            self.smoothed_input_bytes.add_delta(nb)
        self.smoothed_queue_bytes.set_total(self._mem_bytes)
        self.version.set(req.version)
        if req.debug_id is not None:
            _trace.g_trace_batch.add_event(
                "CommitDebug", req.debug_id, _cd.TLOG_AFTER_COMMIT
            )
        self._maybe_spill()
        return req.version

    def _maybe_spill(self) -> None:
        """Evict the oldest unpopped versions from memory once the
        retained-mutation budget is exceeded; their DiskQueue records
        (already durable — commit fsyncs before the in-memory apply)
        become the backing store, indexed per tag."""
        from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS
        from foundationdb_tpu_torch.utils.probes import code_probe

        budget = SERVER_KNOBS.TLOG_SPILL_THRESHOLD
        if self.dq is None or self._mem_mutations <= budget:
            return
        seq_of = dict(self._seq_of_version)
        # Pick the eviction set FIRST (oldest versions until back under
        # budget), then partition each tag's list in ONE pass — the
        # per-version rescan of every tag was quadratic in backlog under
        # the sim's randomized small thresholds.
        ver_sizes: dict[int, int] = {}
        for entries in self._messages.values():
            for v, msgs in entries:
                ver_sizes[v] = ver_sizes.get(v, 0) + len(msgs)
        evict: set[int] = set()
        mem = self._mem_mutations
        for v in sorted(ver_sizes):
            if mem <= budget:
                break
            if v not in seq_of:
                continue  # not individually addressable — keep in memory
            evict.add(v)
            mem -= ver_sizes[v]
        if not evict:
            return
        code_probe(True, "tlog.spill")
        for tag in list(self._messages):
            kept = []
            for ev, msgs in self._messages[tag]:
                if ev in evict:
                    self._spilled.setdefault(tag, []).append(
                        (ev, seq_of[ev])
                    )
                    self._mem_mutations -= len(msgs)
                    self._mem_bytes -= sum(_mut_bytes(m) for m in msgs)
                else:
                    kept.append((ev, msgs))
            self._messages[tag] = kept
        self.smoothed_queue_bytes.set_total(self._mem_bytes)

    def _entries_for(self, tag: Tag, after_version: int):
        """Merged (version, msgs) view of a tag: spilled versions read
        back off the DiskQueue + in-memory tail, version-ascending."""
        import pickle

        from foundationdb_tpu_torch.utils.probes import code_probe

        out = []
        for v, seq in self._spilled.get(tag, []):
            if v > after_version:
                code_probe(True, "tlog.peek_from_spill")
                _prev, _v, messages = pickle.loads(self.dq.read(seq))
                out.append((v, messages.get(tag, [])))
        out.extend(
            (v, msgs)
            for v, msgs in self._messages.get(tag, [])
            if v > after_version
        )
        out.sort(key=lambda e: e[0])
        return out

    async def peek(self, tag: Tag, after_version: int):
        """Messages for `tag` with version > after_version; waits until the
        log has advanced past after_version (peek cursor contract).
        Spilled versions are read back off the DiskQueue transparently
        (peekMessagesFromDisk)."""
        await self.version.when_at_least(after_version + 1)
        return self._entries_for(tag, after_version), self.version.get()

    def register_consumer(self, name: str) -> None:
        """Retain messages for an extra consumer from this point on."""
        self._popped.setdefault(name, {})

    def register_tag_mirror(self, tag: Tag, name: str) -> None:
        """A TSS pair: `name` reads `tag` like a storage server with an
        independent pop cursor (design/tss.md)."""
        self._tag_mirrors.setdefault(tag, set()).add(name)
        self._popped.setdefault(name, {})

    def unregister_tag_mirror(self, tag: Tag, name: str) -> None:
        """A dead TSS must release its cursor, or its frozen pop mark
        pins the pair's tag retention forever."""
        mirrors = self._tag_mirrors.get(tag)
        if mirrors is not None:
            mirrors.discard(name)
            if not mirrors:
                del self._tag_mirrors[tag]
        self._popped.pop(name, None)
        self._trim(tag)

    def has_log_consumers(self) -> bool:
        """Any non-storage STREAM consumer registered (proxies emit the
        full-stream tag only when someone will read it)? TSS mirrors
        read storage tags only — counting them would make proxies emit
        a stream nothing pops (unbounded growth)."""
        mirror_names = set().union(
            *self._tag_mirrors.values()
        ) if self._tag_mirrors else set()
        return any(
            name != "storage" and name not in mirror_names
            for name in self._popped
        )

    def unregister_consumer(self, name: str) -> None:
        if name != "storage":
            self._popped.pop(name, None)
            for tag in list(self._messages):
                self._trim(tag)

    def pop(self, tag: Tag, up_to_version: int, consumer: str = "storage") -> None:
        """Mark `consumer` done with tag messages <= up_to_version; discard
        what every consumer has popped."""
        marks = self._popped.setdefault(consumer, {})
        marks[tag] = max(marks.get(tag, 0), up_to_version)
        self._trim(tag)
        self._physical_pop()

    def _physical_pop(self) -> None:
        """Discard disk records every consumer is done with: translate
        the min per-tag version floor to a queue sequence number."""
        if self.dq is None or not self._seq_of_version:
            return
        floors = [
            self._popped["storage"].get(tag, 0)
            for tag in set(self._messages) | set(self._spilled)
            if tag != LOG_STREAM_TAG
        ]
        for name, marks in self._popped.items():
            if name != "storage":
                floors.append(min(marks.values()) if marks else 0)
        if not floors:
            return
        floor_v = min(floors)
        last_seq = None
        for v, seq in self._seq_of_version:
            if v <= floor_v:
                last_seq = seq
            else:
                break
        if last_seq is not None:
            # pops are advisory and ride un-fsynced (the reference
            # piggybacks pop locations on the push stream): a crash may
            # lose them, and recovery then replays already-popped
            # records — storage dedups by version, so this is safe AND
            # it gives the ensemble a real lost-unsynced-write path
            self.dq.pop(last_seq + 1)
            self._seq_of_version = [
                (v, s) for v, s in self._seq_of_version if v > floor_v
            ]

    def restore_from_disk(self) -> None:
        """The recovery scan: rebuild state from the durable queue after
        a crash (records above the popped floor, version-ascending)."""
        import pickle

        from foundationdb_tpu_torch.utils.probes import code_probe

        code_probe(True, "tlog.diskqueue_recovery")
        assert self.dq is not None
        self._messages = {}
        self._spilled = {}
        self._mem_mutations = 0
        self._mem_bytes = 0
        self._seq_of_version = []
        last_version = 0
        for seq, blob in self.dq.recovered:
            _prev, v, messages = pickle.loads(blob)
            if v <= last_version:
                continue  # duplicate record
            for tag, msgs in messages.items():
                self._messages.setdefault(tag, []).append((v, msgs))
                self._mem_mutations += len(msgs)
                self._mem_bytes += sum(_mut_bytes(m) for m in msgs)
            self._seq_of_version.append((v, seq))
            last_version = v
        self.smoothed_queue_bytes.set_total(self._mem_bytes)
        self._maybe_spill()  # a big recovered tail re-spills immediately
        if last_version > self.version.get():
            self.version.set(last_version)

    def catch_up_from(self, peer: "TLog") -> None:
        """Copy versions the peer has above ours (the rebooted replica
        missed pushes while dead; in the reference the new generation's
        logs recover the old generation's tail the same way). The copied
        versions are written through OUR durable queue too — otherwise a
        second crash would lose acked versions the first recovery only
        held in memory."""
        import pickle

        my_v = self.version.get()
        copied: dict[int, dict] = {}
        # the peer's merged view: spilled versions come back off its
        # DiskQueue (a catch-up must not miss what the peer evicted)
        for tag in set(peer._messages) | set(peer._spilled):
            for v, msgs in peer._entries_for(tag, my_v):
                self._messages.setdefault(tag, []).append((v, msgs))
                self._mem_mutations += len(msgs)
                self._mem_bytes += sum(_mut_bytes(m) for m in msgs)
                copied.setdefault(v, {})[tag] = msgs
        for tag in self._messages:
            self._messages[tag].sort(key=lambda e: e[0])
        if self.dq is not None:
            for v in sorted(copied):
                seq = self.dq.push(pickle.dumps((my_v, v, copied[v])))
                self._seq_of_version.append((v, seq))
            self._seq_of_version.sort(key=lambda e: e[0])
            self.dq.commit()
        if peer.version.get() > self.version.get():
            self.version.set(peer.version.get())
        self.epoch = peer.epoch
        # adopt the peer's pop bookkeeping (ours died with the process)
        self._popped = {
            n: dict(m) for n, m in peer._popped.items()
        }
        self.smoothed_queue_bytes.set_total(self._mem_bytes)
        self._maybe_spill()  # the copied tail respects the memory budget

    def _trim(self, tag: Tag) -> None:
        if tag == LOG_STREAM_TAG:
            # storage never pops the full stream; only backup/DR
            # consumers constrain it — none registered = drop everything
            # (TSS mirrors read storage tags only, never the stream)
            mirror_names = set().union(
                *self._tag_mirrors.values()
            ) if self._tag_mirrors else set()
            extras = [
                m for n, m in self._popped.items()
                if n != "storage" and n not in mirror_names
            ]
            if not extras:
                self._mem_mutations -= sum(
                    len(m) for _v, m in self._messages.get(tag, [])
                )
                self._mem_bytes -= sum(
                    _mut_bytes(m)
                    for _v, ms in self._messages.get(tag, [])
                    for m in ms
                )
                self._messages[tag] = []
                self._spilled.pop(tag, None)
                self.smoothed_queue_bytes.set_total(self._mem_bytes)
                return
            floor = min(m.get(tag, 0) for m in extras)
        else:
            # per-storage tags are governed by storage ALONE (stream
            # consumers read only LOG_STREAM_TAG, and letting their
            # never-popped marks pin storage tags would leak the whole
            # log for the lifetime of a backup/DR relationship) — plus
            # any TSS mirror of the tag: the pair's SLOWEST cursor
            floor = self._popped["storage"].get(tag, 0)
            for m in self._tag_mirrors.get(tag, ()):
                floor = min(floor, self._popped.get(m, {}).get(tag, 0))
        dropped = [
            (v, m) for v, m in self._messages.get(tag, []) if v <= floor
        ]
        self._mem_mutations -= sum(len(m) for _v, m in dropped)
        self._mem_bytes -= sum(
            _mut_bytes(m) for _v, ms in dropped for m in ms
        )
        self.smoothed_queue_bytes.set_total(self._mem_bytes)
        self._messages[tag] = [
            (v, m) for v, m in self._messages.get(tag, []) if v > floor
        ]
        if tag in self._spilled:
            self._spilled[tag] = [
                (v, s) for v, s in self._spilled[tag] if v > floor
            ]
