"""SimDiskQueue: the native DiskQueue's contract over an in-memory "disk".

The reference simulates its whole disk stack (fdbrpc/sim2.actor.cpp
simulated files + fdbrpc/AsyncFileNonDurable.actor.h) precisely so fault
injection reaches the durability code in every simulation seed. This is
that discipline for our DiskQueue (native/diskqueue.cpp): one
abstraction, two backends — roles in simulation write through this
class, and seeds can crash it with un-fsynced data loss and torn tails.

Contract (mirrors native.DiskQueue):
  push(bytes) -> seq     buffered; NOT durable until commit()
  commit() -> last seq   "fsync": everything pushed becomes durable
  pop(seq)               records below seq may be discarded
  recovered              committed, un-popped records after recovery

Fault injection (AsyncFileNonDurable semantics — un-fsynced writes may
be partially on "disk" in any prefix when the process dies):
  crash(rng)             simulate power loss: a random prefix of the
                         un-fsynced buffer survives whole, the next
                         record may land TORN (a corrupt partial frame
                         physically on disk), the rest vanishes. The
                         subsequent recovery scan must detect the torn
                         frame and truncate it — the same scan the
                         native queue runs (native/diskqueue.cpp
                         scanFile/recover).

The port's own copy of foundationdb_tpu.sim.diskqueue.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class _Record:
    seq: int
    is_pop: bool
    pop_to: int
    data: bytes
    corrupt: bool = False  # torn partial frame (invalid checksum)


class SimDiskQueue:
    def __init__(self):
        # "disk": committed (fsynced) framed records, in push order —
        # possibly ending in a torn (corrupt) frame after a crash until
        # the recovery scan truncates it
        self._disk: list[_Record] = []
        # buffered, not yet fsynced
        self._buffer: list[_Record] = []
        self._next_seq = 0
        self._pop_floor = 0
        # seq -> data cache for read(); invalidated whenever _disk changes
        self._by_seq: dict | None = None

    # -- the DiskQueue API -------------------------------------------------

    def push(self, data: bytes) -> int:
        seq = self._next_seq
        self._next_seq += 1
        self._buffer.append(_Record(seq, False, 0, bytes(data)))
        return seq

    def pop(self, up_to_seq: int) -> None:
        if up_to_seq <= self._pop_floor:
            return
        self._pop_floor = up_to_seq
        seq = self._next_seq
        self._next_seq += 1
        self._buffer.append(_Record(seq, True, up_to_seq, b""))

    def commit(self) -> int:
        """fsync: buffered records become durable; returns last seq."""
        self._disk.extend(self._buffer)
        self._buffer = []
        self._compact()
        self._by_seq = None
        return self._next_seq - 1 if self._next_seq else None

    def _compact(self) -> None:
        """Discard the popped prefix (as rotation would) and fold all
        pop records into one — without this, a long-running role's pop
        stream grows the 'file' and every scan over it, quadratically."""
        floor = self._durable_pop_floor()
        kept = [
            r for r in self._disk
            if not r.is_pop and (r.seq >= floor or r.corrupt)
        ]
        if floor:
            kept.insert(0, _Record(-1, True, floor, b""))
        self._disk = kept

    def _durable_pop_floor(self) -> int:
        floor = 0
        for r in self._disk:
            if r.is_pop and r.pop_to > floor:
                floor = r.pop_to
        return floor

    @property
    def recovered(self) -> list[tuple[int, bytes]]:
        """Committed, un-popped data records (the post-recovery view)."""
        assert not any(r.corrupt for r in self._disk), (
            "recovery scan (recover()) must run before reading a "
            "crashed queue"
        )
        floor = self._durable_pop_floor()
        return [
            (r.seq, r.data)
            for r in self._disk
            if not r.is_pop and r.seq >= floor
        ]

    def read(self, seq: int) -> bytes:
        """Random-access read of a committed record — the
        spill-by-reference peek path: a TLog that evicted a version from
        memory reads it back off the queue (the reference's
        DiskQueueAdapter reads for spilled tag peeks,
        fdbserver/TLogServer.actor.cpp peekMessagesFromDisk). Indexed:
        a lagging follower re-peeks its spilled tail every tick, and a
        linear scan made that quadratic in backlog."""
        if self._by_seq is None:
            self._by_seq = {
                r.seq: r.data for r in self._disk if not r.is_pop
            }
        try:
            return self._by_seq[seq]
        except KeyError:
            raise KeyError(
                f"seq {seq} not on disk (popped or never committed)"
            ) from None

    @property
    def next_seq(self) -> int:
        return self._next_seq

    # -- fault injection ---------------------------------------------------

    def crash(self, rng=None) -> None:
        """Power loss, then the recovery scan.

        A random prefix of the un-fsynced buffer lands whole; the next
        record may land TORN — physically on disk as a corrupt partial
        frame that the recovery scan must detect (checksum failure in
        the native queue) and truncate away. Surviving un-acked records
        are allowed to surface (they were never acked either way); torn
        bytes must never surface.
        """
        if rng is not None and self._buffer:
            n_whole = int(rng.integers(0, len(self._buffer) + 1))
            survived = self._buffer[:n_whole]
            self._disk.extend(survived)
            if n_whole < len(self._buffer) and bool(rng.integers(0, 2)):
                from foundationdb_tpu_torch.utils.probes import code_probe

                code_probe(True, "simdisk.torn_tail")
                torn = self._buffer[n_whole]
                cut = int(rng.integers(0, max(1, len(torn.data))))
                self._disk.append(_Record(
                    torn.seq, torn.is_pop, torn.pop_to,
                    torn.data[:cut], corrupt=True,
                ))
        self._buffer = []
        self._by_seq = None
        self.recover()

    def recover(self) -> None:
        """The recovery scan: truncate the torn tail (an invalid frame
        ends recovery — only a plausible tail is ever dropped, matching
        the native policy), restore seq allocation and the pop floor."""
        self._by_seq = None
        while self._disk and self._disk[-1].corrupt:
            self._disk.pop()
        assert not any(r.corrupt for r in self._disk), (
            "corrupt frame mid-stream: interior corruption is not a "
            "torn tail (the native queue refuses to open here)"
        )
        self._next_seq = (
            max((r.seq for r in self._disk), default=-1) + 1
        )
        self._pop_floor = self._durable_pop_floor()
