"""DR: continuous replication into a second cluster + switchover.

The role of `fdbclient/DatabaseBackupAgent.actor.cpp` (fdbdr): an agent
pulls the primary's mutation log and applies it to a DESTINATION cluster
through ordinary transactions, keeping the destination a slightly-lagged
copy. The destination stays locked against client writes while DR runs
(applying a log onto a diverging database would corrupt both); on
switchover the agent drains to the primary's final version, verifies,
and unlocks the destination — which then takes over as the primary.

Mechanics here:

* The agent registers as a tlog consumer on the source (same peek/pop
  protocol the backup worker and storage servers use) and applies each
  version's mutations to the destination inside one transaction.
* The applied watermark is committed WITH each apply batch at
  `\\xff/dr/applied` on the destination — apply+watermark are atomic, so
  a restarted agent resumes exactly where the destination really is
  (the reference's logVersion/applyMutations bookkeeping).
* `lock()` / `unlock()` write `\\xff/dr/locked` on the destination and
  the client layer refuses ordinary commits while it is set (the
  reference's databaseLocked machinery, fdbclient/NativeAPI commit
  checks against `\\xff/dbLocked`).

The port's own copy of foundationdb_tpu.cluster.dr.
"""

from __future__ import annotations

from typing import Optional

from foundationdb_tpu_torch.runtime.flow import ActorCancelled
from foundationdb_tpu_torch.utils.trace import TraceEvent

LOCK_KEY = b"\xff/dr/locked"
APPLIED_KEY = b"\xff/dr/applied"


from foundationdb_tpu_torch.cluster.commit_proxy import DatabaseLockedError


class DestinationLockedError(DatabaseLockedError):
    """Client writes are refused while DR owns the destination (a
    DatabaseLockedError subclass: one logical condition, one catchable
    type regardless of which layer refused)."""


class DrAgent:
    """Continuous source->destination replication (fdbdr's agent)."""

    def __init__(self, src_cluster, src_db, dst_db, *, name: str = "dr"):
        self.src = src_cluster
        self.src_db = src_db
        self.dst = dst_db
        self.name = name
        self.applied_version = 0   # last version applied WITH data
        self.caught_up_version = 0  # source log position fully consumed
        self._task = None
        self._error: Exception | None = None

    # -- destination lock (databaseLocked semantics) ---------------------

    async def lock_destination(self) -> None:
        t = self.dst.create_transaction()
        t.dr_bypass = True  # idempotent re-lock must not block itself
        t.set(LOCK_KEY, self.name.encode())
        await t.commit()
        self.dst.dr_locked = True

    async def unlock_destination(self) -> None:
        t = self.dst.create_transaction()
        t.dr_bypass = True  # the unlock write itself rides the lock
        t.clear(LOCK_KEY)
        await t.commit()
        self.dst.dr_locked = False

    # -- the replication loop --------------------------------------------

    async def start(self) -> None:
        """Lock the destination, snapshot pre-existing source data, then
        tail the source log from the snapshot version.

        Registration precedes the snapshot, so every mutation after the
        snapshot's read version is retained in the log; the tail starts
        strictly above the snapshot version, so nothing is applied twice
        (atomics are not idempotent). A fresh agent over an already-
        primed destination resumes from its durable watermark instead.
        """
        from foundationdb_tpu_torch.cluster.tlog import LOG_STREAM_TAG

        await self.lock_destination()
        sched = self.src.sched
        tlog = self.src.tlog
        tlog.register_consumer(self.name)

        t = self.dst.create_transaction()
        applied = await t.get(APPLIED_KEY)
        if applied is not None:
            self.applied_version = int(applied)
        else:
            # initial snapshot: pre-start source data is not in the log
            # (storage already consumed it) — copy it, then tail above
            # the snapshot's read version (FileBackupAgent's range
            # snapshot + log semantics compressed to one pass)
            ts = self.src_db.create_transaction()
            rv = await ts.get_read_version()
            data = await ts.get_range(b"", b"\xff")
            td = self.dst.create_transaction()
            td.dr_bypass = True
            # The copy must start from an empty destination: any
            # pre-existing destination key absent on the source would
            # survive a bare set-loop and silently diverge the replica
            # (the reference verifies an empty destination before
            # priming).
            td.clear_range(b"", b"\xff")
            for k, v in data:
                td.set(k, v)
            td.set(APPLIED_KEY, str(rv).encode())
            await td.commit()
            self.applied_version = rv
        self.caught_up_version = self.applied_version

        async def pull():
            try:
                after = self.applied_version
                while True:
                    got, log_version = await tlog.peek(LOG_STREAM_TAG, after)
                    entries = {v: msgs for v, msgs in got if msgs}
                    for v in sorted(entries):
                        await self._apply_one(v, entries[v])
                    after = max(log_version, max(entries, default=0))
                    # versions without mutations (empty commits) advance
                    # the caught-up watermark without an apply
                    self.caught_up_version = after
                    tlog.pop(LOG_STREAM_TAG, after, consumer=self.name)
                    await tlog.version.when_at_least(after + 1)
            except ActorCancelled:
                raise
            except Exception as e:
                # surface apply failures: drain_to re-raises instead of
                # spinning forever on a dead agent
                self._error = e
                raise

        self._task = sched.spawn(pull(), name=f"{self.name}-agent")

    async def _apply_one(self, version: int, mutations: list) -> None:
        """One source version -> one destination transaction (mutations +
        watermark together, so resume is exact)."""
        t = self.dst.create_transaction()
        t.dr_bypass = True  # the agent itself may write while locked
        for m in mutations:
            kind = m[0]
            if kind == "set":
                t.set(m[1], m[2])
            elif kind == "clear":
                t.clear_range(m[1], m[2])
            elif kind == "atomic":
                t.atomic_op(m[1], m[2], m[3])
            # vs_key/vs_value arrive already transformed by the source
        t.set(APPLIED_KEY, str(version).encode())
        await t.commit()
        self.applied_version = version

    async def drain_to(self, version: int) -> None:
        """Wait until everything at or below `version` is consumed (data
        versions applied; empty versions just advance the watermark).
        Raises if the agent task died."""
        while self.caught_up_version < version:
            if self._error is not None:
                raise self._error
            await self.src.sched.delay(0.01)

    async def switchover(self) -> int:
        """LOCK THE SOURCE, drain to its final version, then hand the
        destination over (unlock) — the reference's atomic switchover
        order. Commits racing the lock either land before it (drained)
        or fail database_locked; nothing acknowledged is lost. The
        retired source stays locked.
        """
        tl = self.src_db.create_transaction()
        tl.dr_bypass = True
        tl.set(LOCK_KEY, (self.name + "-switchover").encode())
        await tl.commit()
        # pipelined batches admitted before the lock became visible can
        # still commit ABOVE the lock version; one lock-aware sentinel
        # PINNED to every proxy serializes behind them (per-proxy batch
        # chains), so everything acknowledged lands at/below the final
        # version we drain to. Pinning, not round-robin adjacency:
        # concurrent traffic advances the shared pointer, so counting
        # commits does not fence every proxy (the same defect class
        # backup's stream barrier guards against)
        for proxy in list(self.src.commit_proxies):
            sent = self.src_db.create_transaction()
            sent.dr_bypass = True
            sent.set(LOCK_KEY + b"/fence", b"1")
            sent._pin_proxy = proxy
            await sent.commit()
        final = self.src.tlog.version.get()
        await self.drain_to(final)
        self.abandon()
        await self.unlock_destination()
        TraceEvent("DrSwitchover").detail("Version", final).log()
        return final

    def stop(self) -> None:
        """Pause the agent. The tlog consumer registration STAYS: the
        source keeps retaining the log tail for this DR relationship (a
        crashed agent must not lose data either — the reference persists
        the DR pop watermark the same way). A restarted agent resumes
        from the destination's durable watermark.
        """
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def abandon(self) -> None:
        """Tear the DR relationship down permanently: the source stops
        retaining log for it (post-switchover, or operator abort)."""
        self.stop()
        self.src.tlog.unregister_consumer(self.name)
