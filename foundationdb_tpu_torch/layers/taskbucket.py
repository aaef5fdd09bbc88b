"""TaskBucket: a persistent task queue inside the keyspace.

Behavioral mirror of fdbclient/TaskBucket.actor.cpp — the work-queue
primitive the reference's backup/DR agents are built on: tasks are
key-value records under a bucket subspace; executors atomically CLAIM a
task by moving it from `available/` to `timeouts/` with a lease
deadline, extend the lease while working, and remove the task on
finish. A crashed executor simply stops extending; anyone's next
`check_timeouts` sweep moves its expired tasks back to `available/`, so
work is never lost and never runs concurrently while a lease is live.

FutureBucket dependencies ride the same keyspace: `add(after=...)`
parks a task under `blocked/<future>/`; `finish` unblocks every task
parked on the finished task's key (TaskBucket's OnDone/FutureBucket
pattern collapsed to its keyspace essence).

All moves are single transactions against the normal commit path, so
claim races between concurrent executors are resolved by the resolver
(exactly one CLAIM commits; the loser retries) — the same correctness
argument as the reference's (TaskBucket.actor.cpp:getOne).

The port's own copy of foundationdb_tpu.layers.taskbucket.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from foundationdb_tpu_torch.utils.probes import code_probe, declare

declare(
    "taskbucket.claim_raced",
    "taskbucket.lease_expired_requeued",
    "taskbucket.unblocked",
)


@dataclasses.dataclass
class Task:
    key: bytes            # unique task id within the bucket
    params: dict          # str -> str payload
    lease_deadline: float = 0.0


def _enc(params: dict) -> bytes:
    return repr(sorted(params.items())).encode()


def _dec(raw: bytes) -> dict:
    import ast

    return dict(ast.literal_eval(raw.decode()))


class TaskBucket:
    """One bucket = one prefix in the keyspace (a directory subspace in
    the reference; a plain prefix here)."""

    #: seconds an executor owns a claimed task before it may be requeued
    LEASE = 2.0

    def __init__(self, db, prefix: bytes = b"tb/"):
        self.db = db
        self.prefix = prefix
        self._avail = prefix + b"available/"
        self._timeout = prefix + b"timeouts/"
        self._blocked = prefix + b"blocked/"
        # liveness registry: all/<key> exists from add() until finish().
        # Parent-liveness checks read exactly ONE key — scanning the
        # available/timeouts/blocked namespaces would (a) miss parked
        # parents, (b) false-match slash-ambiguous claimed keys, and
        # (c) conflict with every concurrent claim.
        self._all = prefix + b"all/"

    # -- producer --------------------------------------------------------

    def _blocked_prefix(self, after: bytes) -> bytes:
        # length-prefixed parent key: task keys may contain b"/", so a
        # plain separator would let finish(b"a") release tasks parked on
        # b"a/b" (with corrupted child keys to boot)
        return self._blocked + b"%08d/" % len(after) + after + b"/"

    async def add(self, key: bytes, params: dict,
                  after: Optional[bytes] = None) -> None:
        """Enqueue a task. With `after`, the task stays parked until the
        task with that key finishes (FutureBucket dependency). A parent
        that is not present anywhere in the bucket counts as already
        finished (the reference FutureBucket's isSet check): the task
        enqueues immediately instead of parking forever."""
        from foundationdb_tpu_torch.cluster.commit_proxy import NotCommitted

        while True:
            txn = self.db.create_transaction()
            txn.set(self._all + key, b"\x01")
            if after is not None and (
                await txn.get(self._all + after) is not None
            ):
                # the read of all/<after> conflicts with the parent's
                # finish(), so a parent finishing concurrently aborts
                # this park and the retry enqueues directly
                txn.set(self._blocked_prefix(after) + key, _enc(params))
            else:
                txn.set(self._avail + key, _enc(params))
            try:
                await txn.commit()
                return
            except NotCommitted:
                continue

    # -- executor --------------------------------------------------------

    async def get_one(self) -> Optional[Task]:
        """Claim the first available task: move available/ ->
        timeouts/<deadline>/ in one transaction. Returns None when the
        bucket has nothing available. A concurrent claimer conflicts on
        the task key and retries (the resolver arbitrates)."""
        from foundationdb_tpu_torch.cluster.commit_proxy import NotCommitted

        while True:
            txn = self.db.create_transaction()
            items = await txn.get_range(
                self._avail, self._avail + b"\xff", limit=1
            )
            if not items:
                return None
            k, raw = items[0]
            key = k[len(self._avail):]
            deadline = self.db.sched.now() + self.LEASE
            txn.clear(k)
            txn.set(
                self._timeout + b"%020d/" % int(deadline * 1e6) + key, raw
            )
            try:
                await txn.commit()
            except NotCommitted:
                code_probe(True, "taskbucket.claim_raced")
                continue  # another executor claimed it; take the next
            return Task(key, _dec(raw), deadline)

    def _timeout_key(self, task: Task) -> bytes:
        return (
            self._timeout + b"%020d/" % int(task.lease_deadline * 1e6)
            + task.key
        )

    async def extend(self, task: Task) -> None:
        """Push the lease deadline out (the executor's keep-alive)."""
        txn = self.db.create_transaction()
        old = self._timeout_key(task)
        raw = await txn.get(old)
        if raw is None:
            raise KeyError(f"lease lost for {task.key!r}")
        task.lease_deadline = self.db.sched.now() + self.LEASE
        txn.clear(old)
        txn.set(self._timeout_key(task), raw)
        await txn.commit()

    async def finish(self, task: Task) -> None:
        """Complete: remove the task and release anything parked on it.

        Verifies the lease is still HELD first: a stale executor whose
        task was requeued and re-claimed must not mark it done (and must
        not release dependents under the new owner's feet) — it gets a
        KeyError, like extend."""
        from foundationdb_tpu_torch.cluster.commit_proxy import NotCommitted

        while True:
            txn = self.db.create_transaction()
            tk = self._timeout_key(task)
            if await txn.get(tk) is None:
                raise KeyError(f"lease lost for {task.key!r}")
            txn.clear(tk)
            txn.clear(self._all + task.key)
            pfx = self._blocked_prefix(task.key)
            parked = await txn.get_range(pfx, pfx + b"\xff")
            for k, raw in parked:
                txn.clear(k)
                txn.set(self._avail + k[len(pfx):], raw)
                code_probe(True, "taskbucket.unblocked")
            try:
                await txn.commit()
                return
            except NotCommitted:
                continue  # raced a concurrent add()'s park; re-read

    # -- maintenance -----------------------------------------------------

    async def check_timeouts(self) -> int:
        """Requeue every task whose lease expired (run by ANY executor,
        like the reference's checkTimeouts sweep). Returns the count."""
        from foundationdb_tpu_torch.cluster.commit_proxy import NotCommitted

        now_us = int(self.db.sched.now() * 1e6)
        txn = self.db.create_transaction()
        expired = await txn.get_range(
            self._timeout, self._timeout + b"%020d" % now_us
        )
        for k, raw in expired:
            # timeouts/<20-digit-deadline>/<key> — key may contain "/"
            key = k[len(self._timeout):].split(b"/", 1)[1]
            txn.clear(k)
            txn.set(self._avail + key, raw)
            code_probe(True, "taskbucket.lease_expired_requeued")
        if expired:
            try:
                await txn.commit()
            except NotCommitted:
                return 0  # a concurrent sweep (any executor may run one)
                #           won the race; its commit did the requeue
        return len(expired)

    async def is_empty(self) -> bool:
        txn = self.db.create_transaction()
        for pfx in (self._avail, self._timeout, self._blocked):
            if await txn.get_range(pfx, pfx + b"\xff", limit=1):
                return False
        return True

    async def task_exists(self, key: bytes) -> bool:
        """True while `key` is anywhere in the bucket (the all/
        registry: add() -> finish() lifetime)."""
        txn = self.db.create_transaction()
        return await txn.get(self._all + key) is not None
