"""Client API: Database / Transaction with read-your-writes.

Behavioral mirror of the reference client stack:

* `Transaction` (fdbclient/NativeAPI.actor.cpp): lazy GRV
  (getReadVersion -> GRV proxy batch), reads routed to the storage shard
  owning the key, commit via a commit proxy, retry loop with backoff
  (`on_error`).
* Read-your-writes (fdbclient/ReadYourWrites.actor.cpp / WriteMap.h):
  uncommitted writes overlay reads — a `get` of a key this txn set
  returns the new value without adding phantom conflicts; range reads
  merge the write map over the storage snapshot.
* Conflict ranges (fdbclient/RYWIterator.cpp semantics): point reads add
  [k, k+\\x00) read conflicts; range reads add [begin, end); sets add
  point write conflicts; clears add range write conflicts — matching
  CommitTransactionRef's contract (fdbclient/CommitTransaction.h).

The port's own copy of foundationdb_tpu.cluster.client.
"""

from __future__ import annotations

import bisect
from typing import Optional

from foundationdb_tpu_torch.cluster.commit_proxy import (
    CommitUnknownResult,
    NotCommitted,
    TransactionTooOldError,
)
from foundationdb_tpu_torch.cluster.grv_proxy import (
    GrvProxyFailedError,
    GrvThrottledError,
)
from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.utils import commit_debug as _cd
from foundationdb_tpu_torch.utils import trace as _trace


def key_after(k: bytes) -> bytes:
    return k + b"\x00"


class WriteMap:
    """Uncommitted writes: sorted clear ranges + point sets + pending
    atomics over unknown bases (WriteMap.h)."""

    def __init__(self):
        self.sets: dict[bytes, bytes] = {}
        self.clears: list[tuple[bytes, bytes]] = []  # disjoint, sorted
        # key -> [(op, param)] applied over the server value at read time
        self.atomics: dict[bytes, list] = {}

    def set(self, k: bytes, v: bytes) -> None:
        self.sets[k] = v
        self.atomics.pop(k, None)

    def clear(self, b: bytes, e: bytes) -> None:
        for k in [k for k in self.sets if b <= k < e]:
            del self.sets[k]
        for k in [k for k in self.atomics if b <= k < e]:
            del self.atomics[k]
        merged = [(b, e)]
        for cb, ce in self.clears:
            if ce < b or cb > e:  # disjoint (touching ranges merge)
                merged.append((cb, ce))
            else:
                merged[0] = (min(merged[0][0], cb), max(merged[0][1], ce))
        self.clears = sorted(merged)

    def lookup(self, k: bytes) -> tuple[bool, Optional[bytes]]:
        """(known, value): known=True if this txn wrote/cleared k."""
        if k in self.sets:
            return True, self.sets[k]
        for cb, ce in self.clears:
            if cb <= k < ce:
                return True, None
        return False, None

    def overlay(self, items: list[tuple[bytes, bytes]], b: bytes, e: bytes):
        """Merge the write map over a storage snapshot of [b, e)."""
        from foundationdb_tpu_torch.utils.atomic import apply_atomic

        out = {k: v for k, v in items}
        for cb, ce in self.clears:
            for k in [k for k in out if cb <= k < ce]:
                del out[k]
        for k, v in self.sets.items():
            if b <= k < e:
                out[k] = v
        for k, ops in self.atomics.items():
            if b <= k < e:
                v = out.get(k)
                for op, param in ops:
                    v = apply_atomic(op, v, param)
                if v is None:
                    out.pop(k, None)
                else:
                    out[k] = v
        return sorted(out.items())


class Transaction:
    def __init__(self, db: "Database", tag: str = None):
        self.db = db
        #: optional transaction tag: GRV requests carrying it are metered
        #: against the Ratekeeper's per-tag quota (tag throttling)
        self.tag = tag
        self._read_version: Optional[int] = None
        # in-flight GRV request (prefetch_read_version): issued without
        # awaiting so read-set building overlaps the GRV batch roundtrip
        self._grv_promise = None
        self._grv_span = None
        self.writes = WriteMap()
        self.mutations: list = []
        self.read_conflicts: list[tuple[bytes, bytes]] = []
        self.write_conflicts: list[tuple[bytes, bytes]] = []
        self.report_conflicting_keys = False
        self.committed_version: Optional[int] = None
        self._versionstamp: Optional[bytes] = None
        self.idempotency_id: Optional[bytes] = None
        # set by the DR agent: its own applies may write while the
        # database is DR-locked (cluster/dr.py)
        self.dr_bypass = False
        # Commit-path telemetry (the reference's debugTransaction): with
        # db.tracing on, every transaction carries a DETERMINISTIC debug
        # id — (origin, client, seq), the idempotency-nonce discipline —
        # and emits the NativeAPI.* trace_batch micro-events the
        # commit_debug reconstructor joins on.
        self.debug_id: Optional[str] = db.next_debug_id() if db.tracing else None

    # -- reads ------------------------------------------------------------

    def prefetch_read_version(self) -> None:
        """Issue the GRV request NOW without awaiting it — the client-
        side GRV/read-set overlap (the reference NativeAPI's eager
        readVersionFuture): the request joins the GRV proxy's current
        batch while the caller keeps building its read set / RYW
        overlay, and the first read awaits the in-flight reply instead
        of paying the whole GRV roundtrip serially. Idempotent; a
        no-op once a read version is pinned."""
        if self._read_version is not None or self._grv_promise is not None:
            return
        gspan = None
        if self.debug_id is not None:
            # span-threaded GRV: the span opens when it is sent so the
            # waterfall shows the overlapped window, and finishes when
            # the reply is consumed (get_read_version)
            from foundationdb_tpu_torch.utils.spans import Span

            gspan = Span(
                "NativeAPI.getConsistentReadVersion",
                clock=self.db.sched.now,
            )
            _trace.g_trace_batch.add_event(
                "TransactionDebug", self.debug_id, _cd.GRV_BEFORE
            )
        p = self.db.grv_proxy.get_read_version(self.tag)
        if self.debug_id is not None:
            p.debug_id = self.debug_id  # rides to the batcher
            p.span_ctx = gspan.context
        self._grv_promise = p
        self._grv_span = gspan

    async def get_read_version(self) -> int:
        if self._read_version is None:
            self.prefetch_read_version()
            # ownership transfer, not a snapshot: the in-flight promise
            # and its span are POPPED before the await precisely so no
            # concurrent consumer can double-await them; the fields are
            # deliberately not re-read after the wait.
            p, self._grv_promise = self._grv_promise, None
            gspan, self._grv_span = self._grv_span, None  # flowcheck: ignore[flow.stale-read-across-wait]
            try:
                self._read_version = await p.future
                if self.debug_id is not None:
                    _trace.g_trace_batch.add_event(
                        "TransactionDebug", self.debug_id, _cd.GRV_AFTER
                    )
            finally:
                if gspan is not None:
                    gspan.finish()
        return self._read_version

    async def get(self, key: bytes, *, snapshot: bool = False) -> Optional[bytes]:
        if key.startswith(b"\xff\xff"):
            # the special key space: virtual management reads
            # (fdbclient/SpecialKeySpace.actor.cpp)
            return self.db.special_key(key)
        known, val = self.writes.lookup(key)
        if not known:
            rv = await self.get_read_version()
            val = await self.db.read_value(key, rv)
            if not snapshot:
                self.read_conflicts.append((key, key_after(key)))
        # RYW over atomics on an unknown base: apply pending ops to the
        # snapshot value (ReadYourWrites' read-modify view).
        from foundationdb_tpu_torch.utils.atomic import apply_atomic

        for op, param in self.writes.atomics.get(key, []):
            val = apply_atomic(op, val, param)
        return val

    @staticmethod
    def _clip_rows(rows, limit: int, reverse: bool):
        """Apply limit+reverse to a fully-materialized row list: a
        reverse scan walks from `end` downward, so the limit keeps the
        HIGHEST keys and they return in descending order
        (Transaction::getRange reverse semantics)."""
        if reverse:
            sel = rows[len(rows) - limit:] if limit < len(rows) else rows
            return list(reversed(sel))
        return rows[:limit]

    async def get_range(
        self, begin: bytes, end: bytes, *, limit: int = 1 << 30,
        snapshot: bool = False, reverse: bool = False,
    ) -> list[tuple[bytes, bytes]]:
        from foundationdb_tpu_torch.cluster import system_data as SD

        if limit <= 0:
            return []

        for mod_b, mod_e in (
            (SD.KEY_SERVERS_PREFIX, SD.KEY_SERVERS_END),
            (SD.SERVER_KEYS_PREFIX, SD.SERVER_KEYS_END),
        ):
            if begin < mod_e and mod_b < end and not (
                mod_b <= begin and end <= mod_e
            ):
                # module-bounds discipline (the reference's
                # SpecialKeySpace CROSS_MODULE_READ error): a scan may
                # not straddle a materialized schema module — silently
                # mixing schema rows with stored rows would drop data
                raise ValueError(
                    f"range [{begin!r}, {end!r}) crosses the "
                    f"materialized schema module [{mod_b!r}, {mod_e!r}); "
                    "query within the module bounds"
                )
        if begin.startswith(SD.KEY_SERVERS_PREFIX):
            # the shard-location schema (SystemData.cpp keyServersKeys):
            # materialized from the authoritative shard map
            strip = len(SD.KEY_SERVERS_PREFIX)
            rows = SD.materialize_key_servers(
                self.db.cluster.key_servers,
                begin[strip:],
                end[strip:] if end.startswith(SD.KEY_SERVERS_PREFIX)
                else b"\xff",
            )
            return self._clip_rows(rows, limit, reverse)
        if begin.startswith(SD.SERVER_KEYS_PREFIX):
            rows = SD.materialize_all_server_keys(
                self.db.cluster.key_servers
            )
            rows = [r for r in rows if begin <= r[0] < end]
            return self._clip_rows(rows, limit, reverse)
        rv = await self.get_read_version()
        items = await self.db.read_range(begin, end, rv)
        full = self.writes.overlay(items, begin, end)
        truncated = limit < len(full)
        merged = self._clip_rows(full, limit, reverse)
        if not snapshot:
            # The reference narrows the conflict range to the keys actually
            # read when a limit stops the scan early; with a full scan it is
            # [begin, end). A reverse scan walks from `end` downward, so
            # its observed window is [lowest returned key, end).
            if not truncated:
                self.read_conflicts.append((begin, end))
            elif reverse:
                self.read_conflicts.append((merged[-1][0], end))
            else:
                self.read_conflicts.append((begin, key_after(merged[-1][0])))
        return merged

    async def watch(self, key: bytes):
        """Watch `key`: returns a Future firing when its value changes from
        what this transaction observes (Transaction::watch semantics —
        registered against the owning storage server via the same
        network-wrapped endpoint as reads)."""
        value = await self.get(key, snapshot=True)
        return self.db.storage_for(key).watch(key, value)

    # -- writes -----------------------------------------------------------

    def set(self, key: bytes, value: bytes) -> None:
        self.writes.set(key, value)
        self.mutations.append(("set", key, value))
        self.write_conflicts.append((key, key_after(key)))

    def clear(self, key: bytes) -> None:
        self.clear_range(key, key_after(key))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        self.writes.clear(begin, end)
        self.mutations.append(("clear", begin, end))
        self.write_conflicts.append((begin, end))

    def atomic_op(self, op: str, key: bytes, param: bytes) -> None:
        """Atomic read-modify-write mutation (Transaction::atomicOp;
        MutationRef types — utils/atomic.py has the semantics)."""
        from foundationdb_tpu_torch.utils.atomic import ATOMIC_OPS, apply_atomic

        if op not in ATOMIC_OPS:
            raise ValueError(f"unknown atomic op {op!r}")
        known, val = self.writes.lookup(key)
        if known:
            new = apply_atomic(op, val, param)
            if new is None:
                self.writes.clear(key, key_after(key))
            else:
                self.writes.set(key, new)
        else:
            self.writes.atomics.setdefault(key, []).append((op, param))
        self.mutations.append(("atomic", op, key, param))
        self.write_conflicts.append((key, key_after(key)))

    def add(self, key: bytes, value: int, width: int = 8) -> None:
        """fdb's ADD convenience: little-endian integer add."""
        self.atomic_op("add", key, value.to_bytes(width, "little", signed=True))

    def add_read_conflict_range(self, begin: bytes, end: bytes) -> None:
        self.read_conflicts.append((begin, end))

    def add_write_conflict_range(self, begin: bytes, end: bytes) -> None:
        self.write_conflicts.append((begin, end))

    def set_versionstamped_key(
        self, prefix: bytes, suffix: bytes, value: bytes
    ) -> None:
        """SET_VERSIONSTAMPED_KEY: final key = prefix + 10-byte commit
        versionstamp + suffix, assigned at commit (MutationRef::
        SetVersionstampedKey)."""
        self.mutations.append(("vs_key", prefix, suffix, value))
        self.write_conflicts.append((prefix, prefix + b"\xff" * 11))

    def set_versionstamped_value(self, key: bytes, value_prefix: bytes) -> None:
        """SET_VERSIONSTAMPED_VALUE: value gets the stamp appended."""
        self.mutations.append(("vs_value", key, value_prefix))
        self.writes.atomics.pop(key, None)
        self.write_conflicts.append((key, key_after(key)))

    @property
    def versionstamp(self) -> Optional[bytes]:
        """The commit versionstamp (after a successful commit)."""
        return self._versionstamp

    def set_idempotency_id(self, ident: Optional[bytes] = None) -> bytes:
        """AUTOMATIC_IDEMPOTENCY (fdbclient/IdempotencyId.actor.cpp): the
        commit also records `\\xff/idmp/<id>`, so a retry after
        commit_unknown_result can detect that the first attempt really
        committed instead of applying twice. The default id is the
        Database's deterministic per-client nonce, never entropy — a
        simulated run replays the exact same ids (the flowcheck
        determinism contract)."""
        if ident is None:
            ident = self.db.next_idempotency_id()
        self.idempotency_id = ident
        return ident

    # -- commit -----------------------------------------------------------

    async def commit(self) -> int:
        if not self.mutations and not self.write_conflicts:
            # Read-only transactions commit client-side at the read version
            # (Transaction::commit fast path).
            self.committed_version = await self.get_read_version()
            return self.committed_version
        if getattr(self.db, "dr_locked", False) and not self.dr_bypass:
            # databaseLocked: a DR destination refuses ordinary commits
            # (the reference checks \xff/dbLocked on every commit)
            from foundationdb_tpu_torch.cluster.dr import DestinationLockedError

            raise DestinationLockedError(
                "database is a DR destination; writes are locked"
            )
        rv = await self.get_read_version()
        mutations = list(self.mutations)
        if self.idempotency_id is not None:
            mutations.append(
                ("set", b"\xff/idmp/" + self.idempotency_id, b"\x01")
            )
        ctr = CommitTransaction(
            read_conflict_ranges=_dedup(self.read_conflicts),
            write_conflict_ranges=_dedup(self.write_conflicts),
            read_snapshot=rv,
            report_conflicting_keys=self.report_conflicting_keys,
            mutations=mutations,
            lock_aware=self.dr_bypass,
        )
        ctr.validate()
        # _pin_proxy: targeted fencing (backup's stream barrier) must
        # hit a SPECIFIC proxy — round-robin adjacency is not a
        # guarantee under concurrent traffic
        proxy = getattr(self, "_pin_proxy", None) or self.db.commit_proxy()
        if self.debug_id is None:
            commit_id = await proxy.commit(ctr).future
        else:
            # span-threaded commit (Tracing.actor.cpp): the client span
            # context rides the request; the proxy's commitBatch span
            # parents on it, the resolvers' on the batch span — one
            # trace from transaction origin to resolution
            from foundationdb_tpu_torch.utils.spans import Span

            ctr.debug_id = self.debug_id
            with Span("NativeAPI.commit", clock=self.db.sched.now) as span:
                ctr.span = span.context.as_tuple()
                _trace.g_trace_batch.add_event(
                    "CommitDebug", self.debug_id, _cd.COMMIT_BEFORE
                )
                commit_id = await proxy.commit(ctr).future
                _trace.g_trace_batch.add_event(
                    "CommitDebug", self.debug_id, _cd.COMMIT_AFTER
                )
                span.attribute("Version", commit_id.version)
        self.committed_version = commit_id.version
        self._versionstamp = commit_id.versionstamp
        return commit_id.version

    def reset(self) -> None:
        # the tag survives reset: retried transactions must stay metered
        # (the overload-retry loop is exactly what tag throttling exists
        # to contain)
        self.__init__(self.db, tag=self.tag)


class CommitPipeline:
    """Client-side commit pipelining: keep up to `depth` commits from
    ONE client in flight at once (the reference NativeAPI pattern of
    not awaiting each commit before starting the next — commit latency
    is hidden behind the proxy's batch pipeline instead of serializing
    the client). submit() returns the commit's future immediately and
    only blocks when the window is full; drain() awaits the stragglers.

    Ordering: the proxy pipeline assigns versions in batch order, so
    two pipelined commits may land in the same or successive batches —
    the client must not assume commit N completes before it submits
    commit N+1 (that's the point). Conflict-dependent work (RMW) still
    needs the await before the dependent read.
    """

    def __init__(self, db: "Database", depth: int = 4):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.db = db
        self.depth = depth
        self._inflight: list = []

    async def submit(self, txn: Transaction):
        """Start txn.commit() without awaiting it; returns a future
        (await it for the version / NotCommitted). Blocks only while
        `depth` commits are already outstanding (windowed
        backpressure, oldest-first)."""
        while len(self._inflight) >= self.depth:
            head = self._inflight.pop(0)
            try:
                await head
            except Exception:  # flowcheck: ignore[actor.swallow]
                # not swallowed: the future stays readable and the
                # submitter's handle (the SAME future) carries the error
                pass
        task = self.db.sched.spawn(
            txn.commit(), name=f"commit-pipeline-{id(txn) & 0xFFFF}"
        )
        self._inflight.append(task.done)
        return task.done

    async def drain(self) -> None:
        """Await every outstanding commit (errors surface on the
        futures submit() returned, never here)."""
        inflight, self._inflight = self._inflight, []
        for fut in inflight:
            try:
                await fut
            except Exception:  # flowcheck: ignore[actor.swallow]
                # errors surface on the handles submit() returned (the
                # same multi-awaitable futures) — drain only completes
                pass


def _dedup(ranges):
    return sorted(set(ranges))


class LocationCache:
    """Client-side key -> (range, team) cache with wrong-shard
    invalidation (fdbclient/NativeAPI.actor.cpp:2969-3097
    getCachedKeyLocation / invalidateCache).

    Reads resolve locations from this cache, NOT the authoritative
    keyServers map — the cache may go stale after a shard move; the old
    owner then answers wrong_shard_server, the covering entry is
    invalidated, and the next attempt re-fetches. This is the client
    discipline that makes reads correct once locations travel over a
    wire instead of a shared object."""

    #: eviction cap — the reference bounds its cache with the
    #: locationCacheSize knob and evicts when full
    #: (fdbclient/NativeAPI.actor.cpp locationCacheSize)
    MAX_ENTRIES = 1024

    def __init__(self, cluster):
        self.cluster = cluster
        # a sorted range map, not a scanned list: begins sorted for bisect lookup, entries
        # non-overlapping by construction, FIFO eviction at the cap
        import collections

        self._begins: list[bytes] = []
        self._by_begin: dict[bytes, tuple[bytes, tuple]] = {}
        self._fifo = collections.deque()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.evictions = 0

    @staticmethod
    def _covers(b: bytes, e: bytes, key: bytes) -> bool:
        return b <= key and (e == b"" or key < e)

    def _index_covering(self, key: bytes) -> int:
        """Index into _begins of the entry covering key, or -1."""
        import bisect

        i = bisect.bisect_right(self._begins, key) - 1
        if i >= 0:
            b = self._begins[i]
            e, _team = self._by_begin[b]
            if self._covers(b, e, key):
                return i
        return -1

    def _remove_at(self, i: int) -> None:
        b = self._begins.pop(i)
        del self._by_begin[b]
        # stale FIFO tokens drain in the eviction loop, but that loop
        # only runs when the cache is over cap — under invalidate/
        # re-locate churn the deque would otherwise grow unboundedly
        # compact when it bloats past 4x the cap
        if len(self._fifo) > 4 * self.MAX_ENTRIES:
            live = set(self._by_begin)
            self._fifo = type(self._fifo)(
                t for t in self._fifo if t in live
            )

    def _insert(self, b: bytes, e: bytes, team: tuple) -> None:
        import bisect

        # drop any overlapping stale entries: [b, e) intersects a
        # contiguous run in begin order
        i = bisect.bisect_right(self._begins, b) - 1
        if i >= 0:
            pe = self._by_begin[self._begins[i]][0]
            if pe == b"" or pe > b:
                self._remove_at(i)
        i = bisect.bisect_left(self._begins, b)
        while i < len(self._begins) and (
            e == b"" or self._begins[i] < e
        ):
            self._remove_at(i)
        bisect.insort(self._begins, b)
        self._by_begin[b] = (e, team)
        self._fifo.append(b)
        while len(self._begins) > self.MAX_ENTRIES and self._fifo:
            victim = self._fifo.popleft()
            if victim == b:
                self._fifo.append(victim)  # never evict the fresh entry
                continue
            if victim in self._by_begin:
                self.evictions += 1
                self._remove_at(self._begins.index(victim))

    def locate(self, key: bytes) -> tuple[bytes, bytes, tuple]:
        """(shard_begin, shard_end, team) for `key`; shard_end == b""
        means the unbounded last shard. Entries hold FULL shard ranges
        (getKeyLocation's contract) — caching a clipped sub-range would
        make range reads crawl it key by key."""
        i = self._index_covering(key)
        if i >= 0:
            self.hits += 1
            b = self._begins[i]
            e, team = self._by_begin[b]
            return b, e, team
        self.misses += 1
        b, e, team = self.cluster.key_servers.range_of(key)
        self._insert(b, e, team)
        return b, e, team

    def invalidate(self, key: bytes) -> None:
        self.invalidations += 1
        i = self._index_covering(key)
        if i >= 0:
            self._remove_at(i)


class Database:
    """Client handle + the run/retry loop (Database::createTransaction)."""

    #: replica/location retry budget per read (loadBalance's bounded
    #: alternatives loop)
    READ_ATTEMPTS = 8

    def __init__(self, cluster):
        from foundationdb_tpu_torch.cluster.queue_model import QueueModel

        self.cluster = cluster
        self.sched = cluster.sched
        self._next_proxy = 0
        self._read_rr = 0  # replica rotation (loadBalance's next-replica)
        self.location_cache = LocationCache(cluster)
        self.dr_locked = False  # set while this db is a DR destination
        # per-replica latency estimates driving read load balancing
        # (fdbrpc/QueueModel.cpp; see cluster/queue_model.py)
        self.queue_model = QueueModel(cluster.sched)
        # TSS read sampling/comparison (cluster/tss.py; design/tss.md)
        from foundationdb_tpu_torch.cluster.tss import TssComparator

        self.tss = TssComparator(cluster.sched, cluster)
        # idempotency-id nonce state: (origin, client, seq) triples are
        # unique across client handles AND client processes without a
        # uuid4 (determinism.unseeded-random): the origin is the sim
        # seed under simulation (replayable) and the OS pid outside it
        self._client_id = cluster.next_client_id()
        self._idemp_seq = 0
        # commit-path tracing (debugTransaction): off by default; the
        # soak trace gate / tools flip it, and every transaction then
        # carries a deterministic (origin, client, seq) debug id
        self.tracing = False
        self._debug_seq = 0

    def next_debug_id(self) -> str:
        """Deterministic transaction debug id (the debugTransaction
        identity): sim-seed origin under simulation, pid outside — same
        discipline as the idempotency nonce, so traced runs replay
        bit-identically."""
        import os

        self._debug_seq += 1
        origin = (
            (self.cluster.config.sim_seed or 0) if self.sched.sim
            else os.getpid()
        )
        return f"{origin}-{self._client_id}-{self._debug_seq}"

    def next_idempotency_id(self) -> bytes:
        """Deterministic idempotency id: 24 bytes of
        (origin, client_id, sequence) — see _client_id above."""
        import os
        import struct

        self._idemp_seq += 1
        if self.sched.sim:
            origin = self.cluster.config.sim_seed or 0
        else:
            # outside simulation, pids recycle: a fresh process handed a
            # predecessor's pid must never replay its id sequence (stale
            # \xff/idmp records would make run(idempotent=True) skip a
            # commit that never happened here — a silently lost write),
            # so fold real entropy under the pid. Sim runs never take
            # this branch, so determinism is untouched.
            origin = (os.getpid() << 32) | int.from_bytes(
                os.urandom(4), "little"  # flowcheck: ignore[determinism.unseeded-random]
            )
        return struct.pack("<qqq", origin, self._client_id, self._idemp_seq)

    @property
    def grv_proxy(self):
        # resolved per call: recovery replaces the GRV proxy generation
        return self.cluster.grv_proxy

    def commit_proxy(self):
        # round-robin over commit proxies (the reference picks randomly)
        p = self.cluster.commit_proxies[
            self._next_proxy % len(self.cluster.commit_proxies)
        ]
        self._next_proxy += 1
        return p

    def _live_rotated(self, team: tuple) -> list:
        """LIVE members of a team, rotated so latency-tied (cold)
        replicas share load round-robin (dead replicas are skipped —
        the failure-monitor contract)."""
        live = [s for s in team if self.cluster.storage_live[s]]
        if not live:
            live = list(team)  # nothing marked live: fall back, will hang
        self._read_rr += 1
        k = self._read_rr % len(live)
        return live[k:] + live[:k]

    def _pick_replica(self, team: tuple) -> int:
        """Best replica by the QueueModel latency estimate
        (fdbrpc/LoadBalance.actor.h replica selection)."""
        return self.queue_model.order(self._live_rotated(team))[0]

    def storage_for(self, key: bytes):
        _b, _e, team = self.location_cache.locate(key)
        return self.cluster.client_storages[self._pick_replica(team)]

    def _report_failed(self, s: int) -> None:
        fm = getattr(self.cluster, "failure_monitor", None)
        if fm is not None:
            fm.report_failed(f"storage{s}")
        else:
            self.cluster.storage_live[s] = False

    async def read_value(self, key: bytes, rv: int):
        """Point read through the location cache with the reference's
        two error-recovery loops: wrong_shard_server -> invalidate +
        re-resolve; process failure -> report to the failure monitor +
        fail over to another replica."""
        from foundationdb_tpu_torch.cluster.failure_monitor import ProcessFailedError
        from foundationdb_tpu_torch.cluster.storage import (
            TransactionTooOld,
            WrongShardServerError,
        )

        from foundationdb_tpu_torch.cluster.queue_model import load_balanced_call

        def issue(s):
            async def go():
                try:
                    return await self.cluster.client_storages[s].get_value(
                        key, rv
                    )
                except ProcessFailedError:
                    # report at the issuing site: the balancer only sees
                    # "some replica failed", the monitor needs WHICH
                    self._report_failed(s)
                    raise
            return go()

        err = None
        for _ in range(self.READ_ATTEMPTS):
            _b, _e, team = self.location_cache.locate(key)
            try:
                result = await load_balanced_call(
                    self.sched, self.queue_model,
                    self._live_rotated(team), issue,
                )
                # TSS sampling: replicas hold identical content at rv,
                # so any TSS-paired team member's mirror is a valid
                # comparison target; fire-and-forget, off the hot path
                for s in team:
                    if s in getattr(self.cluster, "client_tss", {}):
                        self.tss.maybe_sample(s, key, rv, result)
                        break
                return result
            except WrongShardServerError as e:
                err = e
                self.location_cache.invalidate(key)
            except ProcessFailedError as e:
                err = e
            except TransactionTooOld:
                # the storage GC'd past our read version: surface the
                # CLIENT-level retryable error (error_code_transaction_
                # too_old reaches Transaction::onError in the reference)
                raise TransactionTooOldError(
                    f"read at {rv} below the storage MVCC window"
                )
        raise err

    async def read_range(self, begin: bytes, end: bytes, rv: int):
        """Range read segment-by-segment through the location cache,
        with the same wrong-shard/failure recovery per segment."""
        from foundationdb_tpu_torch.cluster.failure_monitor import ProcessFailedError
        from foundationdb_tpu_torch.cluster.storage import (
            TransactionTooOld,
            WrongShardServerError,
        )

        items: list[tuple[bytes, bytes]] = []
        cursor = begin
        attempts = 0
        while cursor < end:
            _b, seg_e, team = self.location_cache.locate(cursor)
            seg_end = end if seg_e == b"" else min(seg_e, end)
            s = self._pick_replica(team)
            t0 = self.queue_model.start(s)
            ok = False
            try:
                items.extend(
                    await self.cluster.client_storages[s].get_key_values(
                        cursor, seg_end, rv
                    )
                )
                ok = True
            except WrongShardServerError:
                self.location_cache.invalidate(cursor)
                attempts += 1
                if attempts > self.READ_ATTEMPTS:
                    raise
                continue
            except ProcessFailedError:
                self._report_failed(s)
                attempts += 1
                if attempts > self.READ_ATTEMPTS:
                    raise
                continue
            except TransactionTooOld:
                raise TransactionTooOldError(
                    f"read at {rv} below the storage MVCC window"
                )
            finally:
                # finally, not per-handler: an unexpected error (or the
                # task being cancelled at the await) must not leak the
                # outstanding increment and bias reads off this replica
                self.queue_model.finish(s, t0, failed=not ok)
            cursor = seg_end
            # budget retries per segment, not per scan: a long range
            # crossing many concurrently-moving shards must not exhaust
            # the budget when each individual segment retry would have
            # succeeded (NativeAPI retries per getRange leg)
            attempts = 0
        return items

    def create_transaction(self, tag: str = None) -> Transaction:
        return Transaction(self, tag=tag)

    def commit_pipeline(self, depth: int = 4) -> CommitPipeline:
        """Client-side commit pipelining (see CommitPipeline): up to
        `depth` commits from this client in flight concurrently."""
        return CommitPipeline(self, depth=depth)

    def special_key(self, key: bytes):
        """The \\xff\\xff special key space (SpecialKeySpace.actor.cpp):
        virtual reads of management/status information."""
        import json

        if key == b"\xff\xff/status/json":
            from foundationdb_tpu_torch.cluster.status import cluster_status

            return json.dumps(cluster_status(self.cluster)).encode()
        if key == b"\xff\xff/cluster/epoch":
            return str(self.cluster.controller.epoch).encode()
        if key == b"\xff\xff/cluster/live_committed_version":
            return str(self.cluster.sequencer.live_committed.get()).encode()
        if key == b"\xff\xff/worker_interfaces":
            # the recruited role inventory (worker_interfaces module of
            # SpecialKeySpace: who is serving what)
            return json.dumps({
                "commit_proxies": [p.proxy_id for p in
                                   self.cluster.commit_proxies],
                "resolvers": [f"resolver{r.resolver_id}"
                              for r in self.cluster.resolvers],
                "storage": [f"storage{i}" for i, live in
                            enumerate(self.cluster.storage_live) if live],
                "coordinators": [c.name for c in self.cluster.coordinators
                                 if c.alive],
            }).encode()
        if key == b"\xff\xff/metrics/resolver":
            # resolver counter rollup (the metrics module surface)
            out = []
            for r in self.cluster.resolvers:
                out.append(r.counters.as_dict())
            return json.dumps(out).encode()
        if key == b"\xff\xff/coordinators":
            return json.dumps({
                "quorum": len(self.cluster.coordinators) // 2 + 1,
                "alive": sum(c.alive for c in self.cluster.coordinators),
                "total": len(self.cluster.coordinators),
            }).encode()
        if key == b"\xff\xff/data_distribution/key_counts":
            return json.dumps(
                self.cluster.data_distributor.key_counts()).encode()
        return None

    async def run(self, fn, *, max_retries: int = 50, idempotent: bool = False):
        """retry_loop(fn): the standard transaction retry pattern
        (Transaction::onError — not_committed and too-old retry with a
        fresh read version). With idempotent=True, commit_unknown_result
        retries first check the idempotency record so a commit that DID
        apply is not applied twice."""
        backoff = 0.001
        idemp_id = None
        for _ in range(max_retries):
            txn = self.create_transaction()
            if idempotent:
                idemp_id = txn.set_idempotency_id(idemp_id)
            try:
                result = await fn(txn)
                await txn.commit()
                return result
            except CommitUnknownResult:
                if idemp_id is not None:
                    probe = self.create_transaction()
                    try:
                        mark = await probe.get(
                            b"\xff/idmp/" + idemp_id, snapshot=True
                        )
                    except (TransactionTooOldError, GrvProxyFailedError,
                            GrvThrottledError):
                        mark = None
                    if mark is not None:
                        return result  # the first attempt committed
                await self.sched.delay(backoff)
                backoff = min(backoff * 2, 0.1)
            except (NotCommitted, TransactionTooOldError,
                    GrvProxyFailedError, GrvThrottledError):
                # grv_throttled: the front door shed this request under
                # overload — the exponential backoff below IS the
                # client side of the admission-control contract
                await self.sched.delay(backoff)
                backoff = min(backoff * 2, 0.1)
        raise RuntimeError("transaction retry limit reached")
