"""Storage server: versioned MVCC KV store fed from the TLog.

Behavioral mirror of `fdbserver/storageserver.actor.cpp`:

* `update` loop (:9117): pulls its tag's mutations from the TLog in
  version order and applies them to the versioned store.
* The store is the reference's VersionedMap
  (fdbclient/include/fdbclient/VersionedMap.h) in spirit: every key maps
  to its version history within the MVCC window, so a read AT version v
  sees exactly the state as of v — the property that makes read-only
  transactions (which commit client-side without conflict checking)
  serializable. Old versions garbage-collect as the window floor rises.
* Reads (`getValueQ` :2119, `getKeyValuesQ` :4201): wait for the store to
  reach the request version (waitForVersion); reading below the MVCC
  window raises transaction_too_old.
* Shard moves (fetchKeys :7378): while a shard is being fetched, its
  incoming mutations buffer; the snapshot installs at the fetch version
  and the buffer replays above it.

Mutations are ("set", key, value) / ("clear", begin, end) /
("atomic", op, key, param) tuples (MutationRef,
fdbclient/CommitTransaction.h:32-71).

The port's own copy of foundationdb_tpu.cluster.storage.
"""

from __future__ import annotations

import bisect
from typing import Any, Optional

from foundationdb_tpu_torch.cluster import sampling as _sampling
from foundationdb_tpu_torch.cluster.tlog import TLog
from foundationdb_tpu_torch.runtime.flow import ActorCancelled, Notified, Scheduler
from foundationdb_tpu_torch.utils import commit_debug as _cd
from foundationdb_tpu_torch.utils import trace as _trace
from foundationdb_tpu_torch.utils.metrics import (
    READ_LATENCY_BANDS,
    LatencyBands,
    LatencySample,
)


class TransactionTooOld(Exception):
    """error_code_transaction_too_old: read below the MVCC window."""


class WrongShardServerError(Exception):
    """error_code_wrong_shard_server: this server no longer owns the
    range (it moved away and the data was dropped). The client
    invalidates its location cache entry and re-resolves
    (fdbclient/NativeAPI.actor.cpp:2969-3097)."""


class StorageServer:
    def __init__(
        self,
        sched: Scheduler,
        tlog: TLog,
        tag: int,
        *,
        recovery_version: int = 0,
        window_versions: int = 5_000_000,
        consumer: str = "storage",
        sample_seed: int = 0,
    ):
        self.sched = sched
        self.tlog = tlog
        self.tag = tag
        # the tlog pop identity: a TSS mirror shares its pair's TAG but
        # must pop under its OWN consumer name, or whichever of the
        # pair pulls first trims messages the other never saw
        # (design/tss.md — the TSS has an independent pop cursor)
        self.consumer = consumer
        if consumer != "storage":
            tlog.register_tag_mirror(tag, consumer)
        self.version = Notified(recovery_version)
        self.durable_version = recovery_version
        self.oldest_version = recovery_version
        self.window_versions = window_versions
        # The versioned store: sorted key list + per-key version history
        # [(version, value-or-None)], ascending; None = cleared.
        self._keys: list[bytes] = []
        self._hist: dict[bytes, list[tuple[int, Optional[bytes]]]] = {}
        # watches: key -> [(expected_value, promise)]
        self._watches: dict[bytes, list] = {}
        # in-progress shard fetches: (begin, end) -> buffered [(v, mutation)]
        self._fetching: dict[tuple, list] = {}
        # shards acquired by a move are only readable from their fetch
        # version: [(begin, end, available_from)] — the reference returns
        # wrong_shard_server for older reads; we raise too-old (both make
        # the client retry at a fresh version)
        self._shard_floors: list[tuple[bytes, bytes, int]] = []
        # ranges this server relinquished (moved away + data dropped):
        # reads there answer wrong_shard_server so a stale client
        # location cache LOUDLY invalidates instead of reading absence
        self._dropped_ranges: list[tuple[bytes, bytes]] = []
        # ownership ceilings: [(begin, end, last_owned_version)] — a
        # leaver set this at the routing flip; reads ABOVE the ceiling
        # must go to the new team (the reference's serverKeys ownership
        # check on the storage, storageserver.actor.cpp) while reads at
        # or below it stay servable until the data actually drops
        self._ceded_ranges: list[tuple[bytes, bytes, int]] = []
        self.stopped = False
        # live (non-cleared) key count, maintained incrementally
        self._live_count = 0
        self._last_gc = recovery_version
        self._update_task = None
        #: fault injection: extra seconds per pull iteration (a slow
        #: disk/IO path; the Ratekeeper must observe the growing lag and
        #: throttle admission — Ratekeeper.actor.cpp's control input)
        self.slowdown = 0.0
        #: fault injection on the READ path: extra seconds per get —
        #: a slow-but-alive replica; the client QueueModel (not the
        #: failure monitor) is what must shed load off it
        self.read_slowdown = 0.0
        # read latency distribution + reference-style bands
        # (storageserver.actor.cpp readLatencyBands), in virtual time
        self.read_latency = LatencySample("readLatency")
        self.read_latency_bands = LatencyBands(
            "ReadLatencyMetrics", READ_LATENCY_BANDS
        )
        # -- saturation sensors (StorageQueueInfo: the Ratekeeper's
        # per-storage inputs — smoothed input bytes, version lag,
        # fetchKeys backlog) — virtual-clock smoothers, deterministic
        # per seed
        from foundationdb_tpu_torch.utils.metrics import Smoother

        self.smoothed_input_bytes = Smoother(1.0, clock=sched.now)
        #: mutations applied by the last pull batch (the apply-queue
        #: depth proxy: a lagging replica catches up in huge batches)
        self.last_batch_mutations = 0
        # -- skew sensors: the StorageMetrics byteSample and
        # TransactionTagCounter pair. Seeded from the sim seed (via
        # sample_seed) and clocked off the virtual clock, so every
        # value they surface is bit-deterministic per seed.
        self.byte_sample = _sampling.ByteSample(seed=sample_seed)
        self.read_tags = _sampling.TagCounter(clock=sched.now)
        self.write_tags = _sampling.TagCounter(clock=sched.now)

    def saturation(self) -> dict:
        """The storage server's qos sensor block: how far the apply
        cursor trails the log (apply-queue depth in versions), the
        fetchKeys backlog, and the smoothed write bandwidth. The
        cluster-level version lag (vs the sequencer head) is derived at
        status-assembly time — this process doesn't know the head."""
        return {
            "apply_lag_versions": max(
                0, self.tlog.version.get() - self.version.get()
            ),
            "write_queue_bytes": self.tlog.tag_backlog_bytes(
                self.tag, self.consumer
            ),
            "apply_batch_mutations": self.last_batch_mutations,
            "input_bytes_per_s": self.smoothed_input_bytes.smooth_rate(),
            "fetch_backlog_ranges": len(self._fetching),
            "fetch_backlog_mutations": sum(
                len(buf) for buf in self._fetching.values()
            ),
            "keys": self._live_count,
            "mvcc_window_versions": self.window_versions,
            # -- skew sensors: the byteSample estimate, the
            # keyspace heatmap rows and the busiest-tag pair
            "sampled_bytes": self.byte_sample.total_bytes(),
            "sample_keys": self.byte_sample.count,
            "hot_ranges": self.byte_sample.hot_ranges(),
            "busiest_read_tag": self.read_tags.busiest(),
            "busiest_write_tag": self.write_tags.busiest(),
        }

    def start(self) -> None:
        self.stopped = False
        self._update_task = self.sched.spawn(self._update_loop(), name="ss-update")

    def stop(self) -> None:
        self.stopped = True
        if self._update_task is not None:
            self._update_task.cancel()
        if self.consumer != "storage":
            # release the mirror cursor: a dead TSS must not pin its
            # pair's tag retention
            self.tlog.unregister_tag_mirror(self.tag, self.consumer)

    async def ping(self) -> bool:
        """Failure-monitor probe (rides the SimNetwork under simulation,
        so partitions look like death from the monitor's vantage)."""
        return not self.stopped

    # -- write path --------------------------------------------------------

    async def _update_loop(self) -> None:
        try:
            while True:
                if self.slowdown:
                    await self.sched.delay(self.slowdown)
                entries, log_version = await self.tlog.peek(
                    self.tag, self.version.get()
                )
                self.last_batch_mutations = sum(
                    len(msgs) for _v, msgs in entries
                )
                for v, msgs in entries:
                    assert v > self.version.get()
                    for m in msgs:
                        self._ingest(v, m)
                        try:
                            nb = 8 + len(m[1]) + len(m[2])
                        except Exception:
                            nb = 32
                        self.smoothed_input_bytes.add_delta(nb)
                        # busiest-write-tag sensor: the TLog-fed client
                        # write path only (shard-move replays don't
                        # re-count traffic that already counted)
                        key = m[2] if m[0] == "atomic" else m[1]
                        self.write_tags.note(_sampling.tag_of_key(key), nb)
                    self.version.set(v)
                    if _trace.g_trace_batch.enabled:
                        # version-keyed (storage sits below the debug-id
                        # horizon); CommitDebugVersion joins it back to
                        # the committing batch
                        _trace.g_trace_batch.add_event(
                            "CommitDebug", _cd.version_id(v),
                            _cd.STORAGE_APPLIED,
                        )
                # Version leveling: advance to the log's version even when
                # no mutations touched this tag (peek cursor contract).
                if log_version > self.version.get():
                    self.version.set(log_version)
                self.durable_version = self.version.get()
                self._gc(self.durable_version - self.window_versions)
                self.tlog.pop(
                    self.tag, self.durable_version, consumer=self.consumer
                )
                await self.tlog.version.when_at_least(self.version.get() + 1)
        except ActorCancelled:
            raise

    def _ingest(self, v: int, m) -> None:
        """Route one mutation: buffer if its span is being fetched;
        discard if an installed shard's snapshot already covers it."""
        if self._fetching and m[0] == "clear":
            # clears may straddle a fetching range: buffer the clipped
            # overlap for post-install replay AND apply now (the fetching
            # span holds no data yet, so this only affects owned keys).
            for (b, e), buf in self._fetching.items():
                cb, ce = max(m[1], b), min(m[2], e)
                if cb < ce:
                    buf.append((v, ("clear", cb, ce)))
            self._apply_above_floors(v, m)
            return
        rng = self._fetch_range_of(m)
        if rng is not None:
            self._fetching[rng].append((v, m))
        else:
            self._apply_above_floors(v, m)

    def _apply_above_floors(self, v: int, m) -> None:
        """Apply, skipping spans an installed snapshot already covers.

        The update loop's cursor can lag a concurrent install_shard: a
        dual-tagged entry at version <= an installed shard's floor
        arrives AFTER the snapshot (which already reflects it) was
        recorded at the floor version — applying it would write an older
        version on top of a newer one (history out of order; a
        2000-seed ensemble, seed 166). Sets/atomics in a floored range
        with v <= floor drop; clears clip to the parts outside such
        ranges."""
        if m[0] != "clear":
            key = m[2] if m[0] == "atomic" else m[1]
            for b, e, floor in self._shard_floors:
                if b <= key < e and v <= floor:
                    return
            self._apply(v, m)
            return
        spans = [(m[1], m[2])]
        for b, e, floor in self._shard_floors:
            if v > floor:
                continue
            nxt = []
            for cb, ce in spans:
                if ce <= b or e <= cb:
                    nxt.append((cb, ce))
                    continue
                if cb < b:
                    nxt.append((cb, b))
                if e < ce:
                    nxt.append((e, ce))
            spans = nxt
        for cb, ce in spans:
            self._apply(v, ("clear", cb, ce))

    def _record(self, v: int, k: bytes, value: Optional[bytes]) -> None:
        if k not in self._hist:
            if value is None:
                return  # clearing a key that never existed
            bisect.insort(self._keys, k)
            self._hist[k] = []
        h = self._hist[k]
        was_live = bool(h) and h[-1][1] is not None
        if h and h[-1][0] == v:
            h[-1] = (v, value)
        else:
            h.append((v, value))
        now_live = value is not None
        self._live_count += int(now_live) - int(was_live)
        # the byteSample tracks the LIVE latest-version state: every
        # state-changing path (client writes, shard installs, drops)
        # funnels through here, so the sample can never drift from the
        # store it estimates
        if now_live:
            self.byte_sample.note_write(k, value)
        else:
            self.byte_sample.erase(k)

    @staticmethod
    def _at_or_below(h: list, v: int) -> int:
        """Index just past the rightmost entry with version <= v.
        (Manual binary search: values may be None, so tuple bisect would
        compare None with bytes.)"""
        lo, hi = 0, len(h)
        while lo < hi:
            mid = (lo + hi) // 2
            if h[mid][0] <= v:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def _value_at(self, k: bytes, v: int) -> Optional[bytes]:
        h = self._hist.get(k)
        if not h:
            return None
        i = self._at_or_below(h, v)
        if i == 0:
            return None
        return h[i - 1][1]

    def _apply(self, v: int, m) -> None:
        kind = m[0]
        if kind == "set":
            self._record(v, m[1], m[2])
            self._fire_watches(m[1])
        elif kind == "atomic":
            from foundationdb_tpu_torch.utils.atomic import apply_atomic

            _, op, k, param = m
            self._record(v, k, apply_atomic(op, self._value_at(k, v), param))
            self._fire_watches(k)
        elif kind == "clear":
            _, b, e = m
            lo = bisect.bisect_left(self._keys, b)
            hi = bisect.bisect_left(self._keys, e)
            for k in self._keys[lo:hi]:
                if self._value_at(k, v) is not None:
                    self._record(v, k, None)
            for k in [k for k in self._watches if b <= k < e]:
                self._fire_watches(k)
        else:
            raise ValueError(f"unknown mutation {m!r}")

    def _gc(self, floor: int) -> None:
        """Raise the MVCC floor: keep one entry at-or-below it per key;
        drop keys whose only state is an old clear. The full-store sweep
        is batched (every ~window/64 of version advance) so steady
        commits don't pay O(all keys) per update tick."""
        if floor <= self.oldest_version:
            return
        self.oldest_version = floor
        if floor - self._last_gc < self.window_versions // 64:
            return
        self._last_gc = floor
        dead = []
        for k, h in self._hist.items():
            i = self._at_or_below(h, floor) - 1
            if i > 0:
                del h[:i]
            if len(h) == 1 and h[0][1] is None and h[0][0] <= floor:
                dead.append(k)
        for k in dead:
            del self._hist[k]
            self._keys.remove(k)

    # -- watches (watchValueSendReply: fire when the value changes) --------

    def watch(self, key: bytes, expected):
        from foundationdb_tpu_torch.runtime.flow import Promise

        p = Promise()
        if self._value_at(key, self.version.get()) != expected:
            p.send(self.version.get())
        else:
            self._watches.setdefault(key, []).append((expected, p))
        return p.future

    def _fire_watches(self, key: bytes) -> None:
        if key not in self._watches:
            return
        current = self._value_at(key, 1 << 62)  # latest, incl. in-apply
        still = []
        for expected, p in self._watches[key]:
            if current != expected:
                p.send(self.version.get())
            else:
                still.append((expected, p))
        if still:
            self._watches[key] = still
        else:
            del self._watches[key]

    # -- shard moves (fetchKeys) ------------------------------------------

    def begin_fetch(self, begin: bytes, end: bytes) -> None:
        self._fetching[(begin, end)] = []

    def install_shard(
        self, begin: bytes, end: bytes,
        items: list[tuple[bytes, bytes]], fetch_version: int,
    ) -> None:
        """Install the fetched snapshot (state as of fetch_version) and
        replay buffered mutations newer than it, in version order. The
        shard is only readable from fetch_version on."""
        buffered = self._fetching.pop((begin, end))
        for k, v in items:
            self._record(fetch_version, k, v)
        for v, m in buffered:
            if v > fetch_version:
                self._apply(v, m)
        self._shard_floors.append((begin, end, fetch_version))
        # re-acquiring a range lifts its wrong_shard_server refusal by
        # SUBTRACTION: a partially overlapping re-acquisition (the
        # balancer moves different range shapes than DD did) must not
        # leave a permanent refusal over keys this server now owns
        # re-acquiring also lifts stale cede ceilings (an aborted move
        # can leave one behind; a current owner must not refuse reads)
        new_ceded: list[tuple[bytes, bytes, int]] = []
        for b, e, ceil_v in self._ceded_ranges:
            if e <= begin or end <= b:
                new_ceded.append((b, e, ceil_v))
                continue
            if b < begin:
                new_ceded.append((b, begin, ceil_v))
            if end < e:
                new_ceded.append((end, e, ceil_v))
        self._ceded_ranges = new_ceded
        new_dropped: list[tuple[bytes, bytes]] = []
        for b, e in self._dropped_ranges:
            if e <= begin or end <= b:
                new_dropped.append((b, e))
                continue
            if b < begin:
                new_dropped.append((b, begin))
            if end < e:
                new_dropped.append((end, e))
        self._dropped_ranges = new_dropped

    def cancel_fetch(self, begin: bytes, end: bytes) -> None:
        """Abort a fetch (move failed before the routing flip): the
        buffered mutations belong to the still-current owner — discard."""
        self._fetching.pop((begin, end), None)

    def cede_shard(self, begin: bytes, end: bytes, version: int) -> None:
        """Ownership of [begin, end) ends at `version`: refuse reads
        above it (WrongShardServerError -> the client re-resolves to the
        new team). Set BEFORE the routing flip — this closes the window
        where a leaver would serve reads at versions whose mutations are
        tagged only to the new team (the lost-write class a 2000-seed
        ensemble found)."""
        self._ceded_ranges.append((begin, end, version))

    def drop_shard(self, begin: bytes, end: bytes) -> None:
        self._apply(self.version.get(), ("clear", begin, end))
        self._shard_floors = [
            f for f in self._shard_floors
            if not (f[0] >= begin and f[1] <= end)
        ]
        self._ceded_ranges = [
            c for c in self._ceded_ranges
            if not (c[0] >= begin and c[1] <= end)
        ]
        self._dropped_ranges.append((begin, end))

    def _fetch_range_of(self, m):
        if not self._fetching:
            return None
        key = m[2] if m[0] == "atomic" else m[1]
        for (b, e), _buf in self._fetching.items():
            if b <= key < e:
                return (b, e)
        return None

    # -- checkpoint / resume ---------------------------------------------

    def snapshot(self) -> dict:
        """The durable on-disk state a restart recovers from."""
        return {
            "keys": list(self._keys),
            "hist": {k: list(h) for k, h in self._hist.items()},
            "durable_version": self.durable_version,
            "oldest_version": self.oldest_version,
            "live_count": self._live_count,
            "shard_floors": list(self._shard_floors),
            # wrong_shard_server refusals are part of the durable
            # contract: a rebooted server that forgot them would
            # silently serve absence for moved-away ranges to clients
            # holding stale location-cache entries
            "dropped_ranges": list(self._dropped_ranges),
            "ceded_ranges": list(self._ceded_ranges),
            # the byteSample is durable alongside the store it samples:
            # a rebooted server must not restart skew sensing from an
            # empty (and so wildly underestimating) sample
            "byte_sample": self.byte_sample.snapshot(),
        }

    def restore(self, snap: dict) -> None:
        self._keys = list(snap["keys"])
        self._hist = {k: list(h) for k, h in snap["hist"].items()}
        self.durable_version = snap["durable_version"]
        self.oldest_version = snap["oldest_version"]
        self._live_count = snap["live_count"]
        self._shard_floors = list(snap["shard_floors"])
        self._dropped_ranges = list(snap.get("dropped_ranges", []))
        self._ceded_ranges = list(snap.get("ceded_ranges", []))
        self._last_gc = snap["oldest_version"]
        self.version = Notified(snap["durable_version"])
        if "byte_sample" in snap:
            self.byte_sample.restore(snap["byte_sample"])

    # -- read path -----------------------------------------------------------

    async def _wait_for_version(self, version: int) -> None:
        if version < self.oldest_version:
            raise TransactionTooOld(version)
        await self.version.when_at_least(version)
        if version < self.oldest_version:
            # the MVCC floor can pass the request version DURING the
            # wait: a lagging replica catching up applies a huge version
            # span in one pull batch and GCs history the waiter was
            # about to read — serving now would return a silently
            # PARTIAL state at `version` (keys whose surviving floor
            # entry sits above it vanish). The reference re-validates
            # after waitForVersion for the same reason
            # (storageserver.actor.cpp transaction_too_old). Found by
            # the api workload's model check (soak seeds 1122/1171).
            raise TransactionTooOld(version)

    def _check_shard_floor(self, begin: bytes, end: bytes, version: int) -> None:
        from foundationdb_tpu_torch.cluster.failure_monitor import ProcessFailedError

        if self.stopped:
            # a read reaching a dead process: the transport-level error
            # the client's failure-report fast path consumes
            raise ProcessFailedError(f"storage tag {self.tag} is down")
        for b, e in self._dropped_ranges:
            if begin < e and b < end:
                raise WrongShardServerError((begin, end))
        for b, e, ceiling in self._ceded_ranges:
            if begin < e and b < end and version > ceiling:
                raise WrongShardServerError((begin, end))
        for b, e, floor in self._shard_floors:
            if begin < e and b < end and version < floor:
                # a recently-moved-in shard has no history below its
                # fetch version; the client retries at a fresh version
                raise TransactionTooOld(version)

    async def get_value(self, key: bytes, version: int) -> Optional[bytes]:
        t0 = self.sched.now()
        self._check_shard_floor(key, key + b"\x00", version)  # fail fast
        if self.read_slowdown:
            await self.sched.delay(self.read_slowdown)
        await self._wait_for_version(version)
        self._check_shard_floor(key, key + b"\x00", version)
        dt = self.sched.now() - t0
        self.read_latency.sample(dt)
        self.read_latency_bands.add(dt)
        val = self._value_at(key, version)
        self.read_tags.note(
            _sampling.tag_of_key(key), len(key) + len(val or b"")
        )
        return val

    async def get_key_values(
        self, begin: bytes, end: bytes, version: int, *, limit: int = 1 << 30
    ) -> list[tuple[bytes, bytes]]:
        t0 = self.sched.now()
        self._check_shard_floor(begin, end, version)  # fail fast
        if self.read_slowdown:
            await self.sched.delay(self.read_slowdown)
        await self._wait_for_version(version)
        self._check_shard_floor(begin, end, version)
        dt = self.sched.now() - t0
        self.read_latency.sample(dt)
        self.read_latency_bands.add(dt)
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        out = []
        for k in self._keys[lo:hi]:
            v = self._value_at(k, version)
            if v is not None:
                out.append((k, v))
                if len(out) >= limit:
                    break
        self.read_tags.note(
            _sampling.tag_of_key(begin),
            sum(len(k) + len(v) for k, v in out) or len(begin),
        )
        return out

    # test/inspection helper: the latest-version view of the data
    @property
    def _data(self) -> dict[bytes, bytes]:
        v = self.version.get()
        return {
            k: val
            for k in self._keys
            if (val := self._value_at(k, v)) is not None
        }
