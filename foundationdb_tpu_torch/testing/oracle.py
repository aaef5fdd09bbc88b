"""Pure-Python semantic oracle for MVCC conflict resolution (the port's own
copy of foundationdb_tpu.testing.oracle: OracleTxn, VersionMap,
ConflictOracle, SequentialModel and MultiResolverOracle).

A deliberately simple, obviously-correct model of the reference semantics
(fdbserver/SkipList.cpp ConflictBatch + SkipList, fdbserver/Resolver.actor.cpp
resolveBatch), used as the golden oracle for kernel parity tests:

* The conflict history is a piecewise-constant map keyspace -> version,
  maintained as a sorted boundary list. Inserting a committed write range
  [b, e) at version v overwrites the map on [b, e) with v — exactly what
  SkipList::addConflictRanges does (remove interior nodes, re-insert begin
  at v, end inherits — fdbserver/SkipList.cpp:430-441).
* A read range [b, e) at snapshot s conflicts iff the max version over
  map segments intersecting [b, e) exceeds s (the CheckMax contract,
  fdbserver/SkipList.cpp:695-759).
* Batch detection follows ConflictBatch::detectConflicts order
  (fdbserver/SkipList.cpp:909-956): history check for all txns, then the
  sequential intra-batch pass in txn order (writes of earlier
  non-conflicted txns conflict later reads — :874-899), then the union of
  non-conflicted txns' writes is merged at the batch version, then the
  MVCC-window GC.
* tooOld iff read_snapshot < newOldestVersion and the txn has read ranges
  (:819-828); tooOld txns contribute nothing to the batch.

This is O(n^2)-ish per batch and only meant for tests.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Optional

CONFLICT = 0
TOO_OLD = 1
COMMITTED = 3  # matches ConflictBatch::TransactionCommitted's enum slot


@dataclasses.dataclass
class OracleTxn:
    read_conflict_ranges: list  # [(begin, end)] byte pairs
    write_conflict_ranges: list
    read_snapshot: int
    report_conflicting_keys: bool = False


class VersionMap:
    """Sorted-boundary piecewise-constant map bytes -> version."""

    def __init__(self, background: int = 0):
        # boundaries[i] starts segment i with value values[i];
        # keys below boundaries[0] (or an empty map) have `background`.
        self.boundaries: list[bytes] = []
        self.values: list[int] = []
        self.background = background

    def write(self, begin: bytes, end: bytes, version: int) -> None:
        if begin >= end:
            return
        b, v = self.boundaries, self.values
        hi = bisect.bisect_left(b, end)
        lo = bisect.bisect_left(b, begin)
        if hi < len(b) and b[hi] == end:
            # a segment already starts exactly at `end`
            b[lo:hi] = [begin]
            v[lo:hi] = [version]
        else:
            # value in force at `end` before the edit
            tail_val = v[hi - 1] if hi > 0 else self.background
            b[lo:hi] = [begin, end]
            v[lo:hi] = [version, tail_val]

    def max_over(self, begin: bytes, end: bytes) -> int:
        """Max version over segments intersecting [begin, end)."""
        if begin >= end:
            return self.background
        b, v = self.boundaries, self.values
        lo = bisect.bisect_right(b, begin) - 1  # segment containing begin
        hi = bisect.bisect_left(b, end) - 1     # last segment starting < end
        best = self.background if lo < 0 else v[lo]
        for i in range(max(lo, 0), hi + 1):
            best = max(best, v[i])
        return best

    def gc(self, oldest: int) -> None:
        """Drop boundaries that can no longer affect any non-tooOld query.

        Mirrors SkipList::removeBefore: a segment with version < oldest can
        never conflict (queries have snapshot >= oldest); adjacent dead
        segments merge.
        """
        b, v = self.boundaries, self.values
        if not b:
            return
        dead_bg = self.background < oldest
        nb, nv = [], []
        prev_dead = dead_bg
        for key, val in zip(b, v):
            is_dead = val < oldest
            if is_dead and prev_dead:
                continue
            nb.append(key)
            nv.append(val)
            prev_dead = is_dead
        self.boundaries, self.values = nb, nv


@dataclasses.dataclass
class OracleBatchResult:
    verdicts: list[int]                       # per-txn CONFLICT/TOO_OLD/COMMITTED
    conflicting_ranges: dict[int, list[int]]  # txn -> read-range indices
    combined_writes: list[tuple[bytes, bytes]]


class ConflictOracle:
    """Batch-at-a-time oracle with persistent history."""

    def __init__(self, window: int = 5_000_000):
        self.history = VersionMap(background=0)
        self.window = window
        self.oldest = 0

    def resolve(self, txns: list[OracleTxn], version: int) -> OracleBatchResult:
        new_oldest = version - self.window
        n = len(txns)
        verdict = [COMMITTED] * n
        too_old = [False] * n
        conflicting: dict[int, list[int]] = {}

        # -- addTransaction: tooOld classification --------------------------
        for t, tr in enumerate(txns):
            if tr.read_snapshot < new_oldest and tr.read_conflict_ranges:
                too_old[t] = True

        # -- phase 1: reads vs. history ------------------------------------
        hist_conflict = [False] * n
        for t, tr in enumerate(txns):
            if too_old[t]:
                continue
            # the reference records every history-conflicting range index,
            # in begin-key-sorted order of the combined range list
            hits = []
            for i, (rb, re_) in enumerate(tr.read_conflict_ranges):
                if self.history.max_over(rb, re_) > tr.read_snapshot:
                    hits.append((rb, i))
            if hits:
                hist_conflict[t] = True
                if tr.report_conflicting_keys:
                    conflicting.setdefault(t, []).extend(
                        i for _, i in sorted(hits, key=lambda x: x[0])
                    )

        # -- phase 2: intra-batch, sequential in txn order -----------------
        committed_writes: list[tuple[bytes, bytes, int]] = []  # (b, e, txn)
        status = [False] * n  # True = conflicted
        for t, tr in enumerate(txns):
            if hist_conflict[t]:
                status[t] = True
                continue  # reference skips already-conflicted txns entirely
            conflict = too_old[t]
            for i, (rb, re_) in enumerate(tr.read_conflict_ranges):
                hit = any(wb < re_ and rb < we for wb, we, _ in committed_writes)
                if hit:
                    if tr.report_conflicting_keys:
                        conflicting.setdefault(t, []).append(i)
                    conflict = True
                    break  # reference breaks at the first conflicting range
            status[t] = conflict
            if not conflict:
                for wb, we in tr.write_conflict_ranges:
                    if wb < we:
                        committed_writes.append((wb, we, t))

        # -- verdicts (Resolver.actor.cpp:349-356 classification) ----------
        for t in range(n):
            if too_old[t]:
                verdict[t] = TOO_OLD
            elif status[t]:
                verdict[t] = CONFLICT
            else:
                verdict[t] = COMMITTED

        # -- combine + merge committed writes at the batch version ---------
        events = []
        for wb, we, _ in committed_writes:
            events.append((wb, 1))
            events.append((we, -1))
        events.sort(key=lambda x: (x[0], -x[1]))  # begins before ends at ties
        combined: list[tuple[bytes, bytes]] = []
        depth = 0
        start: Optional[bytes] = None
        for key, delta in events:
            if depth == 0 and delta == 1:
                start = key
            depth += delta
            if depth == 0 and delta == -1:
                combined.append((start, key))
        for wb, we in combined:
            self.history.write(wb, we, version)

        # -- MVCC-window GC -------------------------------------------------
        if new_oldest > self.oldest:
            self.oldest = new_oldest
            self.history.gc(self.oldest)

        return OracleBatchResult(verdict, conflicting, combined)


class SequentialModel:
    """In-memory sequential KV model for the full-client API workload
    (testing/api_workload.py) — the MemoryStore role the reference's
    ApiCorrectness workload checks against
    (fdbserver/workloads/ApiCorrectness.actor.cpp / MemoryKeyValueStore).

    Committed transactions are inserted keyed by their 10-byte
    versionstamp (8B big-endian commit version + 2B intra-batch order —
    cluster/commit_proxy._stamp), which totally orders commits exactly
    as the storage servers apply them: version order, then batch order.
    `state_at(version)` replays every commit visible at a read version,
    so a read the real client performed at snapshot `rv` has ONE correct
    answer the model can produce after the fact, even though commits
    were acknowledged to concurrent actors out of order.

    Mutations are the client's own tuples (cluster/client.py
    Transaction.mutations): set / clear / atomic / vs_key / vs_value;
    versionstamped mutations materialize here with the commit's stamp,
    mirroring the proxy's resolution of the placeholder.
    """

    def __init__(self):
        # ascending [(stamp, mutations)] — stamps are unique
        self._commits: list[tuple[bytes, list]] = []

    def apply(self, stamp: bytes, mutations: list) -> None:
        if len(stamp) != 10:
            raise ValueError(f"versionstamp must be 10 bytes, got {stamp!r}")
        i = bisect.bisect_left(self._commits, (stamp,))
        if i < len(self._commits) and self._commits[i][0] == stamp:
            raise ValueError(f"duplicate commit stamp {stamp!r}")
        self._commits.insert(i, (stamp, list(mutations)))

    @staticmethod
    def apply_mutation(state: dict, m: tuple, stamp: bytes) -> None:
        """One client mutation tuple applied to a plain dict state."""
        from foundationdb_tpu_torch.utils.atomic import apply_atomic

        kind = m[0]
        if kind == "set":
            state[m[1]] = m[2]
        elif kind == "clear":
            for k in [k for k in state if m[1] <= k < m[2]]:
                del state[k]
        elif kind == "atomic":
            _, op, key, param = m
            new = apply_atomic(op, state.get(key), param)
            if new is None:
                state.pop(key, None)
            else:
                state[key] = new
        elif kind == "vs_key":
            _, prefix, suffix, value = m
            state[prefix + stamp + suffix] = value
        elif kind == "vs_value":
            _, key, value_prefix = m
            state[key] = value_prefix + stamp
        else:
            raise ValueError(f"unknown mutation {m!r}")

    def state_at(self, version: int) -> dict:
        """The full model state visible to a read at `version` (every
        commit whose version component is <= it)."""
        state: dict[bytes, bytes] = {}
        for stamp, mutations in self._commits:
            if int.from_bytes(stamp[:8], "big") > version:
                break
            for m in mutations:
                self.apply_mutation(state, m, stamp)
        return state

    def final_state(self) -> dict:
        return self.state_at(1 << 62)

    def stamps(self) -> list[bytes]:
        return [s for s, _m in self._commits]


class MultiResolverOracle:
    """n independent ConflictOracles over a keyspace partition.

    Models the reference's multi-resolver deployment exactly: the proxy
    clips each transaction's conflict ranges to every resolver's partition
    (ResolutionRequestBuilder, fdbserver/CommitProxyServer.actor.cpp:
    105-261 — a resolver only sees the pieces inside its key range) and
    combines the per-resolver verdicts with min()
    (determineCommittedTransactions :1551-1567). Each shard oracle keeps
    its own history: a txn that passes on shard A has its writes merged
    there even if shard B aborts it — the reference's phantom-commit
    behavior, preserved deliberately.
    """

    def __init__(self, boundaries: list, window: int = 5_000_000):
        # boundaries: n_shards-1 ascending interior split keys (bytes).
        self.boundaries = list(boundaries)
        self.shards = [ConflictOracle(window) for _ in range(len(boundaries) + 1)]

    def _clip(self, ranges, s: int):
        lo = self.boundaries[s - 1] if s > 0 else b""
        hi = self.boundaries[s] if s < len(self.boundaries) else None
        out = []
        for i, (b, e) in enumerate(ranges):
            cb = max(b, lo)
            ce = e if hi is None else min(e, hi)
            if cb < ce:
                out.append((i, (cb, ce)))
        return out

    def resolve(self, txns: list[OracleTxn], version: int) -> OracleBatchResult:
        n = len(txns)
        verdict = [COMMITTED] * n
        conflicting: dict[int, list[int]] = {}
        for s, shard in enumerate(self.shards):
            local_txns = []
            read_index_maps = []
            for tr in txns:
                reads = self._clip(tr.read_conflict_ranges, s)
                writes = self._clip(tr.write_conflict_ranges, s)
                read_index_maps.append([i for i, _ in reads])
                local_txns.append(
                    OracleTxn(
                        read_conflict_ranges=[r for _, r in reads],
                        write_conflict_ranges=[r for _, r in writes],
                        read_snapshot=tr.read_snapshot,
                        report_conflicting_keys=tr.report_conflicting_keys,
                    )
                )
            res = shard.resolve(local_txns, version)
            for t in range(n):
                verdict[t] = min(verdict[t], res.verdicts[t])
            for t, idxs in res.conflicting_ranges.items():
                remapped = [read_index_maps[t][i] for i in idxs]
                conflicting.setdefault(t, []).extend(remapped)
        conflicting = {
            t: sorted(set(v))
            for t, v in conflicting.items()
            if verdict[t] == CONFLICT
        }
        return OracleBatchResult(verdict, conflicting, [])
