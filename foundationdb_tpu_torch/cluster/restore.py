"""Parallel restore: controller / loaders / appliers.

Capability match for the reference's parallel (a.k.a. "fast") restore
roles — fdbserver/RestoreController.actor.cpp,
RestoreLoader.actor.cpp, RestoreApplier.actor.cpp: instead of one pass
streaming the whole backup through one transaction, the CONTROLLER
partitions the key space into contiguous ranges (one per applier),
LOADERS parse snapshot/log files concurrently and route each mutation
to the applier owning its key range, and APPLIERS apply their shard's
mutations in version order concurrently. Restore time scales with the
applier count instead of the backup size through one pipe.

CLEAR_RANGE mutations spanning applier boundaries are split at the
boundaries (the loader's splitMutation — RestoreLoader.actor.cpp) so
each applier sees exactly its shard's effect.

The port's own copy of foundationdb_tpu.cluster.restore.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class RestoreStats:
    snapshot_version: int
    restored_version: int
    appliers: int
    mutations_applied: int
    files_loaded: int


def _partition(boundaries: list[bytes], n: int) -> list[tuple[bytes, bytes]]:
    """n contiguous shards over [b"", b"\\xff") using sampled keys."""
    if n <= 1 or len(boundaries) < n:
        return [(b"", b"\xff")]
    step = len(boundaries) // n
    cuts = [boundaries[i * step] for i in range(1, n)]
    # dedup + ordered
    uniq: list[bytes] = []
    for c in cuts:
        if not uniq or c > uniq[-1]:
            uniq.append(c)
    lo = b""
    shards = []
    for c in uniq:
        shards.append((lo, c))
        lo = c
    shards.append((lo, b"\xff"))
    return shards


class ParallelRestore:
    """Drive a parallel restore of `container` into `db`."""

    def __init__(self, db, container, *, n_appliers: int = 4):
        self.db = db
        self.container = container
        self.n_appliers = n_appliers

    async def run(self, *, target_version: Optional[int] = None) -> RestoreStats:
        from foundationdb_tpu_torch.cluster.backup import select_snapshot

        cont = self.container
        base = select_snapshot(cont, target_version)
        manifest = cont.read_file(f"snapshots/{base:016d}/manifest")
        range_files = [
            f"snapshots/{base:016d}/range_{i:06d}"
            for i in range(manifest["files"])
        ]
        log_files = cont.list_files("logs/")

        # ---- controller: sample keys, cut applier shards ----------------
        # sampled files are cached — the loader pass reads them again,
        # and against an object store every read is a full HTTP GET
        file_cache: dict[str, list] = {}
        sample: list[bytes] = []
        for name in range_files[:: max(1, len(range_files) // 8)]:
            kvs = cont.read_file(name)
            file_cache[name] = kvs
            sample.extend(bytes(k) for k, _v in kvs[:: max(1, len(kvs) // 64)])
        sample.sort()
        shards = _partition(sample, self.n_appliers)

        # ---- loaders: parse files, split + route mutations --------------
        # per-applier: {"kvs": [(k, v)], "logs": {version: [mutation]}}
        plans = [
            {"kvs": [], "logs": {}} for _ in shards
        ]

        def owner(key: bytes) -> int:
            for i, (lo, hi) in enumerate(shards):
                if lo <= key < hi:
                    return i
            return len(shards) - 1

        files_loaded = 0
        restored = base
        for name in range_files:
            files_loaded += 1
            kvs = file_cache.pop(name, None)
            if kvs is None:
                kvs = cont.read_file(name)
            for k, v in kvs:
                k = bytes(k)
                plans[owner(k)]["kvs"].append((k, bytes(v)))
        for name in log_files:
            files_loaded += 1
            for vs, msgs in sorted(cont.read_file(name).items()):
                v = int(vs)
                if v <= base:
                    continue
                if target_version is not None and v > target_version:
                    continue
                restored = max(restored, v)
                for m in msgs:
                    kind = m[0]
                    if kind == "set":
                        i = owner(bytes(m[1]))
                        plans[i]["logs"].setdefault(v, []).append(
                            ("set", bytes(m[1]), bytes(m[2]))
                        )
                    elif kind == "atomic":
                        i = owner(bytes(m[2]))
                        plans[i]["logs"].setdefault(v, []).append(
                            ("atomic", m[1], bytes(m[2]), bytes(m[3]))
                        )
                    elif kind == "clear":
                        # splitMutation: clip the clear at shard bounds
                        cb, ce = bytes(m[1]), bytes(m[2])
                        for i, (lo, hi) in enumerate(shards):
                            b = max(cb, lo)
                            e = min(ce, hi)
                            if b < e:
                                plans[i]["logs"].setdefault(v, []).append(
                                    ("clear", b, e)
                                )

        # ---- appliers: one transaction per shard, concurrent ------------
        # The keyspace clear runs FIRST in its own transaction (the
        # reference clears the restore range before applying).
        txn = self.db.create_transaction()
        txn.clear_range(b"", b"\xff")
        await txn.commit()

        sched = self.db.sched
        applied = [0] * len(shards)

        async def apply_shard(i: int) -> None:
            plan = plans[i]
            txn = self.db.create_transaction()
            for k, v in plan["kvs"]:
                txn.set(k, v)
            for v in sorted(plan["logs"]):
                for m in plan["logs"][v]:
                    if m[0] == "set":
                        txn.set(m[1], m[2])
                    elif m[0] == "clear":
                        txn.clear_range(m[1], m[2])
                    elif m[0] == "atomic":
                        txn.atomic_op(m[1], m[2], m[3])
                    applied[i] += 1
            applied[i] += len(plan["kvs"])
            await txn.commit()

        tasks = [
            sched.spawn(apply_shard(i), name=f"restore-applier-{i}")
            for i in range(len(shards))
        ]
        for t in tasks:
            await t.done

        return RestoreStats(
            snapshot_version=base,
            restored_version=restored,
            appliers=len(shards),
            mutations_applied=sum(applied),
            files_loaded=files_loaded,
        )
