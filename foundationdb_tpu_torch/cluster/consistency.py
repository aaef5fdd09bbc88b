"""Consistency checking: storage/shard-map integrity + replica equality.

Behavioral mirror of the reference's ConsistencyCheck workload /
ConsistencyScan role (fdbserver/workloads/ConsistencyCheck.actor.cpp,
fdbserver/ConsistencyScan.actor.cpp): verifies the structural invariants
that shard moves and MVCC maintenance must preserve, and — for
replicated shards — that every live team member holds identical data
for its segments (the reference's core replica comparison), at a
quiescent point.

The port's own copy of foundationdb_tpu.cluster.consistency.
"""

from __future__ import annotations


class ConsistencyError(AssertionError):
    pass


def check_cluster(cluster) -> dict:
    """Run all invariant checks; returns stats, raises ConsistencyError."""
    sm = cluster.key_servers
    stats = {"keys_checked": 0, "shards_checked": 0, "replica_compares": 0}

    # shard map well-formed: boundaries strictly ascending, owners valid
    for a, b in zip(sm.boundaries, sm.boundaries[1:]):
        if not a < b:
            raise ConsistencyError(f"shard boundaries out of order: {a} {b}")
    n_storage = len(cluster.storage_servers)
    for team in sm.owners:
        for o in team:
            if not 0 <= o < n_storage:
                raise ConsistencyError(f"shard owner {o} out of range")

    owned: dict[int, list] = {s: [] for s in range(n_storage)}
    for b, e, team in sm.ranges():
        for o in team:
            owned[o].append((b, e))
        stats["shards_checked"] += 1

    # replica comparison: all LIVE members of a team agree per segment
    def seg_data(s: int, b: bytes, e) -> dict:
        d = cluster.storage_servers[s]._data
        return {k: v for k, v in d.items() if k >= b and (e is None or k < e)}

    for b, e, team in sm.ranges():
        live = [s for s in team if cluster.storage_live[s]]
        if len(live) > 1:
            base = seg_data(live[0], b, e)
            for s in live[1:]:
                if seg_data(s, b, e) != base:
                    raise ConsistencyError(
                        f"replica divergence in [{b!r}, {e!r}): "
                        f"storage{live[0]} vs storage{s}"
                    )
                stats["replica_compares"] += 1

    for s, ss in enumerate(cluster.storage_servers):
        if not cluster.storage_live[s]:
            continue  # dead replicas keep stale data until repaired/rebooted
        live = 0
        for k in ss._keys:
            h = ss._hist[k]
            # histories strictly version-ascending
            for (v1, _), (v2, _) in zip(h, h[1:]):
                if not v1 < v2:
                    raise ConsistencyError(
                        f"storage{s} key {k!r}: history out of order"
                    )
            if h[-1][1] is not None:
                live += 1
                # every live key must be in a shard this server owns OR
                # in a still-installing fetch range
                in_owned = any(
                    b <= k and (e is None or k < e) for b, e in owned[s]
                )
                in_fetch = any(
                    b <= k < e for (b, e) in ss._fetching
                )
                if not (in_owned or in_fetch):
                    raise ConsistencyError(
                        f"storage{s} holds live key {k!r} outside its shards"
                    )
            stats["keys_checked"] += 1
        if live != ss._live_count:
            raise ConsistencyError(
                f"storage{s} live_count {ss._live_count} != recount {live}"
            )
    return stats
