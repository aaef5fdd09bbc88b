"""ShardMap: the keyServers mapping — key range -> owning storage team.

Behavioral mirror of the reference's `keyServers/` system mapping
(fdbclient/SystemData.cpp; consulted by proxies when tagging mutations,
CommitProxyServer.actor.cpp:1861, and by clients when routing reads):
a sorted list of boundaries with an owner TEAM per segment (the
reference's storage teams — every replica of a shard receives its
mutations and can serve its reads), supporting the split/move operations
DataDistribution performs via MoveKeys (fdbserver/MoveKeys.actor.cpp).

Owners are tuples of server ids; single-replica maps are teams of one.

The port's own copy of foundationdb_tpu.cluster.shardmap.
"""

from __future__ import annotations

import bisect


def _team(owner) -> tuple:
    return tuple(owner) if isinstance(owner, (tuple, list)) else (owner,)


class ShardMap:
    def __init__(self, boundaries: list[bytes], owners: list):
        """segment i = [boundaries[i-1], boundaries[i]) owned by team
        owners[i]; boundaries has len(owners)-1 interior split keys."""
        if len(owners) != len(boundaries) + 1:
            raise ValueError("need len(owners) == len(boundaries) + 1")
        # MoveKeys dual-tag state (the serverKeys intermediate state):
        # mutations in [begin, end) ALSO tag to `tag` while a move is in
        # flight. Lives on the SHARED map — not on the proxies — so a
        # recovery that recruits a new proxy generation cannot silently
        # drop in-flight dual-tagging (a 2000-seed ensemble found
        # exactly that data loss).
        self.extra_tag_ranges: list[tuple[bytes, bytes, int]] = []
        self.boundaries = list(boundaries)
        self.owners = [_team(o) for o in owners]

    @classmethod
    def even(cls, boundaries: list[bytes], *, replication: int = 1,
             n_servers: int = None, localities: dict = None,
             policy=None) -> "ShardMap":
        """Even key split. With `localities` (server id -> LocalityData)
        and a replication `policy` (cluster/locality.py), every team is
        built to satisfy the policy — replicas across distinct failure
        domains, DDTeamCollection-style — rotating the preference so load
        spreads. Without a policy: simple rotation (legacy behavior).
        """
        n_shards = len(boundaries) + 1
        n_servers = n_servers or n_shards
        if replication > n_servers:
            raise ValueError(
                f"replication {replication} > n_servers {n_servers} would "
                "put the same server on a team twice"
            )
        if policy is not None:
            from foundationdb_tpu_torch.cluster.locality import build_team

            assert localities is not None, "policy needs localities"
            server_ids = sorted(localities)
            owners = [
                build_team(
                    localities, policy,
                    prefer=tuple(
                        server_ids[(i + j) % len(server_ids)]
                        for j in range(len(server_ids))
                    ),
                )
                for i in range(n_shards)
            ]
        else:
            owners = [
                tuple((i + j) % n_servers for j in range(replication))
                for i in range(n_shards)
            ]
        return cls(boundaries, owners)

    # -- lookup (keyServers reads) ----------------------------------------

    def team_of(self, key: bytes) -> tuple:
        return self.owners[bisect.bisect_right(self.boundaries, key)]

    def range_of(self, key: bytes) -> tuple[bytes, bytes, tuple]:
        """(begin, end, team) of the FULL shard containing `key`; end is
        b"" for the last segment (unbounded). The client location cache
        stores whole shard ranges — a clipped sub-range would make range
        reads crawl key-by-key (getKeyLocation returns the full shard
        boundary in the reference too, NativeAPI.actor.cpp:2969)."""
        i = bisect.bisect_right(self.boundaries, key)
        b = self.boundaries[i - 1] if i > 0 else b""
        e = self.boundaries[i] if i < len(self.boundaries) else b""
        return b, e, self.owners[i]

    def shard_of(self, key: bytes) -> int:
        """Primary member of the owning team (single-replica callers)."""
        return self.team_of(key)[0]

    def teams_of_range(self, begin: bytes, end: bytes) -> list[tuple]:
        lo = bisect.bisect_right(self.boundaries, begin)
        hi = bisect.bisect_left(self.boundaries, end)
        return sorted(set(self.owners[lo : hi + 1]))

    def tags_of_range(self, begin: bytes, end: bytes) -> list[int]:
        """Every server holding any part of [begin, end)."""
        out = set()
        for team in self.teams_of_range(begin, end):
            out.update(team)
        return sorted(out)

    def shards_of_range(self, begin: bytes, end: bytes) -> list[int]:
        """Primary members only (single-replica read routing)."""
        return sorted({t[0] for t in self.teams_of_range(begin, end)})

    def ranges(self) -> list[tuple[bytes, bytes, int]]:
        """[(begin, end, owner)]; end=None for the last segment."""
        out = []
        for i, owner in enumerate(self.owners):
            b = self.boundaries[i - 1] if i > 0 else b""
            e = self.boundaries[i] if i < len(self.boundaries) else None
            out.append((b, e, owner))
        return out

    def segments_in(self, begin: bytes, end: bytes):
        """Segments (clipped) intersecting [begin, end)."""
        out = []
        for b, e, owner in self.ranges():
            cb = max(b, begin)
            ce = end if e is None else min(e, end)
            if cb < ce:
                out.append((cb, ce, owner))
        return out

    # -- mutation (MoveKeys) ----------------------------------------------

    def split(self, key: bytes) -> None:
        """Insert a boundary at `key` (no ownership change)."""
        i = bisect.bisect_right(self.boundaries, key)
        if i > 0 and self.boundaries[i - 1] == key:
            return
        self.boundaries.insert(i, key)
        self.owners.insert(i, self.owners[i])

    def move(self, begin: bytes, end: bytes, new_owner) -> None:
        """Assign [begin, end) to team new_owner (splitting as needed);
        end=None means to the end of the keyspace."""
        new_owner = _team(new_owner)
        if not new_owner or len(set(new_owner)) != len(new_owner):
            raise ValueError(f"invalid team {new_owner!r}")
        if begin:
            self.split(begin)
        if end is not None:
            self.split(end)
        # After splitting, every segment lies entirely in or out of range.
        for i in range(len(self.owners)):
            seg_begin = self.boundaries[i - 1] if i > 0 else b""
            if seg_begin >= begin and (end is None or seg_begin < end):
                self.owners[i] = new_owner
        self._coalesce()

    def _coalesce(self) -> None:
        """Merge adjacent segments with the same owner."""
        i = 0
        while i < len(self.boundaries):
            if self.owners[i] == self.owners[i + 1]:
                del self.boundaries[i]
                del self.owners[i + 1]
            else:
                i += 1
