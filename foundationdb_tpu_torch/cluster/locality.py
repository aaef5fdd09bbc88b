"""Locality + replication policies: teams spread across failure domains.

The roles of `fdbrpc/Locality.cpp` (LocalityData: processid / machineid /
zoneid / dcid) and `fdbrpc/ReplicationPolicy.cpp` (IReplicationPolicy —
`PolicyOne`, `PolicyAcross(n, field, inner)`): recruitment and team
building must place replicas across distinct failure domains ("three
replicas across three zoneids"), and validation answers whether a given
team satisfies the policy.

`build_team` is the greedy selector DDTeamCollection uses in spirit:
prefer servers whose addition keeps the policy satisfiable, fail loudly
when the topology cannot satisfy it.

The port's own copy of foundationdb_tpu.cluster.locality.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LocalityData:
    """fdbrpc LocalityData: the standard failure-domain keys."""

    process_id: str
    machine_id: Optional[str] = None
    zone_id: Optional[str] = None
    dc_id: Optional[str] = None

    def get(self, field: str) -> Optional[str]:
        return getattr(self, field)


class PolicyOne:
    """Any single replica satisfies the policy (replication factor 1)."""

    name = "One"

    def validate(self, team: list[LocalityData]) -> bool:
        return len(team) >= 1

    @property
    def min_replicas(self) -> int:
        return 1

    def __repr__(self):
        return "PolicyOne()"


class PolicyAcross:
    """`Across(n, field, inner)`: n groups with DISTINCT values of
    `field`, each group satisfying `inner` (ReplicationPolicy.cpp's
    recursive composition — e.g. Across(2, 'dc_id', Across(2, 'zone_id',
    One())) = two DCs, two zones in each)."""

    def __init__(self, count: int, field: str, inner=None):
        self.count = count
        self.field = field
        self.inner = inner or PolicyOne()

    @property
    def min_replicas(self) -> int:
        return self.count * self.inner.min_replicas

    def validate(self, team: list[LocalityData]) -> bool:
        groups: dict[Optional[str], list[LocalityData]] = {}
        for loc in team:
            groups.setdefault(loc.get(self.field), []).append(loc)
        # None (unset field) never counts as a distinct satisfied group
        ok_groups = sum(
            1
            for key, members in groups.items()
            if key is not None and self.inner.validate(members)
        )
        return ok_groups >= self.count

    def __repr__(self):
        return f"PolicyAcross({self.count}, {self.field!r}, {self.inner!r})"


class PolicyUnsatisfiableError(ValueError):
    pass


def build_team(
    localities: dict[int, LocalityData],
    policy,
    *,
    exclude: frozenset = frozenset(),
    prefer: tuple = (),
) -> tuple:
    """Pick a minimal team of server ids satisfying `policy`.

    Exhaustive minimal-size search in preference order: the first
    satisfying combination of exactly policy.min_replicas servers wins
    (complete — any satisfying superset contains a min-size satisfying
    subset). Worst case O(C(n, r)) validate calls; topologies here are
    small. Raises PolicyUnsatisfiableError if no subset of the live
    topology can satisfy the policy — recruitment must fail loudly,
    never silently under-replicate.
    """
    candidates = [s for s in localities if s not in exclude]
    ordered = [s for s in prefer if s in candidates] + [
        s for s in sorted(candidates) if s not in prefer
    ]
    size = policy.min_replicas
    if size <= len(ordered):
        for combo in itertools.combinations(ordered, size):
            if policy.validate([localities[s] for s in combo]):
                return tuple(sorted(combo))
    raise PolicyUnsatisfiableError(
        f"{policy!r} unsatisfiable over {len(candidates)} servers"
    )


def validate_team(
    team: tuple, localities: dict[int, LocalityData], policy
) -> bool:
    return policy.validate([localities[s] for s in team if s in localities])
