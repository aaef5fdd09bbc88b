"""Coordination quorum: generation-based CoordinatedState + leader election.

The role of `fdbserver/Coordination.actor.cpp:864` (coordinationServer),
`CoordinatedState.actor.cpp`, and `LeaderElection.actor.cpp`: N small
replicated registers whose generation protocol makes cluster recovery
safe across real failures — a new ClusterController can only take over by
writing through a MAJORITY of coordinators with a generation strictly
above anything previously seen, so two generations can never both think
they own the cluster, and the cluster survives any minority of
coordinators dying.

Protocol (the reference's two-phase generation discipline):

* Each coordinator holds `(read_gen, write_gen, value)`.
* **Phase 1 (lock)**: the client picks a candidate generation above every
  generation it has seen and asks a majority to raise `read_gen` to it; a
  coordinator refuses if it already promised a higher read_gen. The
  replies carry each coordinator's current `(write_gen, value)`; the
  client adopts the value with the highest write_gen — the one a prior
  writer may have committed through a majority.
* **Phase 2 (write)**: the client writes `(value, gen)` to a majority;
  a coordinator refuses if its read_gen moved past the client's gen.
  Success means any later generation's phase 1 will see this value.

Leader election rides on it: candidates CAS themselves in with a lease;
the recovery epoch lock is a CoordinatedState write, so a deposed CC's
epoch bump fails loudly (the `CoordinatorsChangedError`/stale-generation
path in the reference).

Everything runs on the deterministic simulator's scheduler, so quorum
races are reproducible per seed.

The port's own copy of foundationdb_tpu.cluster.coordination.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from foundationdb_tpu_torch.runtime.flow import Scheduler
from foundationdb_tpu_torch.utils.probes import code_probe, declare
from foundationdb_tpu_torch.utils.trace import TraceEvent

declare(
    "coordination.stale_generation",
    "coordination.quorum_unreachable",
    "coordination.racing_writer_detected",
)


class CoordinatorDead(Exception):
    """This coordinator process is down; requests fail."""


class QuorumUnreachable(Exception):
    """Fewer than a majority of coordinators answered."""


class StaleGeneration(Exception):
    """A higher generation was seen; this client must retry or yield.

    Carries the highest promised generation so the refused client can
    advance its own counter (the reference clients learn generations from
    refusals the same way)."""

    def __init__(self, msg: str, promised: "Generation" = None):
        super().__init__(msg)
        self.promised = promised


@dataclasses.dataclass(order=True)
class Generation:
    """Totally ordered (count, client_id) — unique per attempt."""

    count: int = 0
    client_id: str = ""


class Coordinator:
    """One coordinator: a generation-guarded register (+ leader lease).

    The per-process state `coordinationServer` keeps in its OnDemandStore;
    `kill()`/`revive()` are the fault-injection hooks.
    """

    def __init__(self, name: str):
        self.name = name
        self.read_gen = Generation()
        self.write_gen = Generation()
        self.value: Any = None
        self.alive = True

    # -- fault injection -------------------------------------------------

    def kill(self) -> None:
        self.alive = False

    def revive(self) -> None:
        # state survives (on-disk in the reference); only liveness toggles
        self.alive = True

    def _check(self) -> None:
        if not self.alive:
            raise CoordinatorDead(self.name)

    # -- the generation protocol (server side) ---------------------------

    async def lock(self, gen: Generation):
        """Phase 1: promise not to accept writes below `gen`."""
        self._check()
        if gen < self.read_gen:
            raise StaleGeneration(
                f"{self.name}: promised {self.read_gen}", self.read_gen
            )
        self.read_gen = gen
        return (self.write_gen, self.value)

    async def write(self, gen: Generation, value: Any):
        """Phase 2: accept iff no higher generation was promised."""
        self._check()
        if gen < self.read_gen:
            raise StaleGeneration(
                f"{self.name}: promised {self.read_gen}", self.read_gen
            )
        self.read_gen = gen
        self.write_gen = gen
        self.value = value
        return True


class CoordinatedState:
    """Client driver: majority read/write over the coordinators.

    One instance per logical client (e.g. a would-be cluster controller).
    The reference equivalent is CoordinatedState.actor.cpp's
    read()/setExclusive() pair.
    """

    def __init__(self, sched: Scheduler, coordinators: list[Coordinator],
                 client_id: str):
        self.sched = sched
        self.coordinators = coordinators
        self.client_id = client_id
        self._seen = Generation()
        self._read_wgen = Generation()  # newest write_gen seen by read()

    @property
    def majority(self) -> int:
        return len(self.coordinators) // 2 + 1

    async def _ask_all(self, fn_name: str, *args) -> list:
        """Call fn on every coordinator; collect successes/refusals."""
        oks, stale = [], []
        for c in self.coordinators:
            try:
                oks.append(await getattr(c, fn_name)(*args))
            except CoordinatorDead:
                continue
            except StaleGeneration as e:
                stale.append(e)
        if stale:
            code_probe(True, "coordination.stale_generation")
            # someone promised higher: this client's generation is dead.
            # Adopt the highest promised count so the next attempt can win.
            top = max(
                (e.promised for e in stale if e.promised is not None),
                default=None,
            )
            if top is not None and top.count > self._seen.count:
                self._seen = Generation(top.count, self.client_id)
            raise StaleGeneration(str(stale[0]), top)
        if len(oks) < self.majority:
            code_probe(True, "coordination.quorum_unreachable")
            raise QuorumUnreachable(
                f"{len(oks)}/{len(self.coordinators)} answered"
            )
        return oks

    def _next_gen(self) -> Generation:
        self._seen = Generation(self._seen.count + 1, self.client_id)
        return self._seen

    async def read(self) -> Any:
        """Majority read: lock a fresh generation, adopt the newest value.

        Retries with an advanced counter when refused — a read carries no
        conditional intent, so retrying after a refusal is always safe."""
        for _attempt in range(8):
            gen = self._next_gen()
            try:
                replies = await self._ask_all("lock", gen)
            except StaleGeneration:
                continue  # counter advanced by _ask_all; try again
            best_gen, best_val = Generation(), None
            for wgen, val in replies:
                if wgen >= best_gen and val is not None:
                    best_gen, best_val = wgen, val
            self._read_wgen = best_gen
            return best_val
        raise StaleGeneration("read outran by other clients 8 times")

    async def write(self, value: Any) -> None:
        """Exclusive conditional write: lock, verify nothing was committed
        since our last read(), then commit through a majority — the
        read-modify-write atomicity of the reference's setExclusive.
        Raises StaleGeneration if any higher generation locked OR any
        coordinator committed a value newer than our read (a racing
        client won; caller must re-read the world)."""
        gen = self._next_gen()
        replies = await self._ask_all("lock", gen)
        for wgen, _val in replies:
            # the generation LOCK protects the wait below, not a
            # re-read: once every coordinator holds our gen, a racing
            # writer either lost (lower gen, rejected) or makes OUR
            # write fail StaleGeneration — the reference's setExclusive
            # atomicity argument
            if code_probe(wgen > self._read_wgen,  # flowcheck: ignore[flow.stale-read-across-wait]
                          "coordination.racing_writer_detected"):
                raise StaleGeneration(
                    f"value committed at {wgen} since our read at "
                    f"{self._read_wgen}"
                )
        await self._ask_all("write", gen, value)
        self._read_wgen = gen


@dataclasses.dataclass
class LeaderLease:
    leader: str
    epoch: int
    expires: float  # simulator time


class LeaderElection:
    """Lease-based leader election over CoordinatedState.

    Candidates race to write themselves as the leader; the committed
    write through a majority is the decision (LeaderElection.actor.cpp's
    candidacy). The leader renews its lease; on expiry any candidate may
    take over with a higher epoch. Safety comes from the generation
    protocol: two candidates cannot both commit the same epoch.
    """

    def __init__(self, sched: Scheduler, coordinators: list[Coordinator],
                 candidate_id: str, *, lease: float = 2.0):
        self.sched = sched
        self.cs = CoordinatedState(sched, coordinators, candidate_id)
        self.candidate_id = candidate_id
        self.lease = lease

    async def try_become_leader(self) -> Optional[LeaderLease]:
        """One election attempt; returns the lease if won, None if a live
        leader exists or the attempt was raced out."""
        try:
            cur: Optional[LeaderLease] = await self.cs.read()
            now = self.sched.now()
            if (
                cur is not None
                and cur.leader != self.candidate_id
                and cur.expires > now
            ):
                return None  # live leader elsewhere
            epoch = (cur.epoch if cur else 0) + 1
            lease = LeaderLease(
                leader=self.candidate_id, epoch=epoch,
                expires=now + self.lease,
            )
            await self.cs.write(lease)
            TraceEvent("LeaderElected").detail("Leader", self.candidate_id) \
                .detail("Epoch", epoch).log()
            return lease
        except (StaleGeneration, QuorumUnreachable):
            return None

    async def bump_epoch(self, held: LeaderLease) -> Optional[LeaderLease]:
        """Commit an epoch bump through the quorum while holding the
        lease — the recovery epoch lock (a deposed leader fails here).
        Returns the new lease, or None if leadership was lost."""
        try:
            cur: Optional[LeaderLease] = await self.cs.read()
            if cur is None or cur.leader != self.candidate_id \
                    or cur.epoch != held.epoch:
                return None
            bumped = LeaderLease(
                leader=self.candidate_id, epoch=held.epoch + 1,
                expires=self.sched.now() + self.lease,
            )
            await self.cs.write(bumped)
            return bumped
        except (StaleGeneration, QuorumUnreachable):
            return None

    async def renew(self, held: LeaderLease) -> Optional[LeaderLease]:
        """Extend the lease; None means leadership was lost."""
        try:
            cur: Optional[LeaderLease] = await self.cs.read()
            if cur is None or cur.leader != self.candidate_id \
                    or cur.epoch != held.epoch:
                return None
            renewed = LeaderLease(
                leader=self.candidate_id, epoch=held.epoch,
                expires=self.sched.now() + self.lease,
            )
            await self.cs.write(renewed)
            return renewed
        except (StaleGeneration, QuorumUnreachable):
            return None
