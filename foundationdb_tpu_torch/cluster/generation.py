"""Generation/epoch state machine shared by sim and wire recovery (the
port's own copy of foundationdb_tpu.cluster.generation).

The reference rebuilds the transaction system as a unit in a new
generation on any transaction-path failure (ClusterRecovery.actor.cpp,
states in RecoveryState.h:31-41). In the JAX package two deployments
replay that shape, the deterministic sim and the wire cluster
controller, and this module is the one place their shared semantics
live. The port's controller and workers, which walk it, are not
ported yet; its roles use the fencing contract today:

* the recovery state names (RecoveryState.h vocabulary) and the
  `MasterRecoveryState` trace-event shape, so one reconstructor
  (`recovery_timeline_from_trace`) reads any deployment's trace;
* the recovery-version rule (strictly above anything the old
  generation could have allocated, plus the MAX_VERSIONS_IN_FLIGHT
  safety gap);
* the conservative whole-keyspace blind write the new generation's
  first batch carries, so every in-flight transaction whose read
  snapshot predates recovery aborts (the reference's lastEpochEnd
  conflict range);
* the stale-epoch rejection contract: traffic from a pre-recovery
  generation is fenced by epoch (a retryable error with a recognizable
  marker), never by luck.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.utils.trace import TraceEvent

# ---------------------------------------------------------------------------
# Recovery states (RecoveryState.h names, the subset both deployments
# walk; values are the StatusCode strings the trace events carry).

READING_TRANSACTION_SYSTEM_STATE = "reading_transaction_system_state"
LOCKING_OLD_TRANSACTION_SERVERS = "locking_old_transaction_servers"
RECRUITING_TRANSACTION_SERVERS = "recruiting_transaction_servers"
RECOVERY_TRANSACTION = "recovery_transaction"
ACCEPTING_COMMITS = "accepting_commits"
FULLY_RECOVERED = "fully_recovered"

#: canonical walk order — a recovery timeline must visit these in order
#: (later entries may be skipped only if the recovery failed/restarted)
RECOVERY_STATES = (
    READING_TRANSACTION_SYSTEM_STATE,
    LOCKING_OLD_TRANSACTION_SERVERS,
    RECRUITING_TRANSACTION_SERVERS,
    RECOVERY_TRANSACTION,
    ACCEPTING_COMMITS,
    FULLY_RECOVERED,
)

#: the reference's MAX_VERSIONS_IN_FLIGHT safety gap: new-generation
#: versions can never collide with anything the old one allocated
RECOVERY_VERSION_GAP = 1_000_000

#: the conservative-abort blind write: the whole keyspace, so any
#: in-flight transaction with a pre-recovery read snapshot conflicts
CONSERVATIVE_ABORT_RANGE = (b"", b"\xff\xff")

#: error-message marker for generation fencing; carried inside the
#: RemoteError repr across the wire, matched by is_stale_epoch()
STALE_EPOCH_MARKER = "stale_epoch"

#: recovery-reason prefix for ELASTIC topology changes: the
#: controller recruits one more instance of the role the Ratekeeper's
#: binding limiter names, via the SAME generation-bumped recovery walk
#: any configuration change drives (the reference's
#: configuration-change-causes-recovery discipline). The drill and the
#: perf ledger pin the prefix the way the chaos smoke pins "push:".
ELASTIC_REASON_PREFIX = "elastic:"


def elastic_reason(kind: str, new_count: int) -> str:
    """The recovery reason an elastic recruit records, e.g.
    "elastic:resolver->2" — reconstructable from the controller trace
    like any other recovery reason."""
    return f"{ELASTIC_REASON_PREFIX}{kind}->{new_count}"


def is_elastic_reason(reason) -> bool:
    return str(reason or "").startswith(ELASTIC_REASON_PREFIX)


def recovery_version_for(*durable_versions: int) -> int:
    """The new generation's recovery version: strictly above anything
    any role has seen, plus the safety gap."""
    return max((0, *durable_versions)) + RECOVERY_VERSION_GAP


def conservative_recovery_transaction(recovery_version: int) -> CommitTransaction:
    """The new generation's FIRST commit: a blind write over the whole
    keyspace at the recovery version. It has no reads, so it always
    commits; registering the write in the (empty) new resolvers makes
    every later transaction whose read snapshot predates recovery
    conflict — the reference's recovery-transaction semantics."""
    return CommitTransaction(
        write_conflict_ranges=[CONSERVATIVE_ABORT_RANGE],
        read_snapshot=recovery_version,
    )


def stale_epoch_message(req_epoch: int, current_epoch: int) -> str:
    """The fencing rejection string (travels inside RemoteError)."""
    return (
        f"{STALE_EPOCH_MARKER}: request epoch {req_epoch} != "
        f"current generation {current_epoch}"
    )


def is_stale_epoch(err) -> bool:
    """True if an exception (or its string form) is a generation-fence
    rejection — the RETRYABLE signal: refresh the topology/epoch from
    the controller and retry at the new generation."""
    return STALE_EPOCH_MARKER in str(err)


# ---------------------------------------------------------------------------
# The state machine object both recovery walks hold.


@dataclasses.dataclass
class GenerationState:
    """Epoch counter + recovery-state tracker.

    `transition()` is the ONE emitter of the `MasterRecoveryState`
    trace event (Epoch + StatusCode details — the reference's event
    shape), and records the (time, epoch, status) triple on a bounded
    in-memory timeline, so sim and wire recoveries are reconstructable
    through the same vocabulary."""

    epoch: int = 1
    status: str = FULLY_RECOVERED
    recovery_version: int = 0
    #: injected clock (sim passes the virtual scheduler clock; wire
    #: passes time.time so timelines merge with wall-clock trace files)
    clock: Optional[Callable[[], float]] = None
    timeline_cap: int = 64

    def __post_init__(self):
        self.timeline: list[tuple[float, int, str]] = []
        if self.clock is None:
            # wall clock by REFERENCE (never called in sim: every sim
            # construction injects the virtual scheduler clock)
            import time as _time

            self.clock = _time.time

    def _now(self) -> float:
        return self.clock()

    def begin_recovery(self, *, floor: int = 0) -> int:
        """Bump to the next generation (monotonic past `floor`, e.g. a
        persisted epoch from a previous controller incarnation) and
        enter the recovery walk. Returns the new epoch."""
        self.epoch = max(self.epoch + 1, floor + 1)
        self.transition(READING_TRANSACTION_SYSTEM_STATE)
        return self.epoch

    def transition(self, status: str, **details) -> None:
        if status not in RECOVERY_STATES:
            raise ValueError(f"unknown recovery state {status!r}")
        self.status = status
        self.timeline.append((self._now(), self.epoch, status))
        del self.timeline[: -self.timeline_cap]
        ev = TraceEvent("MasterRecoveryState").detail(
            "Epoch", self.epoch
        ).detail("StatusCode", status)
        for k, v in details.items():
            ev.detail(k, v)
        ev.log()

    def timeline_dicts(self) -> list[dict]:
        """The in-memory timeline as JSON-able rows (status payloads)."""
        return [
            {"time": round(t, 6), "epoch": e, "status": s}
            for t, e, s in self.timeline
        ]


def recovery_timeline_from_trace(records: list[dict]) -> list[dict]:
    """Reconstruct the recovery epoch timeline from trace records (the
    rows of a JSONL trace file, one dict a line): every
    MasterRecoveryState event as {"time", "epoch", "status"}, time-
    ordered — works on sim and wire trace files alike because
    GenerationState.transition is the one emitter."""
    rows = [
        {
            "time": float(r.get("Time", 0.0)),
            "epoch": int(r.get("Epoch", 0)),
            "status": r.get("StatusCode", ""),
        }
        for r in records
        if r.get("Type") == "MasterRecoveryState"
    ]
    rows.sort(key=lambda r: (r["time"], r["epoch"]))
    return rows
