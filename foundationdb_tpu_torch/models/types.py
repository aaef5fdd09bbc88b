"""Wire-level types of the resolution protocol (the port's own copy of
foundationdb_tpu.models.types).

* CommitTransaction ~ CommitTransactionRef
  (fdbclient/include/fdbclient/CommitTransaction.h:378-…): read/write
  conflict ranges, read_snapshot, report_conflicting_keys.
* TransactionResult ~ ConflictBatch::TransactionCommitResult
  (fdbserver/include/fdbserver/ConflictSet.h:41-46).
* ResolveTransactionBatchRequest / Reply ~
  fdbserver/include/fdbserver/ResolverInterface.h:94-155: the version
  chain fields (prevVersion, version, lastReceivedVersion), the
  per-txn committed verdicts and conflictingKeyRangeMap, and the
  state-transaction, private-mutation and version-vector fields.
* is_metadata_mutation / apply_state_mutation: the system-keyspace test
  and the txn-state store update the Resolver's private-mutations path
  runs.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional


class TransactionResult(enum.IntEnum):
    CONFLICT = 0
    TOO_OLD = 1
    TENANT_FAILURE = 2
    COMMITTED = 3


KeyRange = tuple[bytes, bytes]


@dataclasses.dataclass
class CommitTransaction:
    read_conflict_ranges: list[KeyRange] = dataclasses.field(default_factory=list)
    write_conflict_ranges: list[KeyRange] = dataclasses.field(default_factory=list)
    read_snapshot: int = 0
    report_conflicting_keys: bool = False
    mutations: list[Any] = dataclasses.field(default_factory=list)
    lock_aware: bool = False
    debug_id: Optional[str] = None
    span: Optional[tuple] = None

    def validate(self) -> None:
        for b, e in self.read_conflict_ranges + self.write_conflict_ranges:
            if not (isinstance(b, bytes) and isinstance(e, bytes)):
                raise TypeError("conflict range keys must be bytes")
            if b >= e:
                raise ValueError(f"empty conflict range {b!r} >= {e!r}")


@dataclasses.dataclass
class ResolveTransactionBatchRequest:
    prev_version: int          # -1 for the first batch (from the master)
    version: int               # commit version of this batch
    last_received_version: int  # acks outstanding replies below this
    transactions: list[CommitTransaction] = dataclasses.field(default_factory=list)
    # indices into `transactions` of the metadata ("state") transactions,
    # forwarded to every proxy via reply.state_mutations
    # (ResolverInterface.h:103 txnStateTransactions)
    txn_state_transactions: list[int] = dataclasses.field(default_factory=list)
    proxy_id: Optional[str] = None  # stands in for the reply endpoint address
    debug_id: Optional[str] = None
    # the proxy generation's recovery epoch (0 = unfenced)
    epoch: int = 0
    # span context (trace_id, span_id) (ResolverInterface.h:129)
    span: Optional[tuple] = None
    # storage tags written by this batch (ResolverInterface.h:139
    # writtenTags; the version-vector tpcvMap path)
    written_tags: frozenset = frozenset()


@dataclasses.dataclass
class ResolveTransactionBatchReply:
    committed: list[TransactionResult] = dataclasses.field(default_factory=list)
    # txn index -> read-conflict-range indices (only for txns that asked)
    conflicting_key_range_map: dict[int, list[int]] = dataclasses.field(
        default_factory=dict
    )
    # prior-version state transactions the requesting proxy has not
    # seen, one list per version (ResolverInterface.h:141 stateMutations)
    state_mutations: list[Any] = dataclasses.field(default_factory=list)
    # knob-gated (PROXY_USE_RESOLVER_PRIVATE_MUTATIONS): this batch's
    # candidate metadata mutations per local txn index
    # (ResolverInterface.h:143 privateMutations); empty when off
    private_mutations: dict[int, list[Any]] = dataclasses.field(
        default_factory=dict
    )
    debug_id: Optional[str] = None
    # knob-gated (ENABLE_VERSION_VECTOR_TLOG_UNICAST): per written tlog,
    # the previous commit version that touched it
    # (ResolverInterface.h:140-151); empty when off
    tpcv_map: dict[int, int] = dataclasses.field(default_factory=dict)
    written_tags: frozenset = frozenset()


#: the \xff system keyspace prefix (fdbclient/SystemData.cpp)
SYSTEM_PREFIX = b"\xff"


def is_metadata_mutation(m) -> bool:
    """Metadata mutations target the system keyspace (the
    applyMetadataToCommittedTransactions condition,
    fdbserver/CommitProxyServer.actor.cpp:1596)."""
    key = m[2] if m[0] == "atomic" else m[1]
    return key.startswith(SYSTEM_PREFIX)


def apply_state_mutation(store: dict, m) -> None:
    """Apply one metadata mutation to a txn-state store dict."""
    kind = m[0]
    if kind == "set":
        store[m[1]] = m[2]
    elif kind == "clear":
        for k in [k for k in store if m[1] <= k < m[2]]:
            del store[k]
