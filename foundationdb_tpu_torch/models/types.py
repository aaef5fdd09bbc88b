"""Wire-level types of the resolution protocol (the port's own copy of
the two types the conflict set speaks, from foundationdb_tpu.models.types).

* CommitTransaction ~ CommitTransactionRef
  (fdbclient/include/fdbclient/CommitTransaction.h:378-…): read/write
  conflict ranges, read_snapshot, report_conflicting_keys.
* TransactionResult ~ ConflictBatch::TransactionCommitResult
  (fdbserver/include/fdbserver/ConflictSet.h:41-46).
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
