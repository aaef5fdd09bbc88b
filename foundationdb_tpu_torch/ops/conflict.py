"""Per-batch verdict record and verdict codes.

Port of the types in foundationdb_tpu/ops/conflict.py; the classic
single-tier `resolve_batch` is not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Verdict codes — ConflictBatch::TransactionCommitResult
# (fdbserver/include/fdbserver/ConflictSet.h:41-46).
CONFLICT = 0
TOO_OLD = 1
COMMITTED = 3


class BatchVerdict(NamedTuple):
    verdict: torch.Tensor             # [B] int32 (CONFLICT/TOO_OLD/COMMITTED)
    hist_conflict_read: torch.Tensor  # [NR] bool — per read range, history hit
    intra_first_range: torch.Tensor   # [B] int32 — first intra-batch
    #                                   conflicting read-range index, else -1
    committed_count: torch.Tensor     # [] int32
    conflict_count: torch.Tensor      # [] int32
    too_old_count: torch.Tensor       # [] int32
    overflow: torch.Tensor            # [] bool — history capacity exceeded
