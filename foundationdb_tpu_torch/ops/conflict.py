"""The classic single-tier batch kernel, its verdict record and codes.

Port of foundationdb_tpu/ops/conflict.py (K15): `resolve_batch` is the
G=1 specialisation of the group kernel (ops/group.resolve_group) on one
history tier, returning a BatchVerdict.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


def resolve_batch(state, batch: dict, *, fixpoint_unroll: int = 3,
                  stats=None):
    """One resolver batch: (history, packed batch) -> (history',
    BatchVerdict), exact.

    `state` is an ops.history.VersionHistory; `batch` is one
    `PackedBatch.device_args()` dict (numpy, or tensors already on the
    state's device). The committed writes merge into the returned
    history at the batch version, with GC at its floor.
    """
    # imported here: ops/group imports this module's verdict codes
    from foundationdb_tpu_torch import interop
    from foundationdb_tpu_torch.ops import group as G

    stacked = {k: v[None] if isinstance(v, torch.Tensor)
               else np.asarray(v)[None] for k, v in batch.items()}
    g = interop.device_args_to_torch(stacked, state.main_ver.device)
    state2, out = G.resolve_group(state, g, fixpoint_unroll=fixpoint_unroll,
                                  stats=stats)
    return state2, BatchVerdict(*(getattr(out, f)[0]
                                  for f in BatchVerdict._fields))
