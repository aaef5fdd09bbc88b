"""Interval min-cover: range-update / all-points-read.

Port of foundationdb_tpu/ops/segtree.py `min_cover`: for every leaf, the
smallest value among the intervals that cover it — the intra-batch
fixpoint's "smallest committed writer covering this elementary segment"
(the reference's MiniConflictSet sweep, fdbserver/SkipList.cpp:857-899).

Same two-step doubling cover as the JAX program: each interval lands at
one level k = floor(log2(len)) at two positions, then a downward sweep
pushes every level into the one below. `min_cover` is kernel C
(kernels/csrc/min_cover.cu: atomicMin scatter + one launch per sweep
level) on CUDA tensors and `min_cover_plain` on CPU tensors.
"""

from __future__ import annotations

import torch

from foundationdb_tpu_torch import kernels
from foundationdb_tpu_torch.ops.rangemax import INT32_POS, _floor_log2


def _check_leaves(leaves: int) -> int:
    if leaves < 1 or leaves & (leaves - 1):
        raise ValueError(f"leaves must be a power of two, got {leaves}")
    return leaves.bit_length() - 1


def min_cover_plain(leaves: int, lo: torch.Tensor, hi: torch.Tensor,
                    val: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel C: [leaves] int32 per-leaf minima
    (INT32_POS where uncovered)."""
    log = _check_leaves(leaves)
    levels = log + 1
    dev = val.device
    lo = lo.to(torch.int64).clamp(0, leaves)
    hi = hi.to(torch.int64).clamp(0, leaves)
    length = hi - lo
    k = _floor_log2(torch.clamp(length, min=1), levels)
    valid = length > 0
    # an extra trash level absorbs the updates that touch nothing
    k_idx = torch.where(valid, k, levels)
    pos1 = torch.where(valid, lo, 0)
    pos2 = torch.where(valid, hi - (torch.ones_like(k) << k), 0)
    table = torch.full(((levels + 1) * leaves,), INT32_POS, dtype=torch.int32,
                       device=dev)
    idx = torch.cat([k_idx * leaves + pos1, k_idx * leaves + pos2])
    table.scatter_reduce_(0, idx, torch.cat([val, val]), reduce="amin")
    t = table.reshape(levels + 1, leaves)
    out = t[log]
    for j in range(log, 0, -1):
        half = 1 << (j - 1)
        shifted = torch.cat([
            torch.full((half,), INT32_POS, dtype=torch.int32, device=dev),
            out[:-half],
        ])
        out = torch.minimum(t[j - 1], torch.minimum(out, shifted))
    return out


def min_cover(leaves: int, lo: torch.Tensor, hi: torch.Tensor,
              val: torch.Tensor) -> torch.Tensor:
    """For each leaf v in [0, leaves): min val[j] over lo[j] <= v < hi[j].

    lo, hi, val: [N] int32; intervals with lo >= hi (after clipping to
    [0, leaves]) touch nothing. Returns [leaves] int32.
    """
    log = _check_leaves(leaves)
    if not (lo.shape == hi.shape == val.shape) or lo.ndim != 1:
        raise ValueError("min_cover: lo, hi, val must be [N]")
    if val.device.type == "cpu":
        return min_cover_plain(leaves, lo, hi, val)
    kernels.check_cuda("min_cover", lo, hi, val)
    table = torch.full((log + 1, leaves), INT32_POS, dtype=torch.int32,
                       device=val.device)
    kernels.launch("mc_scatter", "min_cover", lo, hi, val, lo.shape[0],
                   leaves, table)
    for j in range(log, 0, -1):
        kernels.launch("mc_sweep_level", "min_cover", table, leaves, j)
    return table[0]
