"""Interval min-cover: range-update / all-points-read.

Port of foundationdb_tpu/ops/segtree.py `min_cover`: for every leaf, the
smallest value among the intervals that cover it — the intra-batch
fixpoint's "smallest committed writer covering this elementary segment"
(the reference's MiniConflictSet sweep, fdbserver/SkipList.cpp:857-899).

Same two-step doubling cover as the JAX program: each interval lands at
one level k = floor(log2(len)) at two positions, then a downward sweep
pushes every level into the one below. `min_cover` is kernel C
(kernels/csrc/min_cover.cu: the fill, the atomicMin scatter and the sweep
in one launch) on CUDA tensors and `min_cover_plain` on CPU tensors.

`min_cover4` (K19) is the radix-4 form: each interval lands at level
k = floor(log4(len)) at up to four positions, and the sweep has half the
levels. Kernel M's cover on CUDA tensors (kernel C's launch at radix 4,
`mc_cover4` in kernels/csrc/min_cover.cu), `min_cover4_plain` on CPU
tensors; only the reference's experiment scripts reach it.
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
    # the kernel's scratch levels, filled by the kernel itself
    table = torch.empty((log + 1, leaves), dtype=torch.int32,
                        device=val.device)
    kernels.launch("mc_cover", "min_cover", lo, hi, val, lo.shape[0], leaves,
                   table)
    return table[0]


def _cover4_levels(leaves: int) -> int:
    """Radix-4 levels for a power-of-two width: spans 4^0 .. 4^(nlev-1)."""
    return (_check_leaves(leaves) + 1) // 2 + 1


def min_cover4_plain(leaves: int, lo: torch.Tensor, hi: torch.Tensor,
                     val: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel M's cover: [leaves] int32 per-leaf minima
    (INT32_POS where uncovered)."""
    nlev = _cover4_levels(leaves)
    dev = val.device
    lo = lo.to(torch.int64).clamp(0, leaves)
    hi = hi.to(torch.int64).clamp(0, leaves)
    length = hi - lo
    k = torch.clamp(_floor_log2(torch.clamp(length, min=1), 2 * nlev) >> 1,
                    max=nlev - 1)
    s = torch.ones_like(k) << (2 * k)
    valid = length > 0
    # an extra trash level absorbs the updates that touch nothing
    k_idx = torch.where(valid, k, nlev)
    idx = torch.cat([k_idx * leaves + torch.where(
        valid, torch.minimum(lo + j * s, hi - s), 0) for j in range(4)])
    table = torch.full(((nlev + 1) * leaves,), INT32_POS, dtype=torch.int32,
                       device=dev)
    table.scatter_reduce_(0, idx, val.repeat(4), reduce="amin")
    t = table.reshape(nlev + 1, leaves)
    out = t[nlev - 1]
    for j in range(nlev - 1, 0, -1):
        step = 1 << (2 * (j - 1))
        acc = torch.minimum(t[j - 1], out)
        for c in (1, 2, 3):
            sh = c * step
            if sh >= leaves:
                continue
            acc = torch.minimum(acc, torch.cat([
                torch.full((sh,), INT32_POS, dtype=torch.int32, device=dev),
                out[:-sh]]))
        out = acc
    return out


def min_cover4(leaves: int, lo: torch.Tensor, hi: torch.Tensor,
               val: torch.Tensor) -> torch.Tensor:
    """min_cover with the radix-4 level structure (same result):
    lo, hi, val [N] int32 -> [leaves] int32."""
    nlev = _cover4_levels(leaves)
    if not (lo.shape == hi.shape == val.shape) or lo.ndim != 1:
        raise ValueError("min_cover4: lo, hi, val must be [N]")
    if val.device.type == "cpu":
        return min_cover4_plain(leaves, lo, hi, val)
    kernels.check_cuda("min_cover4", lo, hi, val)
    # the kernel's scratch levels, filled by the kernel itself
    table = torch.empty((nlev, leaves), dtype=torch.int32, device=val.device)
    kernels.launch("mc_cover4", "rangemax4.cover", lo, hi, val, lo.shape[0],
                   leaves, table)
    return table[0]
