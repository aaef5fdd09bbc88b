"""Delta-tiered conflict resolution: the port's main path.

Port of foundationdb_tpu/ops/delta.py for the exact configuration
(dedup_reads=0, no range sweep). History is two tiers:

* `main` — the big compacted tier, immutable during a group: its
  range-max table is built once per group (kernel B) and every batch
  probes it with kernel A's fused probe;
* `delta` — the boundaries written since the last compaction: each
  batch resolves against it with the exact group kernel at G=1
  (ops/group.resolve_group) and merges its committed writes into it.

`resolve_group_tiered` is a host loop over the group's batches (the JAX
program's lax.scan); `compact` folds delta into main with kernel D.
Decisions are bit-identical to the JAX tiered kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.ops import group as G
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.ops import rangemax

VERSION_NEG = H.VERSION_NEG

# sanity bound on the group size, as the JAX package's MAX_GROUP_TIERED
MAX_GROUP_TIERED = 64


class TieredState(NamedTuple):
    """Two-tier MVCC write history: immutable-per-group main + delta."""

    main: H.VersionHistory
    delta: H.VersionHistory


def init(config: KernelConfig, device) -> TieredState:
    d = config.delta_capacity
    if d <= 0:
        raise ValueError("tiered state requires config.delta_capacity > 0")
    return TieredState(
        main=H.init(config, device),
        delta=H.empty(d, config.key_words, device),
    )


def batch_body(main: H.VersionHistory, main_tab: torch.Tensor,
               delta: H.VersionHistory, xs: dict, b: int, *,
               fixpoint_unroll: int = 3, stats: G.FixpointStats = None):
    """One batch of the tiered loop: probe the immutable main tier, then
    resolve against (and merge committed writes into) the delta tier.

    xs = one batch's arguments (no leading axis); b = the txn capacity.
    Returns (delta', GroupVerdict with [1]-leading leaves).
    """
    # per-read snapshots (padding rows carry read_txn == b)
    snap_pad = torch.cat([
        xs["snapshot"],
        torch.full((1,), VERSION_NEG, dtype=torch.int32,
                   device=xs["snapshot"].device),
    ])
    rsnap = snap_pad[xs["read_txn"].to(torch.int64).clamp(0, b)]
    vmax = H.query_reads_vmax(main, xs["read_begin"], xs["read_end"],
                              main_tab)
    stale_main = (vmax > rsnap) & xs["read_valid"]
    g1 = {k: (v[None] if isinstance(v, torch.Tensor) else [v])
          for k, v in xs.items()}
    return G.resolve_group(delta, g1, fixpoint_unroll=fixpoint_unroll,
                           extra_stale=stale_main[None], stats=stats)


def resolve_group_tiered(state: TieredState, g: dict, *,
                         fixpoint_unroll: int = 3,
                         stats: G.FixpointStats = None):
    """Resolve G stacked batches (versions ascending) against the tiered
    history. Returns (state', GroupVerdict with [G]-leading leaves)."""
    gn, b = g["txn_valid"].shape
    if gn > MAX_GROUP_TIERED:
        raise ValueError(f"group of {gn} > MAX_GROUP_TIERED {MAX_GROUP_TIERED}")
    # main is immutable for the whole group: one table build
    main_tab = rangemax.build(state.main.main_ver, op="max")
    delta = state.delta
    outs = []
    for i in range(gn):
        xs = {k: v[i] for k, v in g.items()}
        delta, out = batch_body(state.main, main_tab, delta, xs, b,
                                fixpoint_unroll=fixpoint_unroll, stats=stats)
        outs.append(out)
    cat = {f: torch.cat([getattr(o, f) for o in outs])
           for f in G.GroupVerdict._fields}
    cat["overflow"] = cat["overflow"] | state.main.overflow
    return TieredState(main=state.main, delta=delta), G.GroupVerdict(**cat)


def compact(state: TieredState) -> TieredState:
    """Fold the delta tier into main (kernel D): the pointwise max of the
    two maps, GC at max(main.oldest, delta.oldest), canonical rows
    compacted into main's capacity. Delta resets to empty; a latched
    delta overflow folds into main.overflow (never lost)."""
    main, delta = state.main, state.delta
    m, w = main.main_keys.shape
    floor = max(main.oldest, delta.oldest)
    keys, ver, count = H.merge_maps(
        main.main_keys, main.main_ver, delta.main_keys, delta.main_ver,
        floor=floor, capacity=m,
    )
    new_main = H.VersionHistory(
        main_keys=keys,
        main_ver=ver,
        oldest=floor,
        overflow=main.overflow | delta.overflow | (count > m),
    )
    new_delta = H.empty(delta.main_keys.shape[0], w, main.main_ver.device,
                        oldest=floor)
    return TieredState(main=new_main, delta=new_delta)


def boundary_counts(state: TieredState):
    """(main, delta) live-boundary counts, 0-d tensors."""
    return H.boundary_count(state.main), H.boundary_count(state.delta)
