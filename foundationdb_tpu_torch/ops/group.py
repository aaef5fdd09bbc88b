"""Batch resolution against one history tier, at G=1.

Port of foundationdb_tpu/ops/group.py `resolve_group` for one batch
(G=1), exact or with the fixpoint latch (short-span ops and the
cross-batch phase of G>1 wait in ROADMAP queue 1). The JAX program
co-sorts the tier with every endpoint of the batch because binary
search and scatter were dear on its platform; here the positions come
from kernel A's searches instead, and the phases are:

  (a) tooOld classification (SkipList.cpp:819-828);
  (b) reads vs. this tier: kernel B builds the tier's max table, kernel
      A's probe gives each read's max segment version; OR'd with the
      hits the caller probed elsewhere (`extra_stale`, the main tier);
  (c) dense local ranks of the batch's four endpoint sets (lexicographic
      stable sort + diff + cumsum + inverse permutation);
  (d) per-txn read windows from K6 (kernel A's search at W=1 over the
      nondecreasing read txn ids) and cumsum differences;
  (e) the alternating fixpoint: committed[t] = ok[t] and no committed
      earlier writer in the batch intersects t's reads, each application
      being kernel C (writer cover) -> kernel B (min table) -> kernel A
      (min query); `fixpoint_unroll` applications, then a host loop
      until nothing changes (one device sync per iteration). With
      `fixpoint_latch` there is no host loop: exactly `fixpoint_unroll`
      applications, and a batch whose last application still changed
      something is unconverged — the input tier comes back unchanged
      and the caller re-runs it exactly;
  (f) the first conflicting read per txn, verdicts and counts;
  (g) the committed writes' coverage at the batch version folded into
      the tier by kernel D, with GC at the batch floor.

Decisions are bit-identical to the JAX kernel (tests/test_torch_ops.py,
tests/test_torch_tiered.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.ops import keys as K
from foundationdb_tpu_torch.ops import rangemax, segtree
from foundationdb_tpu_torch.ops.conflict import COMMITTED, CONFLICT, TOO_OLD
from foundationdb_tpu_torch.ops.rangemax import INT32_POS

VERSION_NEG = H.VERSION_NEG


class GroupVerdict(NamedTuple):
    """BatchVerdict with a leading [G] batch axis on every leaf."""

    verdict: torch.Tensor             # [G, B] int32
    hist_conflict_read: torch.Tensor  # [G, NR] bool
    intra_first_range: torch.Tensor   # [G, B] int32
    committed_count: torch.Tensor     # [G] int32
    conflict_count: torch.Tensor      # [G] int32
    too_old_count: torch.Tensor       # [G] int32
    overflow: torch.Tensor            # [G] bool
    unconverged: torch.Tensor         # [G] bool — a latch tripped


@dataclasses.dataclass
class FixpointStats:
    """How deep the intra-batch fixpoint ran (host-side counts)."""

    batches: int = 0
    applications: int = 0      # fixpoint applications, unrolled included
    loop_iterations: int = 0   # host-loop iterations past the unroll
    max_applications: int = 0


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _sorted_counts(ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """off[t] = #{ids < t} for t in [0, n_seg]: [n_seg + 1] int32.

    `ids` must be nondecreasing (the packing layout contract), so this
    is a left search of 0..n_seg into them — kernel A at W=1.
    """
    t = torch.arange(n_seg + 1, dtype=torch.int32, device=ids.device)
    return K.searchsorted(ids.to(torch.int32).reshape(-1, 1).contiguous(),
                          t.reshape(-1, 1), side="left")


def _pad(x: torch.Tensor, fill) -> torch.Tensor:
    """x with one `fill` row appended: padding rows index it (txn == B)."""
    return torch.cat([x, torch.full((1,), fill, dtype=x.dtype,
                                    device=x.device)])


def resolve_group(state: H.VersionHistory, g: dict, *,
                  fixpoint_unroll: int = 3, fixpoint_latch: bool = False,
                  extra_stale=None, stats: FixpointStats = None,
                  defer_trip: bool = False):
    """Resolve one batch (a stacked tree with G == 1) against `state`.

    `g` holds torch leaves with a leading [1] axis (interop.
    device_args_to_torch) and host "version"/"new_oldest" values.
    `extra_stale` ([1, NR] bool or None) are read hits probed against
    history this call's `state` does not hold (the main tier); they are
    masked by read liveness and count like hits on `state`.

    With `fixpoint_latch`, an unconverged batch sets `unconverged` and
    returns the input tier unchanged: this call reads the flag (one
    sync) and hands back `state` itself. `defer_trip=True` is for a
    caller that owns the trip (ops/delta.resolve_group_tiered): the
    tier's tensors are restored on the device without a sync, its host
    floor `oldest` advances regardless, and the caller restores the
    whole state of a tripped group from its own single sync.

    Returns (new_state, GroupVerdict) with [1]-leading leaves.
    """
    gn, b = g["txn_valid"].shape
    if gn != 1:
        raise ValueError(f"the port's group kernel runs at G=1, got G={gn}")
    x = {k: v[0] for k, v in g.items()}
    version = int(x["version"])
    floor = int(x["new_oldest"])
    dev = state.main_ver.device
    nr = x["read_valid"].shape[0]
    nw = x["write_valid"].shape[0]

    txn_valid = x["txn_valid"]
    snapshot = x["snapshot"]
    rb, re = x["read_begin"], x["read_end"]
    wb, we = x["write_begin"], x["write_end"]
    r_txn = x["read_txn"]
    w_txn = x["write_txn"]
    rt = r_txn.to(torch.int64).clamp(0, b)
    wt = w_txn.to(torch.int64).clamp(0, b)

    # ---- (a) tooOld classification -------------------------------------
    too_old = txn_valid & x["has_reads"] & (snapshot < floor)
    read_live = x["read_valid"] & ~_pad(too_old, False)[rt]
    write_live = x["write_valid"] & ~_pad(too_old, False)[wt]
    read_snap = _pad(snapshot, VERSION_NEG)[rt]

    # ---- (b) reads vs. this tier ----------------------------------------
    vmax = H.query_reads_vmax(state, rb, re)
    stale_hit = (vmax > read_snap) & read_live
    if extra_stale is not None:
        stale_hit = stale_hit | (extra_stale[0] & read_live)

    # ---- (c) dense local ranks of the batch's endpoints -----------------
    live_p = torch.cat([read_live, read_live, write_live, write_live])
    pts = torch.cat([rb, re, wb, we])
    pts = torch.where(live_p[:, None], pts, K.SENTINEL_WORD)
    rank = K.dense_ranks(pts)
    lq_lo, lq_hi = rank[:nr], rank[nr:2 * nr]
    lw_lo, lw_hi = rank[2 * nr:2 * nr + nw], rank[2 * nr + nw:]

    # ---- (d) per-txn read windows (layout contract: reads grouped by txn
    # in nondecreasing order, padding rows carry txn == B) ----------------
    off = _sorted_counts(r_txn, b + 1).to(torch.int64)
    win_lo, win_hi = off[:b], off[1:b + 1]
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)

    def per_txn(read_bits):
        cs = torch.cat([zero, torch.cumsum(read_bits.to(torch.int32), 0,
                                           dtype=torch.int32)])
        return (cs[win_hi] - cs[win_lo]) > 0

    hist_conflict_txn = per_txn(stale_hit)
    ok = txn_valid & ~too_old & ~hist_conflict_txn

    # ---- (e) the intra-batch fixpoint ------------------------------------
    leaves = _next_pow2(2 * nr + 2 * nw)
    wlo = torch.where(write_live, lw_lo, 0)
    whi = torch.where(write_live, lw_hi, 0)
    ok_r = _pad(ok, False)[rt]

    def same_hits(committed):
        val = torch.where(_pad(committed, False)[wt] & write_live, w_txn,
                          INT32_POS)
        mw = segtree.min_cover(leaves, wlo, whi, val)
        mtab = rangemax.build(mw, op="min")
        minw = rangemax.query(mtab, lq_lo, lq_hi, op="min")
        return (minw < r_txn) & read_live

    def apply(committed):
        h = same_hits(committed)
        return ok & ~per_txn(h & ok_r), h

    cur, applications = ok, 0
    for _ in range(max(1, fixpoint_unroll)):
        prev = cur
        cur, hits = apply(prev)
        applications += 1
    loop_iterations = 0
    if fixpoint_latch:
        # no residual loop: convergence is checked, not assumed
        unconverged = torch.any(cur != prev)
    else:
        unconverged = torch.zeros((), dtype=torch.bool, device=dev)
        while not torch.equal(cur, prev):
            prev = cur
            cur, hits = apply(prev)
            applications += 1
            loop_iterations += 1
    # `hits` are the hits of `prev`, which equals the fixpoint `cur`
    # (unless the latch tripped, and then nothing of this batch is used)
    committed = cur
    final_same = hits & ok_r
    if stats is not None:
        stats.batches += 1
        stats.applications += applications
        stats.loop_iterations += loop_iterations
        stats.max_applications = max(stats.max_applications, applications)

    # ---- (f) first conflicting read, verdicts, counts --------------------
    csh = torch.cat([zero, torch.cumsum(final_same.to(torch.int32), 0,
                                        dtype=torch.int32)])
    n_before = csh[win_lo]
    tot_h = csh[win_hi] - n_before
    iota_nr = torch.arange(nr, dtype=torch.int32, device=dev)
    tpos = torch.sort(torch.where(final_same, iota_nr, nr)).values
    p = tpos[n_before.to(torch.int64).clamp(0, nr - 1)]
    fidx = x["read_index"][p.to(torch.int64).clamp(0, nr - 1)]
    first = torch.where(tot_h > 0, fidx, INT32_POS)
    intra_first_range = torch.where(
        committed | ~txn_valid | too_old | hist_conflict_txn, -1,
        torch.where(first == INT32_POS, -1, first),
    )
    verdict = torch.where(
        too_old, TOO_OLD,
        torch.where(committed & txn_valid, COMMITTED, CONFLICT),
    ).to(torch.int32)
    committed_count = (committed & txn_valid).sum(dtype=torch.int32)
    too_old_count = too_old.sum(dtype=torch.int32)
    conflict_count = (txn_valid.sum(dtype=torch.int32) - committed_count
                      - too_old_count)

    # ---- (g) merge the committed writes' coverage ------------------------
    cw = _pad(committed, False)[wt] & write_live
    cov_keys, cov_val = _coverage(wb, we, cw, version)
    cap = state.main_keys.shape[0]
    new_keys, new_ver, count = H.merge_maps(
        state.main_keys, state.main_ver, cov_keys, cov_val,
        floor=floor, capacity=cap,
    )
    overflow = state.overflow | (count > cap)
    new_state = H.VersionHistory(
        main_keys=new_keys,
        main_ver=new_ver,
        oldest=max(state.oldest, floor),
        overflow=overflow,
    )
    out = GroupVerdict(
        verdict=verdict[None],
        hist_conflict_read=stale_hit[None],
        intra_first_range=intra_first_range[None],
        committed_count=committed_count[None],
        conflict_count=conflict_count[None],
        too_old_count=too_old_count[None],
        overflow=overflow[None],
        unconverged=unconverged[None],
    )
    if fixpoint_latch:
        if not defer_trip:
            return (state if bool(unconverged) else new_state), out
        new_state = new_state._replace(
            main_keys=torch.where(unconverged, state.main_keys, new_keys),
            main_ver=torch.where(unconverged, state.main_ver, new_ver),
            overflow=torch.where(unconverged, state.overflow, overflow),
        )
    return new_state, out


def _coverage(wb: torch.Tensor, we: torch.Tensor, cw: torch.Tensor,
              version: int):
    """The union of the committed [wb, we) rows as a map at `version`.

    Endpoints sort lexicographically (non-committed rows key to the
    sentinel tail); the running begin-minus-end count after the last row
    of a key says whether the key is covered. Rows of one key may repeat:
    merge_maps reads the last row of a key, which carries the full count.
    """
    sent = torch.full_like(wb, K.SENTINEL_WORD)
    ends = torch.cat([torch.where(cw[:, None], wb, sent),
                      torch.where(cw[:, None], we, sent)])
    one = cw.to(torch.int32)
    step = torch.cat([one, -one])
    perm = K.lex_sort_perm(ends)
    depth = torch.cumsum(step[perm], 0, dtype=torch.int32)
    val = torch.full_like(depth, VERSION_NEG).masked_fill_(depth > 0, version)
    return ends[perm].contiguous(), val
