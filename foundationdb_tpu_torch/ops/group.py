"""Batch resolution against one history tier: the group kernel.

Port of foundationdb_tpu/ops/group.py `resolve_group`, exact, with the
fixpoint latch, or with the short-span ops (K13). The JAX program
co-sorts the tier with every endpoint of the group because binary search
and scatter were dear on its platform; here the positions come from
kernel A's searches instead. Per batch:

  (a) tooOld classification at the batch floor (SkipList.cpp:819-828);
  (b) reads vs. this tier: kernel B builds the tier's max table once per
      call, kernel A's probe gives each read of every batch its max
      segment version; OR'd with the hits the caller probed elsewhere
      (`extra_stale`, the main tier of the tiered path);
  (c) dense local ranks of each batch's four endpoint sets (lexicographic
      stable sort + diff + cumsum + inverse permutation);
  (d) per-txn read windows from K6 (kernel A's counts over the
      nondecreasing flat segment ids batch * (B + 1) + txn) and cumsum
      differences;
  (e) the alternating fixpoint: committed[t] = ok[t] and no committed
      earlier writer in the batch intersects t's reads, each application
      being kernel C (writer cover) -> kernel B (min table) -> kernel A
      (min query); `fixpoint_unroll` applications, then a host loop
      until nothing changes (one device sync per iteration). With
      `fixpoint_latch` there is no host loop: exactly `fixpoint_unroll`
      applications, and a batch whose last application still changed
      something is unconverged — the input tier comes back unchanged
      and the caller re-runs it exactly;
  (f) the first conflicting read per txn, verdicts and counts.

At G = 1 the committed writes' coverage at the batch version then folds
into the tier by kernel D, with GC at the batch floor.

At 1 < G <= MAX_GROUP the batches resolve in order in a host loop (the
JAX program's lax.scan) over `seg_ver`, the running map of the group's
committed-write versions over the group-wide dense ranks of every live
endpoint of the G batches (one lexicographic rank over the 2G(NR+NW)
point rows, in place of the JAX block index over the co-sort with the
tier: interval overlap among the points depends only on their order, so
the tier's rows need not take part). Before its fixpoint a batch's reads
take the max of `seg_ver` over their rank ranges against their
snapshots (K14's cross query: kernel G over the two-level table of
`seg_ver`, skipped for batch 0, which has no earlier batch); after it, its committed live writes paint their rank ranges
with the batch version (K14's fold: kernel H). The group then merges
into the tier once: the sorted endpoint keys with `seg_ver` as their
values are the group's committed map, folded in by kernel D with GC at
the largest floor. With the latch, the trip is group-wide and the input
tier comes back unchanged (one sync per group).

With `short_span_limit` = S > 0 (K13) every range op of the call is a
direct S-wide read or write, kernel K (kernels/csrc/short_span.cu):
phase (b) takes the max of the tier's versions over [max(il, 0), ir + 1)
by `ss_range`, il/ir from kernel E (`sweep_ranks`); each fixpoint
application is one `ss_apply` (the writers' scatter-min over the batch's
local ranks and the reads' min over it, one launch, no fill) instead of
kernels C, B and A; and the cross query at G > 1 is an `ss_range` max
over `seg_ver` instead of kernel G. A loud latch makes it exact, as in
JAX: a live range that spans more than S positions sets `overflow` (the
phase-(b) span in tier segments, the write and read spans in local
ranks, and at G > 1 the cross span counted in the JAX co-sort's blocks,
see `_block_spans`).

Decisions are bit-identical to the JAX kernel (tests/test_torch_ops.py,
tests/test_torch_tiered.py, tests/test_torch_group.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from foundationdb_tpu_torch import kernels
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.ops import keys as K
from foundationdb_tpu_torch.ops import rangemax, segtree
from foundationdb_tpu_torch.ops.conflict import COMMITTED, CONFLICT, TOO_OLD
from foundationdb_tpu_torch.ops.rangemax import INT32_POS

VERSION_NEG = H.VERSION_NEG

#: the JAX package's ceiling on G (its compile cost); kept so both
#: packages take and refuse the same groups
MAX_GROUP = 16


class GroupVerdict(NamedTuple):
    """BatchVerdict with a leading [G] batch axis on every leaf."""

    verdict: torch.Tensor             # [G, B] int32
    hist_conflict_read: torch.Tensor  # [G, NR] bool — history, or an
    #                                   earlier batch of the group
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


#: depth of the exact fixpoint's min table (kernel B at op min, read by
#: kernel A's query): the bench streams' reads span at most 101 local
#: ranks (YCSB-E; 2 uniform and zipf), and two lookups answer a span of up
#: to 2^FIXPOINT_LEVELS = 128; a longer read takes the query's long path,
#: exact all the same. Chosen on the card from 6, 7, 8, 10 and 13 by B +
#: A's query device time at the uniform and range-scan fixpoints
#: (PERF.md; 6 sends 29% of the YCSB-E reads down the long path).
FIXPOINT_LEVELS = 7


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _sorted_counts_plain(ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Plain version of kernel A's counts entry: a left search of 0..n_seg
    into the ids at W = 1."""
    t = torch.arange(n_seg + 1, dtype=torch.int32, device=ids.device)
    return K.searchsorted_plain(
        ids.to(torch.int32).reshape(-1, 1).contiguous(), t.reshape(-1, 1),
        side="left")


def _sorted_counts(ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """off[t] = #{ids < t} for t in [0, n_seg]: [n_seg + 1] int32.

    `ids` must be nondecreasing (the packing layout contract). CPU
    tensors take the plain version; CUDA tensors launch kernel A's
    counts entry: a block a tile of segment ids, a histogram of the ids
    in it and a scan, one pass over the ids (keysearch.cu).
    """
    if ids.device.type == "cpu":
        return _sorted_counts_plain(ids, n_seg)
    ids = ids.to(torch.int32).reshape(-1).contiguous()
    kernels.check_cuda("sorted_counts", ids)
    off = torch.empty((n_seg + 1,), dtype=torch.int32, device=ids.device)
    kernels.launch("ks_counts", "keysearch.counts", ids, ids.shape[0], n_seg,
                   off)
    return off


def _pad(x: torch.Tensor, fill) -> torch.Tensor:
    """x with one `fill` row appended: padding rows index it (txn == B)."""
    return torch.cat([x, torch.full((1,), fill, dtype=x.dtype,
                                    device=x.device)])


def _window_any(win_lo: torch.Tensor, win_hi: torch.Tensor):
    """per_txn(read_bits) -> [T] bool: any bit set in each txn's read
    window [win_lo, win_hi) (cumsum differences)."""
    zero = torch.zeros((1,), dtype=torch.int32, device=win_lo.device)

    def per_txn(read_bits):
        cs = torch.cat([zero, torch.cumsum(read_bits.to(torch.int32), 0,
                                           dtype=torch.int32)])
        return (cs[win_hi] - cs[win_lo]) > 0

    return per_txn


def _spans_within(span: torch.Tensor, live: torch.Tensor, limit: int):
    """[] bool: no live row's span exceeds `limit` (the JAX latch's
    max(where(live, span, 0)) <= limit)."""
    return ~torch.any(torch.where(live, span, 0) > limit)


def _fixpoint(ok, per_txn, *, r_txn, w_txn, rt, wt, read_live, write_live,
              lq_lo, lq_hi, lw_lo, lw_hi, unroll: int, latch: bool,
              short_span_limit: int = 0, stats: FixpointStats = None):
    """One batch's intra-batch fixpoint, phase (e).

    Returns (committed [B] bool, final same-batch hits [NR] bool masked
    by ok, unconverged [] bool). Without the latch, `unconverged` is
    False and the host loop runs to the fixpoint. With
    `short_span_limit` S > 0 an application is one launch of kernel K's
    `ss_apply` (the caller latches the spans).
    """
    nr, nw = lq_lo.shape[0], lw_lo.shape[0]
    leaves = _next_pow2(2 * nr + 2 * nw)
    wlo = torch.where(write_live, lw_lo, 0)
    whi = torch.where(write_live, lw_hi, 0)
    ok_r = _pad(ok, False)[rt]
    ss = short_span_limit

    def same_hits(committed):
        val = torch.where(_pad(committed, False)[wt] & write_live, w_txn,
                          INT32_POS)
        if ss:
            minw = ss_apply(leaves, wlo, whi, val, lq_lo, lq_hi, ss)
        else:
            mw = segtree.min_cover(leaves, wlo, whi, val)
            mtab = rangemax.build(mw, op="min", levels=FIXPOINT_LEVELS)
            minw = rangemax.query(mtab, lq_lo, lq_hi, op="min")
        return (minw < r_txn) & read_live

    def apply(committed):
        h = same_hits(committed)
        return ok & ~per_txn(h & ok_r), h

    cur, applications = ok, 0
    for _ in range(max(1, unroll)):
        prev = cur
        cur, hits = apply(prev)
        applications += 1
    loop_iterations = 0
    if latch:
        # no residual loop: convergence is checked, not assumed
        unconverged = torch.any(cur != prev)
    else:
        unconverged = torch.zeros((), dtype=torch.bool, device=ok.device)
        while not torch.equal(cur, prev):
            prev = cur
            cur, hits = apply(prev)
            applications += 1
            loop_iterations += 1
    if stats is not None:
        stats.batches += 1
        stats.applications += applications
        stats.loop_iterations += loop_iterations
        stats.max_applications = max(stats.max_applications, applications)
    # `hits` are the hits of `prev`, which equals the fixpoint `cur`
    # (unless the latch tripped, and then nothing of this batch is used)
    return cur, hits & ok_r, unconverged


def _first_conflict(final_same, win_lo, win_hi, read_index):
    """Phase (f): each txn's first conflicting read-range index (reads
    sit in range order inside their window), INT32_POS where none."""
    nr = final_same.shape[0]
    dev = final_same.device
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    csh = torch.cat([zero, torch.cumsum(final_same.to(torch.int32), 0,
                                        dtype=torch.int32)])
    n_before = csh[win_lo]
    tot_h = csh[win_hi] - n_before
    iota_nr = torch.arange(nr, dtype=torch.int32, device=dev)
    tpos = torch.sort(torch.where(final_same, iota_nr, nr)).values
    p = tpos[n_before.to(torch.int64).clamp(0, nr - 1)]
    fidx = read_index[p.to(torch.int64).clamp(0, nr - 1)]
    return torch.where(tot_h > 0, fidx, INT32_POS)


def _verdicts(committed, txn_valid, too_old, hist_conflict_txn, first,
              gn: int):
    """Verdict codes, intra_first_range and the per-batch counts ([gn])
    of gn batches laid end to end."""
    intra_first_range = torch.where(
        committed | ~txn_valid | too_old | hist_conflict_txn, -1,
        torch.where(first == INT32_POS, -1, first),
    )
    verdict = torch.where(
        too_old, TOO_OLD,
        torch.where(committed & txn_valid, COMMITTED, CONFLICT),
    ).to(torch.int32)

    def per_batch(x):
        return x.reshape(gn, -1).sum(dim=1, dtype=torch.int32)

    committed_count = per_batch(committed & txn_valid)
    too_old_count = per_batch(too_old)
    conflict_count = per_batch(txn_valid) - committed_count - too_old_count
    return (verdict, intra_first_range, committed_count, conflict_count,
            too_old_count)


def resolve_group(state: H.VersionHistory, g: dict, *,
                  short_span_limit: int = 0,
                  fixpoint_unroll: int = 3, fixpoint_latch: bool = False,
                  extra_stale=None, stats: FixpointStats = None,
                  defer_trip: bool = False):
    """Resolve G stacked batches (1 <= G <= MAX_GROUP, versions strictly
    ascending) against `state`.

    `g` holds torch leaves with a leading [G] axis (interop.
    device_args_to_torch) and host "version"/"new_oldest" values.
    `extra_stale` ([1, NR] bool or None; G = 1 only) are read hits the
    tiered loop probed against history this call's `state` does not hold
    (the main tier); they are masked by read liveness and count like
    hits on `state`.

    `short_span_limit` S > 0 serves every range op by kernel K's direct
    S-wide reads and writes, exact under the span latch: a live range
    wider than S sets `overflow` (the caller refuses the results, as for
    capacity overflow).

    With `fixpoint_latch`, an unconverged batch sets `unconverged` (for
    G > 1 group-wide) and returns the input tier unchanged: this call
    reads the flag (one sync) and hands back `state` itself.
    `defer_trip=True` (G = 1 only) is for a caller that owns the trip
    (ops/delta.resolve_group_tiered): the tier's tensors are restored on
    the device without a sync, its host floor `oldest` advances
    regardless, and the caller restores the whole state of a tripped
    group from its own single sync.

    Returns (new_state, GroupVerdict with [G]-leading leaves).
    """
    gn = g["txn_valid"].shape[0]
    if gn > MAX_GROUP:
        raise ValueError(f"group of {gn} > MAX_GROUP {MAX_GROUP}")
    if gn > 1:
        if defer_trip or extra_stale is not None:
            raise ValueError("defer_trip and extra_stale are for the tiered "
                             "loop, at G=1")
        return _resolve_many(state, g, short_span_limit=short_span_limit,
                             fixpoint_unroll=fixpoint_unroll,
                             fixpoint_latch=fixpoint_latch, stats=stats)
    x = {k: v[0] for k, v in g.items()}
    b = x["txn_valid"].shape[0]
    version = int(x["version"])
    floor = int(x["new_oldest"])
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
    ss = short_span_limit
    if ss:
        vmax, span_ok, _ = _tier_vmax_short(state, rb, re, read_live, ss)
    else:
        vmax = H.query_reads_vmax(state, rb, re)
        span_ok = torch.ones((), dtype=torch.bool, device=rb.device)
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
    per_txn = _window_any(win_lo, win_hi)
    hist_conflict_txn = per_txn(stale_hit)
    ok = txn_valid & ~too_old & ~hist_conflict_txn

    # ---- (e) the intra-batch fixpoint ------------------------------------
    if ss:
        span_ok = span_ok & _local_spans_ok(read_live, write_live, lq_lo,
                                            lq_hi, lw_lo, lw_hi, ss)
    committed, final_same, unconverged = _fixpoint(
        ok, per_txn, r_txn=r_txn, w_txn=w_txn, rt=rt, wt=wt,
        read_live=read_live, write_live=write_live, lq_lo=lq_lo,
        lq_hi=lq_hi, lw_lo=lw_lo, lw_hi=lw_hi, unroll=fixpoint_unroll,
        latch=fixpoint_latch, short_span_limit=ss, stats=stats)

    # ---- (f) first conflicting read, verdicts, counts --------------------
    first = _first_conflict(final_same, win_lo, win_hi, x["read_index"])
    (verdict, intra_first_range, committed_count, conflict_count,
     too_old_count) = _verdicts(committed, txn_valid, too_old,
                                hist_conflict_txn, first, 1)

    # ---- (g) merge the committed writes' coverage ------------------------
    cw = _pad(committed, False)[wt] & write_live
    cov_keys, cov_val = _coverage(wb, we, cw, version)
    cap = state.main_keys.shape[0]
    new_keys, new_ver, count = H.merge_maps(
        state.main_keys, state.main_ver, cov_keys, cov_val,
        floor=floor, capacity=cap,
    )
    # a span wider than S is refused as loudly as a capacity overflow
    overflow = state.overflow | (count > cap) | ~span_ok
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
        committed_count=committed_count,
        conflict_count=conflict_count,
        too_old_count=too_old_count,
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


def _tier_vmax_short(state: H.VersionHistory, rb, re, read_live, ss: int):
    """Phase (b) under short_span_limit S: (vmax [NR], span_ok [], hi
    [NR]) — each live read's max tier version over [max(il, 0), ir + 1)
    by kernel K's direct reads, il = search_right(rb) - 1 and ir =
    search_left(re) - 1 from kernel E, the latch on those spans in tier
    segments (the JAX co-sort's il/ir; a read before the first boundary
    has il = -1, so its span starts at 0), and hi = search_left(re) for
    _block_spans. A dead read's vmax is the empty range's: every use of
    vmax masks it by read_live."""
    lo, hi = _tier_segments(state.main_keys, rb, re, read_live)
    return (ss_range(state.main_ver, lo, hi, ss, op="max"),
            _spans_within(hi - lo, read_live, ss), hi)


def _tier_segments(main_keys, rb, re, live):
    """Each live read's tier segments [lo, hi) = [max(il, 0), ir + 1),
    so hi = search_left(re); [0, 0) for a dead read. One kernel E launch
    (on CUDA tensors) for both ends of every read."""
    # ops/delta imports this module, so its kernel E wrapper comes here
    from foundationdb_tpu_torch.ops import delta as D

    il, ir = D.sweep_read_ranks(main_keys, rb, re, live)
    return il.clamp(min=0), ir + 1


def _local_spans_ok(read_live, write_live, lq_lo, lq_hi, lw_lo, lw_hi,
                    ss: int):
    """Phase (e)'s latch under S: the live writes' and live reads' spans
    in the batch's local ranks (the same in both packages)."""
    return (_spans_within(lw_hi - lw_lo, write_live, ss)
            & _spans_within(lq_hi - lq_lo, read_live, ss))


def _block_spans(main_keys, ukeys, rank_rb, rank_re, rb, left_re):
    """Each live read's span in the JAX co-sort's block index: the
    distinct keys among the tier's live rows and the group's live points
    in [rb, re).

    The block index of a live point key k is (distinct point keys < k) +
    (tier rows < k) - (distinct point keys < k that are tier keys too):
    its dense rank among the points (sort_ranks, `rank_*`), a left
    search of k in the tier, and the running count of the sorted
    distinct point keys `ukeys` that sit in the tier (one both-sides
    search of each, then one cumsum). The read ends' left searches come
    in as `left_re` (phase (b)'s hi, from kernel E), the begins' take
    one left search here. Point ranks never exceed block ranks, so a
    group the JAX latch passes is exact under the port's point-rank ops,
    and this count refuses exactly the groups JAX refuses.
    """
    left_u, right_u = K.searchsorted(main_keys, ukeys, side="both")
    shared = torch.cat([torch.zeros((1,), dtype=torch.int32,
                                    device=ukeys.device),
                        torch.cumsum((right_u > left_u).to(torch.int32), 0,
                                     dtype=torch.int32)])

    def block(rank, left):
        return rank + left - shared[rank.to(torch.int64)]

    return (block(rank_re, left_re)
            - block(rank_rb, K.searchsorted(main_keys, rb, side="left")))


def _point_ranks(g: dict, rl2, wl2):
    """_group_ranks of a group's point rows (read begins, read ends, write
    begins, write ends of each batch; rows dead under the liveness rl2
    [G, NR] / wl2 [G, NW] become the sentinel): (group-wide rank [G, P],
    rank within the batch [G, P], the distinct keys)."""
    gn = rl2.shape[0]
    live_p = torch.cat([rl2, rl2, wl2, wl2], dim=1).reshape(-1)
    pts = torch.cat([g["read_begin"], g["read_end"], g["write_begin"],
                     g["write_end"]], dim=1).reshape(live_p.shape[0], -1)
    pts = torch.where(live_p[:, None], pts, K.SENTINEL_WORD).contiguous()
    grank, lrank, ukeys = _group_ranks(pts, gn)
    return grank.reshape(gn, -1), lrank.reshape(gn, -1), ukeys


def _cols(r, nr: int, nw: int):
    """[G, P] point-row ranks -> (read begins, read ends, write begins,
    write ends), each [G, NR] or [G, NW]."""
    return (r[:, :nr], r[:, nr:2 * nr], r[:, 2 * nr:2 * nr + nw],
            r[:, 2 * nr + nw:])


def span_widths(state: H.VersionHistory, g: dict) -> dict:
    """The widest live span of each kind the short-span latch holds to S,
    on a group of packed batches (torch leaves with a leading [G] axis)
    against one tier: `tier` (phase b, in tier segments), `read` and
    `write` (in each batch's local ranks) and, at G > 1, `blocks` (the
    cross query, in the JAX co-sort's blocks). Computed by the latch's
    own helpers; liveness is the packed validity, a superset of the
    latch's (too-old txns are masked there), so each is an upper bound
    and the smallest S at or above them all passes the latch."""
    gn, nr, w = g["read_begin"].shape
    nw = g["write_begin"].shape[1]
    rl2, wl2 = g["read_valid"], g["write_valid"]
    rb = g["read_begin"].reshape(-1, w).contiguous()
    re = g["read_end"].reshape(-1, w).contiguous()
    live = rl2.reshape(-1).contiguous()
    lo, hi = _tier_segments(state.main_keys, rb, re, live)
    grank, lrank, ukeys = _point_ranks(g, rl2, wl2)
    lq_lo, lq_hi, lw_lo, lw_hi = _cols(lrank, nr, nw)
    spans = {"tier": (hi - lo, live),
             "read": (lq_hi - lq_lo, rl2), "write": (lw_hi - lw_lo, wl2)}
    if gn > 1:
        rank_rb, rank_re, _, _ = _cols(grank, nr, nw)
        spans["blocks"] = (_block_spans(
            state.main_keys, ukeys, rank_rb.reshape(-1),
            rank_re.reshape(-1), rb, hi), live)
    return {k: int(torch.where(live, span, 0).max())
            for k, (span, live) in spans.items()}


def _group_ranks(pts: torch.Tensor, gn: int):
    """Ranks of the group's point rows ([gn * P, W], batch after batch,
    dead rows already sentinel): (group-wide dense rank [gn * P], dense
    rank within its own batch [gn * P], the distinct keys in key order
    [gn * P, W] with a sentinel tail).

    sort_ranks (K17) gives the group-wide ranks and the distinct keys;
    one stable sort by (batch, group-wide rank) puts each batch's rows in
    key order, where the within-batch ranks restart at each batch.
    """
    n = pts.shape[0]
    p = n // gn
    dev = pts.device
    grank, ukeys, _ = K.sort_ranks(pts)
    bid = torch.arange(gn, device=dev).repeat_interleave(p)
    order = torch.sort(bid * n + grank, stable=True).indices
    sk = grank[order]
    new = torch.ones((n,), dtype=torch.int32, device=dev)
    new[1:] = (sk[1:] != sk[:-1]).to(torch.int32)
    new = new.reshape(gn, p)
    new[:, 0] = 1
    lrank_sorted = torch.cumsum(new, 1, dtype=torch.int32) - 1
    lrank = torch.empty((n,), dtype=torch.int32, device=dev)
    lrank[order] = lrank_sorted.reshape(-1)
    return grank, lrank, ukeys


def _resolve_many(state: H.VersionHistory, g: dict, *, short_span_limit: int,
                  fixpoint_unroll: int, fixpoint_latch: bool, stats):
    """resolve_group at 1 < G <= MAX_GROUP (see the module docstring)."""
    gn, b = g["txn_valid"].shape
    nr = g["read_valid"].shape[1]
    nw = g["write_valid"].shape[1]
    dev = state.main_ver.device
    versions = [int(v) for v in np.asarray(g["version"]).reshape(-1)]
    floors = [int(f) for f in np.asarray(g["new_oldest"]).reshape(-1)]

    def fl(key):
        x = g[key]
        return x.reshape((gn * x.shape[1],) + tuple(x.shape[2:]))

    txn_valid = fl("txn_valid")                             # [G*B]
    snapshot = fl("snapshot")
    r_txn = fl("read_txn")                                  # batch-local
    rt2 = g["read_txn"].to(torch.int64).clamp(0, b)         # [G, NR]
    wt2 = g["write_txn"].to(torch.int64).clamp(0, b)
    lane = torch.arange(gn, dtype=torch.int64, device=dev)[:, None] * (b + 1)
    r_gid = (rt2 + lane).reshape(-1)    # into [G, B + 1] padded txn arrays
    w_gid = (wt2 + lane).reshape(-1)

    def padded(x, fill):
        return torch.cat([x.reshape(gn, b), torch.full(
            (gn, 1), fill, dtype=x.dtype, device=dev)], dim=1).reshape(-1)

    # ---- (a) tooOld per batch floor --------------------------------------
    # from a pinned buffer on the card: no pageable copy on any path
    floor_t = torch.tensor(
        floors, dtype=torch.int32, pin_memory=dev.type == "cuda",
    ).to(dev, non_blocking=True).repeat_interleave(b)
    too_old = txn_valid & fl("has_reads") & (snapshot < floor_t)
    read_live = fl("read_valid") & ~padded(too_old, False)[r_gid]
    write_live = fl("write_valid") & ~padded(too_old, False)[w_gid]
    read_snap = padded(snapshot, VERSION_NEG)[r_gid]
    rb, re = fl("read_begin"), fl("read_end")

    # ---- (b) every read of the group vs. the pre-group tier: one table
    # build (kernel B), one probe launch (kernel A); under S, kernel A's
    # searches and one kernel K read --------------------------------------
    ss = short_span_limit
    rb, re = rb.contiguous(), re.contiguous()
    if ss:
        vmax, span_ok, left_re = _tier_vmax_short(state, rb, re, read_live,
                                                  ss)
    else:
        vmax = H.query_reads_vmax(state, rb, re)
        span_ok = torch.ones((), dtype=torch.bool, device=dev)
    stale_hit = (vmax > read_snap) & read_live

    # ---- (c) + (d) local and group-wide ranks of the point rows ----------
    p_per = 2 * nr + 2 * nw
    rl2, wl2 = read_live.reshape(gn, nr), write_live.reshape(gn, nw)
    grank, lrank, ukeys = _point_ranks(g, rl2, wl2)
    lq_lo, lq_hi, lw_lo, lw_hi = _cols(lrank, nr, nw)
    rank_rb, rank_re, rank_wb, rank_we = (
        c.contiguous() for c in _cols(grank, nr, nw))
    if ss:
        # the latch of every batch: local write and read spans, and the
        # cross query's span in JAX blocks (its query walks group ranks)
        span_ok = span_ok & _local_spans_ok(rl2, wl2, lq_lo, lq_hi, lw_lo,
                                            lw_hi, ss)
        cross_span = _block_spans(state.main_keys, ukeys,
                                  rank_rb.reshape(-1), rank_re.reshape(-1),
                                  rb, left_re)
        span_ok = span_ok & _spans_within(cross_span, read_live, ss)

    # ---- (e) per-txn read windows over the flat segment ids --------------
    r_batch = torch.arange(gn, dtype=torch.int32,
                           device=dev).repeat_interleave(nr)
    seg_id = r_batch * (b + 1) + r_txn
    off = _sorted_counts(seg_id, gn * (b + 1)).to(torch.int64)
    offs2 = off[:-1].reshape(gn, b + 1)
    win_lo, win_hi = offs2[:, :b], offs2[:, 1:]            # flat positions
    per_txn_flat = _window_any(win_lo.reshape(-1), win_hi.reshape(-1))
    hist_conflict_txn0 = per_txn_flat(stale_hit)

    # ---- (f) the batch loop over the running map `seg_ver` ---------------
    n_map = gn * p_per
    seg_ver = torch.full((n_map,), VERSION_NEG, dtype=torch.int32, device=dev)
    scratch = seg_fold_scratch(n_map, dev)
    no_cross = torch.zeros((nr,), dtype=torch.bool, device=dev)
    read_index = g["read_index"]
    tv2, to2 = txn_valid.reshape(gn, b), too_old.reshape(gn, b)
    stale2, snap2 = stale_hit.reshape(gn, nr), read_snap.reshape(gn, nr)
    committed_l, cross_l, first_l = [], [], []
    unconverged = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(gn):
        rlive, wlive = rl2[i], wl2[i]
        base = i * nr
        lwin_lo, lwin_hi = win_lo[i] - base, win_hi[i] - base
        per_txn = _window_any(lwin_lo, lwin_hi)
        # the cross query: earlier batches' committed writes newer than
        # the read's snapshot (K14, kernel G; under S kernel K); batch 0
        # has no earlier batch, its seg_ver is all VERSION_NEG
        if i == 0:
            cross = no_cross
        elif ss:
            gmax = ss_range(seg_ver, rank_rb[i], rank_re[i], ss, op="max")
            cross = (gmax > snap2[i]) & rlive
        else:
            gtab = rangemax.build2(seg_ver, op="max")
            gmax = rangemax.query2(gtab, rank_rb[i], rank_re[i], op="max")
            cross = (gmax > snap2[i]) & rlive
        ok = tv2[i] & ~to2[i] & ~per_txn(stale2[i] | cross)
        committed, final_same, unconv = _fixpoint(
            ok, per_txn, r_txn=g["read_txn"][i], w_txn=g["write_txn"][i],
            rt=rt2[i], wt=wt2[i], read_live=rlive, write_live=wlive,
            lq_lo=lq_lo[i], lq_hi=lq_hi[i], lw_lo=lw_lo[i], lw_hi=lw_hi[i],
            unroll=fixpoint_unroll, latch=fixpoint_latch,
            short_span_limit=ss, stats=stats)
        unconverged = unconverged | unconv
        # the fold: this batch's committed live writes paint their rank
        # ranges with its version (K14, kernel H)
        cw = (_pad(committed, False)[wt2[i]] & wlive).contiguous()
        seg_fold(seg_ver, rank_wb[i], rank_we[i], cw, versions[i], scratch)
        first_l.append(_first_conflict(final_same, lwin_lo, lwin_hi,
                                       read_index[i]))
        committed_l.append(committed)
        cross_l.append(cross)

    # ---- (g) verdicts: the cross hits are NOT masked by ok (a txn
    # condemned by pre-group history still reports its other conflicting
    # reads, as the sequential batches would) -----------------------------
    committed = torch.cat(committed_l)
    final_cross = torch.cat(cross_l)
    hist_conflict_read = stale_hit | final_cross
    hist_conflict_txn = hist_conflict_txn0 | per_txn_flat(final_cross)
    (verdict, intra_first_range, committed_count, conflict_count,
     too_old_count) = _verdicts(committed, txn_valid, too_old,
                                hist_conflict_txn, torch.cat(first_l), gn)

    # ---- (h) one merge per group: the distinct endpoint keys with
    # `seg_ver` are the group's committed map, folded into the tier by
    # kernel D with GC at the largest floor --------------------------------
    floor = max(floors)
    cap = state.main_keys.shape[0]
    new_keys, new_ver, count = H.merge_maps(
        state.main_keys, state.main_ver, ukeys, seg_ver, floor=floor,
        capacity=cap,
    )
    overflow = state.overflow | (count > cap) | ~span_ok
    new_state = H.VersionHistory(main_keys=new_keys, main_ver=new_ver,
                                 oldest=max(state.oldest, floor),
                                 overflow=overflow)
    out = GroupVerdict(
        verdict=verdict.reshape(gn, b),
        hist_conflict_read=hist_conflict_read.reshape(gn, nr),
        intra_first_range=intra_first_range.reshape(gn, b),
        committed_count=committed_count,
        conflict_count=conflict_count,
        too_old_count=too_old_count,
        overflow=overflow.repeat(gn),
        unconverged=unconverged.repeat(gn),
    )
    # ---- (i) the latch: a group-wide trip hands back the input tier ------
    if fixpoint_latch and bool(unconverged):
        return state, out
    return new_state, out


# ---------------------------------------------------------------------------
# K13's direct ops (kernel K)

def ss_range_plain(values: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   span: int, *, op: str) -> torch.Tensor:
    """Plain version of kernel K's range entry, as JAX's direct_range_op
    writes it: `span` clamped gathers, each masked by pos < hi."""
    fn = rangemax._op(op)
    ident = rangemax._IDENT[op]
    n = values.shape[0]
    acc = torch.full(lo.shape, ident, dtype=torch.int32, device=lo.device)
    for d in range(span):
        pos = lo.to(torch.int64) + d
        v = values[pos.clamp(0, n - 1)]
        acc = fn(acc, torch.where(pos < hi, v, ident))
    return acc


def ss_range(values: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
             span: int, *, op: str) -> torch.Tensor:
    """op ("max" or "min") over values[lo:hi] per query by at most `span`
    direct reads ([Q] int32; the op identity where hi <= lo): exact for
    the queries with hi - lo <= span, which the caller latches. CUDA
    tensors launch kernel K's ss_range entry."""
    rangemax._op(op)
    if values.ndim != 1 or values.shape[0] < 1 or lo.shape != hi.shape \
            or lo.ndim != 1:
        raise ValueError("ss_range: values [N] and lo, hi [Q] expected")
    if values.device.type == "cpu":
        return ss_range_plain(values, lo, hi, span, op=op)
    kernels.check_cuda("ss_range", values, lo, hi)
    out = torch.empty(lo.shape, dtype=torch.int32, device=values.device)
    kernels.launch("ss_range", "short_span.range", values, values.shape[0],
                   lo, hi, lo.shape[0], span, int(op == "min"), out)
    return out


def ss_cover_plain(leaves: int, lo: torch.Tensor, hi: torch.Tensor,
                   val: torch.Tensor, span: int) -> torch.Tensor:
    """The cover of kernel K's apply entry, plain, as the JAX program's
    scatter-min: `span` scatters into a [leaves + 1] buffer of INT32_POS,
    the positions past each write's end or outside [0, leaves) sent to
    the trash slot."""
    flat = torch.full((leaves + 1,), INT32_POS, dtype=torch.int32,
                      device=val.device)
    for d in range(span):
        pos = lo.to(torch.int64) + d
        idx = torch.where((pos < hi) & (pos >= 0) & (pos < leaves), pos,
                          leaves)
        flat.scatter_reduce_(0, idx, val, reduce="amin")
    return flat[:leaves]


def ss_apply_plain(leaves: int, wlo: torch.Tensor, whi: torch.Tensor,
                   val: torch.Tensor, lq_lo: torch.Tensor, lq_hi: torch.Tensor,
                   span: int) -> torch.Tensor:
    """Plain version of kernel K's apply entry: the cover, then the min
    query over it, as the JAX program writes them."""
    return ss_range_plain(ss_cover_plain(leaves, wlo, whi, val, span),
                          lq_lo, lq_hi, span, op="min")


#: kernel K's cover per (CUDA device, stream): leaves of 64 bits stamped
#: with their launch, then the current stamp (short_span.cu). A new one is
#: all ones and reads as INT32_POS; each launch leaves the older leaves
#: stale, so one serves every application on its stream without a fill.
#: Calls on two streams at once would share the stamp, so each stream has
#: its own
_SPAN_COVER: dict = {}


def _span_cover(dev: torch.device, leaves: int) -> torch.Tensor:
    """Kernel K's cover of at least `leaves` leaves for `dev`'s current
    stream. Inside a CUDA graph's capture a new one is made every call and
    never kept: it lives in the graph's memory pool as long as the graph,
    and its fill is captured with the launch, so each replay starts from
    a new cover and shares no stamp with the stream's held one."""
    if torch.cuda.is_current_stream_capturing():
        return torch.full((leaves + 1,), -1, dtype=torch.int64, device=dev)
    key = H._scratch_key(dev)
    held = _SPAN_COVER.get(key)
    if held is None or held.shape[0] <= leaves:
        held = torch.full((leaves + 1,), -1, dtype=torch.int64, device=dev)
        _SPAN_COVER[key] = held
    return held


def ss_apply(leaves: int, wlo: torch.Tensor, whi: torch.Tensor,
             val: torch.Tensor, lq_lo: torch.Tensor, lq_hi: torch.Tensor,
             span: int) -> torch.Tensor:
    """One fixpoint application under short_span_limit = `span`: each
    read's min over leaves [lq_lo, lq_hi) (at most `span` of them, a
    position below 0 reading leaf 0) of the writes' cover — at each leaf
    in [0, leaves) the min val[j] over the writes with wlo[j] <= leaf <
    min(whi[j], wlo[j] + span), INT32_POS where none (an INT32_POS val
    writes nothing). [NR] int32, INT32_POS where lq_hi <= lq_lo: exact
    for the spans <= `span`, which the caller latches. CUDA tensors take
    one launch of kernel K's ss_apply entry, on a cover kept per stream
    (no fill); CPU tensors the plain version."""
    if not (wlo.shape == whi.shape == val.shape and wlo.ndim == 1
            and lq_lo.shape == lq_hi.shape and lq_lo.ndim == 1):
        raise ValueError("ss_apply: wlo, whi, val [NW] and lq_lo, lq_hi "
                         "[NR] expected")
    if leaves < 1:
        raise ValueError("ss_apply: leaves must be >= 1")
    if val.device.type == "cpu":
        return ss_apply_plain(leaves, wlo, whi, val, lq_lo, lq_hi, span)
    dev = kernels.check_cuda("ss_apply", wlo, whi, val, lq_lo, lq_hi)
    cover = _span_cover(dev, leaves)
    out = torch.empty(lq_lo.shape, dtype=torch.int32, device=dev)
    kernels.launch("ss_apply", "short_span.apply", wlo, whi, val,
                   wlo.shape[0], lq_lo, lq_hi, lq_lo.shape[0], span, leaves,
                   cover, cover.shape[0] - 1, out)
    return out


# ---------------------------------------------------------------------------
# K14's fold (kernel H)

def seg_fold_plain(seg_ver: torch.Tensor, wb: torch.Tensor, we: torch.Tensor,
                   cw: torch.Tensor, version: int) -> torch.Tensor:
    """Plain version of kernel H, as the JAX fold writes it: a +1/-1
    difference array over [wb, we) of the `cw` rows, its running sum,
    and `where(covered, version, seg_ver)`, painted into `seg_ver` in
    place; returns it."""
    n = seg_ver.shape[0]
    dd = torch.zeros((n + 1,), dtype=torch.int32, device=seg_ver.device)
    one = torch.ones(wb.shape, dtype=torch.int32, device=seg_ver.device)
    dd.index_add_(0, torch.where(cw, wb.clamp(0, n), n).to(torch.int64), one)
    dd.index_add_(0, torch.where(cw, we.clamp(0, n), n).to(torch.int64), -one)
    covered = torch.cumsum(dd[:n], 0, dtype=torch.int32) > 0
    return seg_ver.masked_fill_(covered, version)


def seg_fold_scratch(n: int, device) -> torch.Tensor:
    """Kernel H's zeroed scratch for a map of n ranks on the card (its
    header, its wide-write list and the difference array its count
    uses; each fold leaves it zero again, so one serves a whole group);
    None on the CPU, where the plain version needs none."""
    device = torch.device(device)
    if device.type == "cpu":
        return None
    return torch.zeros((kernels.size("sf_scratch_words", n),),
                       dtype=torch.int32, device=device)


def seg_fold(seg_ver: torch.Tensor, wb: torch.Tensor, we: torch.Tensor,
             cw: torch.Tensor, version: int, scratch=None) -> torch.Tensor:
    """Paint `version` over every rank covered by a `cw` row's [wb, we)
    (ranks in [0, len(seg_ver)], int32; cw bool), in place in `seg_ver`
    on either device; returns it. On the card kernel H's one launch runs
    in `scratch` (seg_fold_scratch(len(seg_ver)), allocated here when
    None); on the CPU the plain version."""
    if not (wb.shape == we.shape == cw.shape and wb.ndim == 1
            and seg_ver.ndim == 1):
        raise ValueError("seg_fold: seg_ver [N] and wb, we, cw [NW] expected")
    if seg_ver.device.type == "cpu":
        return seg_fold_plain(seg_ver, wb, we, cw, version)
    dev = kernels.check_cuda("seg_fold", seg_ver, wb, we)
    if kernels.check_cuda("seg_fold", cw, dtype=torch.bool) != dev:
        raise ValueError(f"seg_fold: tensors on {cw.device} and {dev}")
    n = seg_ver.shape[0]
    if scratch is None:
        scratch = seg_fold_scratch(n, dev)
    if (kernels.check_cuda("seg_fold", scratch) != dev
            or scratch.shape != (kernels.size("sf_scratch_words", n),)):
        raise ValueError("seg_fold: scratch is not seg_fold_scratch(n)")
    kernels.launch("sf_fold", "seg_fold", wb, we, cw, wb.shape[0], n,
                   int(version), seg_ver, scratch)
    return seg_ver


def _coverage(wb: torch.Tensor, we: torch.Tensor, cw: torch.Tensor,
              version: int):
    """The union of the committed [wb, we) rows as a map at `version`.

    Endpoints sort lexicographically (kernel N on the card; non-committed
    rows key to the sentinel tail); the running begin-minus-end count
    after the last row of a key says whether the key is covered. Rows of
    one key may repeat: merge_maps reads the last row of a key, which
    carries the full count.
    """
    sent = torch.full_like(wb, K.SENTINEL_WORD)
    ends = torch.cat([torch.where(cw[:, None], wb, sent),
                      torch.where(cw[:, None], we, sent)])
    one = cw.to(torch.int32)
    step = torch.cat([one, -one])
    perm, sorted_ends = K.lex_sort_perm(ends)
    depth = torch.cumsum(step[perm], 0, dtype=torch.int32)
    val = torch.full_like(depth, VERSION_NEG).masked_fill_(depth > 0, version)
    return sorted_ends, val
