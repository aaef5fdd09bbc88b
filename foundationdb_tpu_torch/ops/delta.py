"""Delta-tiered conflict resolution: the port's main path.

Port of foundationdb_tpu/ops/delta.py. History is two tiers:

* `main` — the big compacted tier, immutable during a group: its
  range-max table is built once per group (kernel B) and every batch
  probes it;
* `delta` — the boundaries written since the last compaction: each
  batch resolves against it with the group kernel at G=1
  (ops/group.resolve_group) and merges its committed writes into it.

The main-tier probe has three forms, one per contention profile:

* exact (`dedup_reads=0`, no sweep): kernel A's fused probe per read;
* read dedup (`dedup_reads=U`, the hot-key profile): the batch's
  distinct (begin, end) ranges found by kernels N and L (the sort and
  ranks of the [NR, 2W] rows), the first U split out and probed by
  kernel F (`read_dedup`) and A, each read's max version gathered back;
  more than U distinct live ranges trips the latch (K12);
* endpoint sweep (`range_sweep`, the range-scan profile): kernel E
  (`sweep_ranks`) gives every read of the group its main-tier ranks in
  one launch before the loop, and each batch's probe is one table query
  (K11). The sweep is not a latch source.

`resolve_group_tiered` is a host loop over the group's batches (the JAX
program's lax.scan) carrying the group-wide trip: with the fixpoint
latch or dedup armed, a tripped group hands back both tiers unchanged
and the caller re-runs it exactly. `compact` folds delta into main with
kernel D. Decisions are bit-identical to the JAX tiered kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from foundationdb_tpu_torch import kernels
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.ops import group as G
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.ops import keys as K
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


def dedup_rows(rb, re, rvalid) -> torch.Tensor:
    """[NR, 2W] rows of the read ranges: begin words then end words,
    dead reads all sentinel (so they sort last and count as one)."""
    return torch.cat([torch.where(rvalid[:, None], rb, K.SENTINEL_WORD),
                      torch.where(rvalid[:, None], re, K.SENTINEL_WORD)],
                     dim=1).contiguous()


def dedup_vmax_plain(main_keys, main_tab, rows, dedup: int):
    """Plain version of kernel F around kernel A's probe: (vmax [NR],
    n_uniq []). `rows` as dedup_rows gives them."""
    nr, w2 = rows.shape
    w = w2 // 2
    dev = rows.device
    perm, s = K.lex_sort_perm_plain(rows)
    head = torch.ones((nr,), dtype=torch.bool, device=dev)
    if nr > 1:
        head[1:] = torch.any(s[1:] != s[:-1], dim=-1)
    live = s[:, w - 1] != K.SENTINEL_WORD
    uh = torch.cumsum(head.to(torch.int32), 0, dtype=torch.int32) - 1
    n_uniq = (head & live).sum(dtype=torch.int32)
    take = head & live & (uh < dedup)
    urb = K.sentinel_like(dedup, w, dev)
    ure = K.sentinel_like(dedup, w, dev)
    urb[uh[take].to(torch.int64)] = s[take, :w]
    ure[uh[take].to(torch.int64)] = s[take, w:]
    uh_in = torch.empty_like(uh)
    uh_in[perm] = uh
    vmax_u = H.query_reads_vmax_plain(main_keys, main_tab, urb, ure)
    return vmax_u[uh_in.clamp(0, dedup - 1).to(torch.int64)], n_uniq


def dedup_vmax(main: H.VersionHistory, main_tab, rb, re, rvalid,
               dedup: int):
    """Each read's max main-tier version, probing only the distinct live
    (begin, end) ranges: (vmax [NR] int32, n_uniq [] int32).

    n_uniq counts the distinct live rows exactly; when it is at most
    `dedup` every live read's vmax equals the undeduplicated probe's.
    Past it the ranks >= dedup share the last buffer row (the latch
    discards that batch). Liveness is `rvalid`, the reads as packed,
    not the too-old-masked reads: a too-old txn's reads count.
    CUDA tensors run sort_ranks over the rows (kernels N and L at width
    2W: each read's unique rank, the distinct rows in order, and their
    count, which is n_uniq because a dead row is all ones and a live
    row's begin length word never is), kernel F's split of the first
    `dedup` distinct rows, kernel A's probe of them and F's gather.
    """
    if dedup <= 0:
        raise ValueError("dedup_vmax needs dedup >= 1")
    nr, w = rb.shape
    rows = dedup_rows(rb, re, rvalid)
    if rows.device.type == "cpu":
        return dedup_vmax_plain(main.main_keys, main_tab, rows, dedup)
    kernels.check_cuda("dedup_vmax", main.main_keys, main_tab, rows)
    kernels.check_words("dedup_vmax", w)
    dev = rows.device
    rank, ukeys, n_uniq = K.sort_ranks(rows)
    urb = torch.empty((dedup, w), dtype=torch.int32, device=dev)
    ure = torch.empty((dedup, w), dtype=torch.int32, device=dev)
    kernels.launch("dd_split", "read_dedup", ukeys, nr, w, dedup, urb, ure)
    vmax_u = H.query_reads_vmax(main, urb, ure, main_tab)
    vmax = torch.empty((nr,), dtype=torch.int32, device=dev)
    kernels.launch("dd_gather", "read_dedup", vmax_u, rank, nr, dedup, vmax)
    return vmax, n_uniq


def _main_stale(main: H.VersionHistory, main_tab, rb, re, rsnap, rvalid,
                dedup: int):
    """Probe the (immutable) main tier for one batch's read ranges.

    Returns (stale [NR] bool, dedup_ok [] bool). With dedup=0 every live
    range pays its own probe; with dedup=U only the distinct ranges are
    probed (dedup_vmax), and more than U distinct live ranges sets
    dedup_ok False: the caller's latch.
    """
    if dedup == 0:
        vmax = H.query_reads_vmax(main, rb, re, main_tab)
        return (vmax > rsnap) & rvalid, torch.ones(
            (), dtype=torch.bool, device=rb.device)
    vmax, n_uniq = dedup_vmax(main, main_tab, rb, re, rvalid, dedup)
    return (vmax > rsnap) & rvalid, n_uniq <= dedup


def sweep_read_ranks_plain(main_keys, rb, re, rvalid):
    """Plain version of kernel E: (il, ir) [R] int32, (-1, -1) on dead
    reads."""
    il = K.searchsorted_plain(main_keys, rb, side="right") - 1
    ir = K.searchsorted_plain(main_keys, re, side="left") - 1
    dead = torch.full_like(il, -1)
    return torch.where(rvalid, il, dead), torch.where(rvalid, ir, dead)


def sweep_read_ranks(main_keys, rb, re, rvalid):
    """Main-tier ranks of a whole group's read ranges, one launch.

    main_keys: [M, W] sorted main boundaries (sentinel tail); rb, re:
    [R, W] read begins/ends (R = all batches' reads, flattened); rvalid:
    [R] liveness. Returns (il, ir) int32 [R] with
    il = searchsorted_right(main, rb) - 1 and
    ir = searchsorted_left(main, re) - 1 on every live read — the JAX
    co-sort's tie order re < main < rb — and (-1, -1) on dead reads
    (JAX leaves those arbitrary; callers mask them). CPU tensors take
    the plain version (two searches); CUDA tensors run kernel E, one
    launch: the fenced tier search that kernel A's probe runs
    (kernels/csrc/tier_search.cuh `tier_ends`), the main tier's fence
    staged once a block in shared memory, each read's begin searched
    from the fence into its bucket and its end from the begin by a
    gallop over the fence and a 4-row window. The short-span group
    kernel takes its phase-(b) segments from it too (ops/group.py
    `_tier_segments`).
    """
    if rb.shape != re.shape or rb.ndim != 2 or rb.shape[1] != \
            main_keys.shape[1] or rvalid.shape != rb.shape[:1]:
        raise ValueError("sweep_read_ranks: rb, re [R, W], rvalid [R]")
    if main_keys.device.type == "cpu":
        return sweep_read_ranks_plain(main_keys, rb, re, rvalid)
    kernels.check_cuda("sweep_read_ranks", main_keys, rb, re)
    kernels.check_cuda("sweep_read_ranks", rvalid, dtype=torch.bool)
    kernels.check_words("sweep_read_ranks", rb.shape[1])
    r = rb.shape[0]
    il = torch.empty((r,), dtype=torch.int32, device=rb.device)
    ir = torch.empty((r,), dtype=torch.int32, device=rb.device)
    kernels.launch("sw_ranks", "sweep_ranks", main_keys, main_keys.shape[0],
                   main_keys.shape[1], rb, re, rvalid, r, il, ir)
    return il, ir


def attach_sweep_ranks(main: H.VersionHistory, g: dict) -> dict:
    """The whole group's main-tier ranks against the immutable main
    tier, attached to the stacked tree as "sweep_il"/"sweep_ir" ([G,
    NR]) for batch_body's sweep probe: one kernel E launch per group."""
    gn, nr, w = g["read_begin"].shape
    il, ir = sweep_read_ranks(
        main.main_keys,
        g["read_begin"].reshape(gn * nr, w),
        g["read_end"].reshape(gn * nr, w),
        g["read_valid"].reshape(gn * nr),
    )
    out = dict(g)
    out["sweep_il"] = il.reshape(gn, nr)
    out["sweep_ir"] = ir.reshape(gn, nr)
    return out


def sweep_rows_per_group(m: int, gn: int, nr: int) -> int:
    """The sweep's structural size: main boundaries plus two endpoints
    per read of the group — the rows the JAX co-sort sorts, and the
    rows kernel E's searches range over (the perf ledger's count)."""
    return m + 2 * gn * nr


def batch_body(main: H.VersionHistory, main_tab: torch.Tensor,
               carry, xs: dict, b: int, *, short_span_limit: int = 0,
               fixpoint_unroll: int = 3, fixpoint_latch: bool = False,
               dedup_reads: int = 0, range_sweep: bool = False,
               stats: G.FixpointStats = None):
    """One batch of the tiered loop: probe the immutable main tier, then
    resolve against (and merge committed writes into) the delta tier.

    carry = (delta, trip [] bool); xs = one batch's arguments (no
    leading axis; with `range_sweep` also its "sweep_il"/"sweep_ir");
    b = the txn capacity. `short_span_limit` S > 0 runs the delta tier's
    group kernel on kernel K's direct ops with the span latch (a trip is
    overflow, not a refusal); the main-tier probe is unchanged. An
    unconverged batch keeps its own delta
    unchanged (on the device) and sets the trip; later batches of the
    group still run against that delta, as in the JAX scan.
    Returns ((delta', trip'), GroupVerdict with [1]-leading leaves).
    """
    delta, trip = carry
    xs = dict(xs)
    sweep_il = xs.pop("sweep_il", None)
    sweep_ir = xs.pop("sweep_ir", None)
    # per-read snapshots (padding rows carry read_txn == b)
    snap_pad = torch.cat([
        xs["snapshot"],
        torch.full((1,), VERSION_NEG, dtype=torch.int32,
                   device=xs["snapshot"].device),
    ])
    rsnap = snap_pad[xs["read_txn"].to(torch.int64).clamp(0, b)]
    if range_sweep:
        vmax = rangemax.query(main_tab, torch.clamp(sweep_il, min=0),
                              sweep_ir + 1, op="max")
        stale_main = (vmax > rsnap) & xs["read_valid"]
        dedup_ok = None
    else:
        stale_main, dedup_ok = _main_stale(
            main, main_tab, xs["read_begin"], xs["read_end"], rsnap,
            xs["read_valid"], dedup_reads,
        )
    g1 = {k: (v[None] if isinstance(v, torch.Tensor) else [v])
          for k, v in xs.items()}
    delta2, out = G.resolve_group(
        delta, g1, short_span_limit=short_span_limit,
        fixpoint_unroll=fixpoint_unroll,
        fixpoint_latch=fixpoint_latch, extra_stale=stale_main[None],
        stats=stats, defer_trip=True,
    )
    trip2 = trip | out.unconverged[0]
    if dedup_ok is not None:
        trip2 = trip2 | ~dedup_ok
    return (delta2, trip2), out


def resolve_group_tiered(state: TieredState, g: dict, *,
                         short_span_limit: int = 0,
                         fixpoint_unroll: int = 3,
                         fixpoint_latch: bool = False,
                         dedup_reads: int = 0, range_sweep: bool = False,
                         stats: G.FixpointStats = None,
                         defer_trip: bool = False):
    """Resolve G stacked batches (versions ascending) against the tiered
    history. Returns (state', GroupVerdict with [G]-leading leaves).

    `unconverged` is the group-wide trip (some batch's fixpoint latch,
    or more than `dedup_reads` distinct live ranges in some batch),
    broadcast over G. With the latch or dedup armed a tripped group
    returns the input state unchanged, both tiers: this reads the trip
    once per group (one sync), and the caller re-runs the group on the
    exact configuration (fixpoint_latch off, dedup_reads 0).

    `defer_trip=True` is for a caller that owns the trip of several
    tiered states (parallel/sharding.py: any shard's trip refuses the
    group on every shard): nothing is read, the state comes back as the
    group left it, and the return is (state', GroupVerdict, trip [] bool
    on the device); restoring the input state is the caller's.
    """
    gn, b = g["txn_valid"].shape
    if gn > MAX_GROUP_TIERED:
        raise ValueError(f"group of {gn} > MAX_GROUP_TIERED {MAX_GROUP_TIERED}")
    # main is immutable for the whole group: one table build
    main_tab = rangemax.build(state.main.main_ver, op="max")
    if range_sweep:
        if dedup_reads:
            raise ValueError("range_sweep and dedup_reads are exclusive")
        g = attach_sweep_ranks(state.main, g)
    carry = (state.delta,
             torch.zeros((), dtype=torch.bool, device=main_tab.device))
    outs = []
    for i in range(gn):
        xs = {k: v[i] for k, v in g.items()}
        carry, out = batch_body(
            state.main, main_tab, carry, xs, b,
            short_span_limit=short_span_limit,
            fixpoint_unroll=fixpoint_unroll, fixpoint_latch=fixpoint_latch,
            dedup_reads=dedup_reads, range_sweep=range_sweep, stats=stats,
        )
        outs.append(out)
    delta, trip = carry
    cat = {f: torch.cat([getattr(o, f) for o in outs])
           for f in G.GroupVerdict._fields}
    cat["overflow"] = cat["overflow"] | state.main.overflow
    cat["unconverged"] = trip.repeat(gn)
    new_state = TieredState(main=state.main, delta=delta)
    if defer_trip:
        return new_state, G.GroupVerdict(**cat), trip
    if (fixpoint_latch or dedup_reads) and bool(trip):
        new_state = state
    return new_state, G.GroupVerdict(**cat)


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


def boundary_counts_per_shard(states):
    """([S] main, [S] delta) live-boundary counts of S shards' tiered
    states (parallel/sharding.py): the worst-shard occupancy input of
    the sharded overflow check. The single-tier counter per shard, so
    the liveness rule has one source."""
    return (torch.stack([H.boundary_count(s.main) for s in states]),
            torch.stack([H.boundary_count(s.delta) for s in states]))
