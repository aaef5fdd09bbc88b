"""Kernel A's search (K2) and counts (K6) and kernel E (K11) on the inputs
their designs find hard, held against the JAX package on the CPU.

Every case of `foundationdb_tpu_torch/testing/search_cases.py` runs
through the JAX function and the port's CPU path (the plain versions the
card's kernels are held to in tests/test_torch_cuda.py and chip_smoke.py):

* `searchsorted_plain(side="both")` against JAX `ops/keys.searchsorted`
  left and right, at W = 1 .. 8: tiers of one row, wholly in the fence,
  at and one past the fence's cap and far past it, full, with repeated
  rows and with a sentinel tail of exactly the window's rows; queries
  equal to, next to and far from the rows, and sentinels;
* `ops/group._sorted_counts` (its plain path) against JAX
  `_sorted_counts`: ids with gaps, all equal, all at B past an int16's
  count, none, a tile's ids past the block's stride, ids past the last
  segment, a classic group of 8's shape;
* `ops/delta.sweep_read_ranks_plain` against JAX `sweep_read_ranks` on
  the live reads (forward, inverted and empty) of every search case;
* `_tier_segments` and `_block_spans`, as the classic group kernel at
  S = 4 calls them (kernel E's ends, one both-sides search), against the
  formulas they replaced (four and six plain searches).

Beside them, numpy transcriptions of the card designs' steps (the fenced
search with its window and the search past it; the counts' block-wide
rounds, histogram and scan) are held to the plain versions on every
case, each case shown to reach the part it is named for. Every output is
an integer, so the tolerance is equality throughout.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import delta as JD
from foundationdb_tpu.ops import group as JG
from foundationdb_tpu.ops import keys as JK
from foundationdb_tpu_torch import interop
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.ops import delta as D
from foundationdb_tpu_torch.ops import group as G
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.ops import keys as K
from foundationdb_tpu_torch.testing import search_cases as SC
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import packing

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

_JAX_SWEEP = jax.jit(JD.sweep_read_ranks)
WINDOW = SC.WINDOW


@functools.lru_cache(maxsize=None)
def search_case(name: str, w: int) -> SC.SearchCase:
    return SC.search_case(name, w)


def t(a: np.ndarray) -> torch.Tensor:
    return interop.to_torch(np.asarray(a), "cpu")


def u32(a: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(np.asarray(a).view(np.uint32))


# ---------------------------------------------------------------------------
# K2: the search, both sides

@pytest.mark.parametrize("w", SC.WIDTHS)
@pytest.mark.parametrize("name", SC.SEARCH_NAMES)
def test_search_both_matches_jax(name, w):
    c = search_case(name, w)
    left, right = K.searchsorted_plain(t(c.keys), t(c.queries), side="both")
    for side, got in (("left", left), ("right", right)):
        want = np.asarray(JK.searchsorted(u32(c.keys), u32(c.queries),
                                          side=side))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), side
        assert torch.equal(got, K.searchsorted(t(c.keys), t(c.queries),
                                               side=side)), side


def ranks(keys: np.ndarray, queries: np.ndarray):
    """Order ranks of the tier's rows and the queries (rows compared as
    uint32 words, left to right)."""
    rows = np.concatenate([keys, queries]).view(np.uint32)
    _, inv = np.unique(rows, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    return inv[: keys.shape[0]], inv[keys.shape[0]:]


def bsearch(vals, lo, hi, q, right: bool):
    """The first index of [lo, hi) whose value the predicate fails on
    (right: value <= q passes; left: value < q), or hi; vectorized."""
    lo, hi = lo.copy(), hi.copy()
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) >> 1
        v = vals[np.minimum(mid, max(len(vals) - 1, 0))] if len(vals) else mid
        go = (v <= q) if right else (v < q)
        lo = np.where(act & go, mid + 1, lo)
        hi = np.where(act & ~go, mid, hi)
    return lo


def bucket_of(c, s: int, m: int):
    return (np.where(c == 0, 0, ((c - 1) << s) + 1),
            np.where(c == 0, 0, np.minimum(c << s, m)))


def fenced_model(keys: np.ndarray, queries: np.ndarray, w: int):
    """tier_search.cuh's tier_bound and tier_both on order ranks: (left,
    right by tier_bound, right by tier_both, the parts reached)."""
    kr, qr = ranks(keys, queries)
    m = kr.shape[0]
    s = SC.fence_shift(m, w)
    fence = kr[:: 1 << s]
    nf = fence.shape[0]
    zero, full = np.zeros_like(qr), np.full_like(qr, nf)

    def bound(right):
        c = bsearch(fence, zero, full, qr, right)
        lo, hi = bucket_of(c, s, m)
        return bsearch(kr, lo, hi, qr, right), c

    left, c = bound(False)
    right_one, _ = bound(True)
    # tier_both: the window's rows equal to q, a bucket search past it
    cnt = np.zeros_like(qr)
    for k in range(WINDOW):
        at = left + k
        ok = at < m
        cnt += ok & (kr[np.minimum(at, m - 1)] <= qr) if m else 0
    right = left + cnt
    past = cnt == WINDOW
    at_end = past & (kr[m - 1] <= qr)      # q is the tier's last row
    cr = bsearch(fence, c, full, qr, True)
    lo, hi = bucket_of(cr, s, m)
    right = np.where(past, bsearch(kr, np.maximum(lo, left + WINDOW), hi,
                                   qr, True), right)
    right = np.where(at_end, m, right)
    parts = {"fence only" if s == 0 else "fence and bucket",
             *(["window full"] if (past & ~at_end).any() else []),
             *(["last row"] if at_end.any() else []),
             *(["window short"] if (~past).any() else [])}
    return left, right_one, right, parts


REACHES = {"repeated rows": "window full", "sentinel queries": "last row",
           "random": "last row", "in the fence": "fence only",
           "at the fence cap": "fence only",
           "one past the fence cap": "fence and bucket",
           "past the fence cap": "fence and bucket"}


@pytest.mark.parametrize("w", SC.WIDTHS)
@pytest.mark.parametrize("name", SC.SEARCH_NAMES)
def test_search_design_matches_plain(name, w):
    c = search_case(name, w)
    left, right_one, right, parts = fenced_model(c.keys, c.queries, w)
    pl, pr = K.searchsorted_plain(t(c.keys), t(c.queries), side="both")
    assert np.array_equal(left, pl.numpy())
    assert np.array_equal(right_one, pr.numpy())
    assert np.array_equal(right, pr.numpy())
    if name in REACHES:
        assert REACHES[name] in parts, parts
    if name == "sentinel queries":   # a tail of exactly the window's rows
        sent = np.all(c.queries.view(np.uint32) == SC.SENT, axis=1)
        assert (right[sent] == c.keys.shape[0]).all()
        assert (left[sent] == c.keys.shape[0] - WINDOW).all()


# ---------------------------------------------------------------------------
# K6: the counts

@pytest.mark.parametrize("name", SC.COUNT_NAMES)
def test_sorted_counts_matches_jax(name):
    c = SC.count_case(name)
    want = np.asarray(JG._sorted_counts(jnp.asarray(c.ids), c.n_seg))
    got = G._sorted_counts(t(c.ids), c.n_seg)
    assert got.dtype == torch.int32 and got.shape == (c.n_seg + 1,)
    assert np.array_equal(got.numpy(), want)


def counts_model(ids: np.ndarray, n_seg: int, tile: int):
    """keysearch.cu's counts_kernel: each block's two ends by a warp's
    search (a first round at the interpolated place, then 33-ary rounds),
    its histogram and exclusive scan. Returns (off, the most rounds a
    search took, the most ids a block counted)."""
    u = ids.view(np.uint32).astype(np.int64)
    n = u.shape[0]
    off = np.zeros(n_seg + 1, np.int64)
    most_rounds = most_ids = 0
    lane = np.arange(32)

    def count_below(x):
        lo, hi, rounds = 0, n, 0
        if n > 32 * 32:
            w0 = min(max(x * n // (n_seg + 1) - 16 * 32, 0), n - 32 * 32)
            cnt = int((u[w0 + 32 * lane + 31] < x).sum())
            rounds += 1
            lo = lo if cnt == 0 else w0 + 32 * cnt
            hi = hi if cnt == 32 else w0 + 32 * cnt + 31
        while hi - lo > 32:
            ln = hi - lo
            cnt = int((u[lo + (lane + 1) * ln // 33] < x).sum())
            lo, hi = (lo if cnt == 0 else lo + cnt * ln // 33 + 1,
                      hi if cnt == 32 else lo + (cnt + 1) * ln // 33)
            rounds += 1
        p = lo + lane
        ok = p < hi
        return lo + int((u[p[ok]] < x).sum()), rounds + 1

    for t0 in range(0, n_seg + 1, tile):
        t1 = min(t0 + tile, n_seg + 1)
        (a, ra), (b, rb) = count_below(t0), count_below(t1)
        most_rounds = max(most_rounds, ra, rb)
        most_ids = max(most_ids, b - a)
        bins = np.bincount(u[a:b] - t0, minlength=t1 - t0)
        off[t0:t1] = a + np.cumsum(bins) - bins
    return off, most_rounds, most_ids


@pytest.mark.parametrize("name", SC.COUNT_NAMES)
def test_counts_design_matches_plain(name):
    c = SC.count_case(name)
    off, rounds, most = counts_model(c.ids, c.n_seg, SC.COUNT_TILE)
    assert np.array_equal(off, G._sorted_counts_plain(t(c.ids),
                                                      c.n_seg).numpy())
    if name == "tile overfull":
        assert most > SC.COUNT_TILE
    if name == "all at B":
        assert most > np.iinfo(np.int16).max
    if name == "one read a txn":  # every end near its interpolated place
        assert rounds == 2
    if name in ("tile overfull", "bench shape"):   # and ends past it
        assert rounds > 2


# ---------------------------------------------------------------------------
# K11: the sweep's ends

@pytest.mark.parametrize("w", SC.WIDTHS)
@pytest.mark.parametrize("name", SC.SEARCH_NAMES)
def test_sweep_matches_jax(name, w):
    """On the live reads whose ends are real keys (the JAX sweep sorts an
    all-ones end among the tier's sentinel tail)."""
    c = SC.sweep_case(name, w)
    j_il, j_ir = _JAX_SWEEP(u32(c.keys), u32(c.rb), u32(c.re),
                            jnp.asarray(c.live))
    il, ir = D.sweep_read_ranks_plain(t(c.keys), t(c.rb), t(c.re),
                                      t(c.live))
    real = c.live & ~np.all(c.rb.view(np.uint32) == SC.SENT, axis=1) & \
        ~np.all(c.re.view(np.uint32) == SC.SENT, axis=1)
    assert real.sum() > c.live.sum() // 2
    assert np.array_equal(il.numpy()[real], np.asarray(j_il)[real])
    assert np.array_equal(ir.numpy()[real], np.asarray(j_ir)[real])
    dead = ~c.live
    assert (il.numpy()[dead] == -1).all() and (ir.numpy()[dead] == -1).all()
    assert torch.equal(il, D.sweep_read_ranks(t(c.keys), t(c.rb), t(c.re),
                                              t(c.live))[0])


# ---------------------------------------------------------------------------
# the classic group kernel at S = 4: phase (b)'s segments and the cross
# span, against the formulas they replaced

def tier_segments_before(main_keys, rb, re):
    il = K.searchsorted_plain(main_keys, rb, side="right") - 1
    ir = K.searchsorted_plain(main_keys, re, side="left") - 1
    return il.clamp(min=0), ir + 1


def block_spans_before(main_keys, ukeys, rank_rb, rank_re, rb, re):
    in_tier = (K.searchsorted_plain(main_keys, ukeys, side="right")
               > K.searchsorted_plain(main_keys, ukeys, side="left"))
    shared = torch.cat([torch.zeros((1,), dtype=torch.int32),
                        torch.cumsum(in_tier.to(torch.int32), 0,
                                     dtype=torch.int32)])

    def block(rank, k):
        return (rank + K.searchsorted_plain(main_keys, k, side="left")
                - shared[rank.to(torch.int64)])

    return block(rank_re, re) - block(rank_rb, rb)


CFG = KernelConfig(max_key_bytes=8, max_txns=64, max_reads=128,
                   max_writes=128, history_capacity=2048, window_versions=250)


def group_of(rng, gn: int, base: int):
    """gn packed batches of point and short range txns over 300 one- and
    two-byte keys; snapshots old enough that some txns are too old."""
    def key(i):
        return bytes([i % 256]) + (bytes([i // 256]) if i >= 256 else b"")

    batches = []
    for g in range(gn):
        version = base + (g + 1) * 100
        txns = []
        for _ in range(int(rng.integers(20, 64))):
            reads = []
            for _ in range(int(rng.integers(0, 3))):
                a = int(rng.integers(0, 300))
                reads.append((key(a), key(a) + b"\x00")
                             if rng.random() < 0.6 else
                             (key(a), key(min(a + int(rng.integers(1, 4)),
                                                299))))
            writes = [(key(b), key(b) + b"\x00") for b in
                      rng.integers(0, 300, int(rng.integers(1, 3)))]
            txns.append(CommitTransaction(
                read_conflict_ranges=[r for r in reads if r[0] < r[1]],
                write_conflict_ranges=writes,
                read_snapshot=int(version - rng.integers(50, 400))))
        batches.append(packing.pack_batch(txns, version, 0, CFG))
    return batches


@pytest.mark.parametrize("gn", [2, 8])
def test_segments_and_block_spans_match_the_formulas_they_replaced(
        gn, monkeypatch):
    rng = np.random.default_rng(gn)
    seen = {}
    tier_segments, block_spans = G._tier_segments, G._block_spans

    def rec_segments(main_keys, rb, re, live):
        out = tier_segments(main_keys, rb, re, live)
        seen["seg"] = (main_keys, rb, re, live, out)
        return out

    def rec_spans(main_keys, ukeys, rank_rb, rank_re, rb, left_re):
        out = block_spans(main_keys, ukeys, rank_rb, rank_re, rb, left_re)
        seen["spans"] = (ukeys, rank_rb, rank_re, out)
        return out

    monkeypatch.setattr(G, "_tier_segments", rec_segments)
    monkeypatch.setattr(G, "_block_spans", rec_spans)
    state = H.init(CFG, "cpu")
    dead = 0
    for step in range(3):
        g = interop.device_args_to_torch(packing.stack_device_args(
            group_of(rng, gn, 1_000 + step * 1_000)), "cpu")
        state, _ = G.resolve_group(state, g, short_span_limit=4)
        main_keys, rb, re, live, (lo, hi) = seen["seg"]
        ukeys, rank_rb, rank_re, spans = seen["spans"]
        want_lo, want_hi = tier_segments_before(main_keys, rb, re)
        assert torch.equal(lo[live], want_lo[live])
        assert torch.equal(hi[live], want_hi[live])
        assert (lo[~live] == 0).all() and (hi[~live] == 0).all()
        want = block_spans_before(main_keys, ukeys, rank_rb, rank_re, rb, re)
        assert torch.equal(spans[live], want[live])
        dead += int((~live & g["read_valid"].reshape(-1)).sum())
    assert dead > 0, "some valid reads must be too old (dead)"
    assert int(H.boundary_count(state)) > 0
