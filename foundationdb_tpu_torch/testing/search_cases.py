"""Kernel A's search and counts, and kernel E: seeded cases about their edges.

The search (`ks_search`, kernels/csrc/keysearch.cu) and kernel E
(`sw_ranks`, kernels/csrc/sweep_ranks.cu) run the fenced tier search of
kernels/csrc/tier_search.cuh: every 2^s-th tier row (the fence, at most
FENCE_BYTES) staged in shared memory, a bucket search in global memory,
and a WINDOW-row load after the first answer (the both-sides search: the
rows equal to the query, a bucket search only when all WINDOW are
equal; E: a read's end from its begin). The counts (`ks_counts`) give a
block a tile of COUNT_TILE segment ids, find the tile's two ends in the
ids by a warp's rounds of one load a lane, and count the ids between
into a shared-memory histogram.

Each search case is a tier (keys [m, W] int32 bit patterns, rows sorted
as uint32 words left to right, with an all-ones tail unless named
otherwise) and queries [Q, W], at any W in WIDTHS: tier rows, their
neighbours one below and one above in the last word, random rows, the
all-zero row and all-ones (sentinel) rows. Rows are any words of WORDS
or random, with the last word below LAST, so that the JAX sweep (which
reads the last word as a packed key's length) orders them as the
search does. Each sweep case takes a case's tier and pairs of its
queries as reads (forward, inverted, empty), a tenth dead. Each count
case is nondecreasing int32 segment ids and n_seg.

The card lane (tests/test_torch_cuda.py), chip_smoke.py's phase 2 and
the CPU tests (tests/test_torch_searches.py) draw the same cases.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from foundationdb_tpu_torch.testing.probe_cases import FENCE_BYTES, WINDOW

#: the words a row's data words are drawn from, beside random ones
WORDS = (0, 1, 0x7F, 0x80, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF)
#: the last word stays below this (a packed key's length word is tiny)
LAST = 1 << 20
SENT = 0xFFFFFFFF
WIDTHS = tuple(range(1, 9))
#: kCountTile in keysearch.cu: the segment ids a counts block owns
COUNT_TILE = 1024
QUERIES = 2_048

SEARCH_NAMES = ("random", "repeated rows", "sentinel queries", "one row",
                "in the fence", "at the fence cap", "one past the fence cap",
                "past the fence cap", "full tier")
COUNT_NAMES = ("gaps", "all equal", "all at B", "empty", "tile overfull",
               "past the last segment", "one read a txn", "bench shape")


class SearchCase(NamedTuple):
    keys: np.ndarray     # [m, W] int32, sorted, sentinel tail
    queries: np.ndarray  # [Q, W] int32


class SweepCase(NamedTuple):
    keys: np.ndarray     # [m, W] int32
    rb: np.ndarray       # [Q, W] int32
    re: np.ndarray       # [Q, W] int32
    live: np.ndarray     # [Q] bool


class CountCase(NamedTuple):
    ids: np.ndarray      # [n] int32, nondecreasing
    n_seg: int


def fence_shift(m: int, w: int) -> int:
    """tier_search.cuh's fence_of: the least s with ceil(m / 2^s) rows of
    W words within FENCE_BYTES."""
    s = 0
    while -(-m // (1 << s)) * w * 4 > FENCE_BYTES:
        s += 1
    return s


def sort_rows(a: np.ndarray) -> np.ndarray:
    """[n, W] uint32 rows in order (word 0 most significant)."""
    if a.shape[0] == 0:
        return a
    return a[np.lexsort(a.T[::-1])]


def draw_rows(rng, n: int, w: int) -> np.ndarray:
    """[n, w] uint32 rows, never all-ones: data words from WORDS or
    random, the last word below LAST."""
    pick = rng.integers(0, len(WORDS) + 1, (n, w - 1))
    data = np.where(pick < len(WORDS), np.asarray(WORDS + (0,), np.uint32)[
        np.minimum(pick, len(WORDS))], rng.integers(0, 1 << 32, (n, w - 1),
                                                   dtype=np.uint64
                                                   ).astype(np.uint32))
    last = rng.integers(0, LAST, (n, 1)).astype(np.uint32)
    last[rng.random(n) < 0.1] = 0
    return np.concatenate([data, last], axis=1).astype(np.uint32)


def tier_of(rows: np.ndarray, m: int, w: int) -> np.ndarray:
    """[m, w] int32: the rows sorted, then an all-ones tail."""
    keys = np.full((m, w), SENT, np.uint32)
    keys[: rows.shape[0]] = sort_rows(rows)
    return keys.view(np.int32)


def queries_of(rng, keys: np.ndarray, w: int, n: int = QUERIES,
               sentinels: int = 32) -> np.ndarray:
    """[n, w] int32: tier rows, each one below and one above in the last
    word, random rows, the zero row and `sentinels` all-ones rows."""
    k = keys.view(np.uint32)
    live = k[~np.all(k == SENT, axis=1)]
    parts = [np.zeros((1, w), np.uint32), np.full((sentinels, w), SENT,
                                                  np.uint32)]
    if live.shape[0]:
        at = live[rng.integers(0, live.shape[0], n // 2)]
        below, above = at.copy(), at.copy()
        below[:, -1] -= (below[:, -1] > 0).astype(np.uint32)
        above[:, -1] += (above[:, -1] < LAST - 1).astype(np.uint32)
        parts += [at, below[: n // 8], above[: n // 8]]
    parts.append(draw_rows(rng, n, w))
    q = np.concatenate(parts)[:n]
    return q[rng.permutation(q.shape[0])].view(np.int32)


def search_case(name: str, w: int) -> SearchCase:
    """The named search case (SEARCH_NAMES) at key width w, from a seed of
    its own."""
    rng = np.random.default_rng([SEARCH_NAMES.index(name), w, 12])
    cap = FENCE_BYTES // (4 * w)    # the most rows a fence of s = 0 holds
    sentinels = 32
    if name == "random":
        keys = tier_of(draw_rows(rng, 2_000, w), 3_000, w)
    elif name == "repeated rows":
        # runs of one row, shorter than, at and longer than the window,
        # across fence rows and buckets (s >= 1 at every width)
        distinct = sort_rows(np.unique(draw_rows(rng, 600, w), axis=0))
        lens = np.array([1, 2, 3, WINDOW - 1, WINDOW, WINDOW + 1, 7, 8, 9,
                         31, 32, 33, 100, 1_000, 2_500])
        reps = np.ones(distinct.shape[0], np.int64)
        reps[rng.permutation(distinct.shape[0])[: 5 * lens.shape[0]]] = \
            np.tile(lens, 5)
        rows = np.repeat(distinct, reps, axis=0)[:9_800]
        keys = tier_of(rows, 10_000, w)
    elif name == "sentinel queries":
        # a tail of exactly WINDOW all-ones rows: the window is all equal
        # and the right search past it ends at m
        keys = tier_of(draw_rows(rng, 2_000, w), 2_000 + WINDOW, w)
        sentinels = 400
    elif name == "one row":
        keys = tier_of(draw_rows(rng, 1, w), 1, w)
    elif name == "in the fence":
        keys = tier_of(draw_rows(rng, 200, w), 250, w)
    elif name == "at the fence cap":
        keys = tier_of(draw_rows(rng, cap - 10, w), cap, w)
    elif name == "one past the fence cap":
        keys = tier_of(draw_rows(rng, cap, w), cap + 1, w)
    elif name == "past the fence cap":
        keys = tier_of(draw_rows(rng, 30_000, w), 40_000, w)
    elif name == "full tier":
        keys = tier_of(draw_rows(rng, 3_000, w), 3_000, w)
    else:
        raise ValueError(f"unknown search case {name!r}")
    return SearchCase(keys, queries_of(rng, keys, w, sentinels=sentinels))


def sweep_case(name: str, w: int) -> SweepCase:
    """The named search case's tier with reads made of its queries: a
    third forward, a third inverted, the rest empty or with one end an
    all-ones row; a tenth dead."""
    c = search_case(name, w)
    rng = np.random.default_rng([SEARCH_NAMES.index(name), w, 13])
    a = c.queries.view(np.uint32)
    b = a[rng.permutation(a.shape[0])]
    q = a.shape[0]
    swap = np.zeros(q, bool)
    for i in range(q):     # order each pair: begin < end
        x, y = tuple(a[i]), tuple(b[i])
        swap[i] = y < x
    lo = np.where(swap[:, None], b, a)
    hi = np.where(swap[:, None], a, b)
    kind = rng.integers(0, 3, q)
    rb = np.where((kind == 1)[:, None], hi, lo)       # inverted
    re = np.where((kind == 1)[:, None], lo, hi)
    re = np.where((kind == 2)[:, None] & (rng.random(q) < 0.5)[:, None],
                  rb, re)                               # empty
    live = rng.random(q) >= 0.1
    return SweepCase(c.keys, rb.astype(np.uint32).view(np.int32),
                     re.astype(np.uint32).view(np.int32), live)


def count_case(name: str) -> CountCase:
    """The named count case (COUNT_NAMES), from a seed of its own."""
    rng = np.random.default_rng([COUNT_NAMES.index(name), 14])
    if name == "gaps":      # few txns with reads, padding at B
        b = 3_000
        txns = np.sort(rng.choice(b, 30, replace=False))
        ids = np.concatenate([np.sort(rng.choice(txns, 4_000)),
                              np.full(1_000, b)])
        return CountCase(ids.astype(np.int32), b + 1)
    if name == "all equal":
        return CountCase(np.full(3_000, 7, np.int32), 2_000)
    if name == "all at B":  # one bin past an int16's count
        b = 1_500
        return CountCase(np.full(70_000, b, np.int32), b + 1)
    if name == "empty":
        return CountCase(np.zeros(0, np.int32), 100)
    if name == "tile overfull":
        # ids of one tile [1024, 2048) outnumber the block's threads and
        # its bins (b - a > COUNT_TILE) in runs, and a few in other tiles
        t0 = COUNT_TILE
        inner = np.sort(t0 + rng.integers(0, COUNT_TILE, 5_000))
        inner[:1_500] = t0 + 3
        ids = np.concatenate([np.sort(rng.integers(0, t0, 300)),
                              np.sort(inner),
                              np.sort(rng.integers(2 * t0, 4 * t0, 300))])
        return CountCase(np.sort(ids).astype(np.int32), 4 * t0)
    if name == "past the last segment":
        n_seg = 1_000
        ids = np.sort(rng.integers(n_seg - 5, n_seg + 50, 2_000))
        return CountCase(ids.astype(np.int32), n_seg)
    if name == "one read a txn":
        # the uniform stream's: a read a txn, the last 1% padding at B
        b = 65_536
        ids = np.arange(b)
        ids[-b // 100:] = b
        return CountCase(ids.astype(np.int32), b + 1)
    if name == "bench shape":
        # a classic group of 8 batches' flat segment ids batch * (B + 1) +
        # txn: 65,536 reads a batch of random txns, 1% padding at B
        gn, b = 8, 65_536
        txn = np.sort(rng.integers(0, b, (gn, b)), axis=1)
        txn[:, -b // 100:] = b
        ids = (np.arange(gn)[:, None] * (b + 1) + txn).reshape(-1)
        return CountCase(ids.astype(np.int32), gn * (b + 1))
    raise ValueError(f"unknown count case {name!r}")
