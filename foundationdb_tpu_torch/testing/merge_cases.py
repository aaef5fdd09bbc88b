"""Kernel D's hard inputs: seeded map pairs about its tiles.

`merge_maps` on the card (`mm_merge`, kernels/csrc/merge_maps.cu) cuts
the merged order of the real rows, positions [0, R), into tiles: of
SMALL_TILE positions where ceil(R / SMALL_TILE) tiles fit in one round
of its grid (the co-resident blocks), else of TILE. It decides a run of
equal keys at the run's last row, where a thread whose first row
continues a run from before gallops back to the run's first rows; the
tiles fill the output rows their dropped rows free, [count, R), and
tickets past the tiles fill [R, capacity) in chunks of TILE rows. Each
case here is two sorted maps (keys [n, W] int32 bit patterns with a
sentinel tail, values [n] int32), a floor and a capacity, as numpy
arrays, built to reach one of those parts:

* live rows at 0, 1, TILE - 1, TILE and TILE + 1 in each map, maps of
  nothing but sentinel rows over several tiles (a capacity past both),
  and a full 786,432-row tier against a batch's 131,072 coverage
  rows (`large`);
* a run of 5,000 equal keys in B across two tile edges, alone and with
  A holding the key too;
* A and B sharing every key, so that one pair of equal keys straddles
  every tile edge;
* the coverage's own runs: many writes ending (and beginning) at one
  key, hundreds of rows of that key with the running depth's values;
* duplicate keys in A, every value under the floor, and a capacity
  under the count;
* `large run 5000`, `large shared at every edge` and `large capacity
  under the count`: those cases with PAD more live rows in A above
  every key of the case, so that R passes what one round of small tiles
  covers (BIG_TILE_R) and the kernel takes TILE-position tiles, 8 a
  thread; the hard part keeps its merged positions, at multiples of
  TILE, and the capacity runs past R by several tail chunks (or, for
  the last, stops half way through the padding).

The edges at multiples of TILE are edges of the small tiles too. The
card lane (tests/test_torch_cuda.py), chip_smoke.py's phase 2 and the
CPU tests (tests/test_torch_merge.py) draw the same cases.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from foundationdb_tpu_torch.testing.benchgen import int_keys_packed

#: merged positions of mm_merge's large tile (kTile in merge_maps.cu),
#: and rows of one of its tail chunks
TILE = 2048
#: merged positions of its small tile (kSmallTile)
SMALL_TILE = 1024
#: the real rows past which one round of small tiles falls short on an
#: H100 at W = 3 (528 co-resident blocks), so that the large tiles run;
#: at W = 5 the grid, and with it this, is smaller
BIG_TILE_R = 528 * SMALL_TILE
#: live rows the `large ...` variants add to A
PAD = 600_000
#: a full tier and a batch's coverage rows at the bench shape
TIER = 786_432
COVERAGE = 131_072
NEG = -(2**31) + 1
SENT = 0xFFFFFFFF
#: the values the cases draw, and the floor that GCs the lowest fifth
VLO, VHI, FLOOR = 1_000, 6_000, 2_000


class MergeCase(NamedTuple):
    a_keys: np.ndarray   # [na, W] int32, sorted, sentinel tail
    a_val: np.ndarray    # [na] int32
    b_keys: np.ndarray   # [nb, W] int32
    b_val: np.ndarray    # [nb] int32
    floor: int
    capacity: int


#: (live A rows, live B rows) of the size cases
LIVE = ((0, 0), (0, 1), (1, 0), (1, 1), (TILE - 1, TILE - 1), (TILE, TILE),
        (TILE + 1, TILE + 1), (TILE - 1, TILE + 1), (TILE + 1, 0))
#: the cases that pad a smaller one past BIG_TILE_R
PADDED = ("run 5000", "shared at every edge", "capacity under the count")
#: every case's name; `large` ones are for the card only
NAMES = (*(f"live {a}+{b}" for a, b in LIVE), "all sentinel", "large",
         "run 5000", "run 5000 shared", "shared at every edge",
         "coverage runs", "dups in A", "all under the floor",
         "capacity under the count", *(f"large {n}" for n in PADDED))


def table(ints: np.ndarray, rows: int, w: int) -> np.ndarray:
    """[rows, w] int32 keys: the sorted 8-byte keys of `ints` (repeats
    kept), then sentinel rows."""
    out = np.full((rows, w), SENT, np.uint32)
    out[: ints.shape[0]] = int_keys_packed(np.sort(ints), 8, w)
    return out.view(np.int32)


def values(rng, live: int, rows: int, lo: int = VLO, hi: int = VHI
           ) -> np.ndarray:
    """[rows] int32: random values over the live rows, a fifth of them
    repeating their predecessor's (redundant rows), every ninth NEG; NEG
    on the tail."""
    out = np.full((rows,), NEG, np.int32)
    v = rng.integers(lo, hi, live).astype(np.int32)
    v[1::5] = v[0::5][: v[1::5].shape[0]]
    v[::9] = NEG
    out[:live] = v
    return out


def coverage(rng, n_writes: int, keyspace: int, hot: int, n_hot: int,
             version: int, w: int):
    """A batch's write coverage as ops/group._coverage builds it: every
    [begin, end) endpoint sorted (stable), the running begin-minus-end
    depth after each row, `version` where it is positive. n_hot of the
    writes end at key `hot` and as many begin there, so the key repeats
    about 2 n_hot times."""
    b = rng.integers(0, keyspace, n_writes)
    e = b + rng.integers(1, keyspace // 50 + 2, n_writes)
    e[:n_hot] = hot
    b[:n_hot] = np.minimum(b[:n_hot], hot - 1)
    b[n_hot:2 * n_hot] = hot
    e[n_hot:2 * n_hot] = np.maximum(e[n_hot:2 * n_hot], hot + 1)
    ends = np.concatenate([b, e])
    step = np.concatenate([np.ones(n_writes), -np.ones(n_writes)])
    order = np.argsort(ends, kind="stable")
    depth = np.cumsum(step[order])
    val = np.where(depth > 0, version, NEG).astype(np.int32)
    return table(ends[order], 2 * n_writes, w), val


def draw(rng, n: int, keyspace: int) -> np.ndarray:
    """n distinct keys under keyspace."""
    return rng.choice(keyspace, size=n, replace=False)


def padded(rng, c: MergeCase, w: int, more_capacity: int) -> MergeCase:
    """c with PAD live rows in A after its own, keys above every key of
    c (c's keys are under 2^21), and `more_capacity` more rows."""
    live = int((c.a_keys.view(np.uint32)[:, -1] != SENT).sum())
    pad = (1 << 21) + draw(rng, PAD, (1 << 30) - (1 << 21))
    keys = table(pad, PAD, w)
    return c._replace(
        a_keys=np.concatenate([c.a_keys[:live], keys, c.a_keys[live:]]),
        a_val=np.concatenate([c.a_val[:live], values(rng, PAD, PAD),
                              c.a_val[live:]]),
        capacity=c.capacity + more_capacity)


def case(name: str, w: int = 3) -> MergeCase:
    """The named case (NAMES) at key width w, from a seed of its own."""
    rng = np.random.default_rng([NAMES.index(name), w])
    if name.startswith("large "):
        base = name[6:]
        more = PAD // 2 if base == "capacity under the count" \
            else PAD + 2 * TILE + 3
        return padded(rng, case(base, w), w, more)
    if name.startswith("live "):
        la, lb = (int(x) for x in name[5:].split("+"))
        keyspace = 2 * (la + lb) + 8   # many keys in both maps
        na, nb = la + la // 4 + 3, lb + lb // 4 + 3
        return MergeCase(table(draw(rng, la, keyspace), na, w),
                         values(rng, la, na),
                         table(draw(rng, lb, keyspace), nb, w),
                         values(rng, lb, nb), FLOOR, max(na, nb))
    if name == "all sentinel":   # tiles of nothing but the tails
        return MergeCase(table(np.zeros(0, np.int64), 2 * TILE + 9, w),
                         values(rng, 0, 2 * TILE + 9),
                         table(np.zeros(0, np.int64), TILE + 3, w),
                         values(rng, 0, TILE + 3), FLOOR, 3 * TILE)
    if name == "large":
        keys, val = coverage(rng, COVERAGE // 2, 1 << 30, 1 << 29, 300,
                             VHI + 1, w)
        return MergeCase(table(draw(rng, TIER, 1 << 30), TIER, w),
                         values(rng, TIER, TIER), keys, val, FLOOR, TIER)
    if name.startswith("run 5000"):
        hot = 500_000
        a = draw(rng, 3_000, 1_000_000)
        a = a[a != hot]
        if name.endswith("shared"):
            a = np.append(a, hot)
        b = np.concatenate([draw(rng, 800, hot), hot + 1 + draw(rng, 800, hot),
                            np.full(5_000, hot)])
        na, nb = a.shape[0] + 7, b.shape[0] + 7
        return MergeCase(table(a, na, w), values(rng, a.shape[0], na),
                         table(b, nb, w), values(rng, b.shape[0], nb), FLOOR,
                         na + nb)
    if name == "shared at every edge":
        # merged: B 1, A 2, B 2, A 4, B 4, ...: the pair of key 2k sits at
        # positions 2k - 1 and 2k, so one straddles every even edge
        n = 3 * TILE // 2 + 5
        a = 2 * np.arange(1, n + 1)
        b = np.concatenate([[1], a[:-1]])
        return MergeCase(table(a, n, w), values(rng, n, n), table(b, n, w),
                         values(rng, n, n), FLOOR, 2 * n)
    if name == "coverage runs":
        n_a = 3 * TILE
        keys, val = coverage(rng, 2 * TILE, 20_000, 10_000, 700, VHI + 1, w)
        return MergeCase(table(draw(rng, n_a, 20_000), n_a + 100, w),
                         values(rng, n_a, n_a + 100), keys, val, FLOOR,
                         n_a + 100)
    if name == "dups in A":
        a = rng.integers(0, 3_000, 3 * TILE)
        b = draw(rng, TILE, 3_000)
        return MergeCase(table(a, a.shape[0], w), values(rng, a.shape[0],
                                                         a.shape[0]),
                         table(b, TILE + 9, w), values(rng, TILE, TILE + 9),
                         FLOOR, 3_000)
    if name == "all under the floor":
        la, lb = TILE + 300, TILE - 300
        return MergeCase(table(draw(rng, la, 10_000), la, w),
                         values(rng, la, la, 0, FLOOR),
                         table(draw(rng, lb, 10_000), lb + 5, w),
                         values(rng, lb, lb + 5, 0, FLOOR), FLOOR, la)
    if name == "capacity under the count":
        la, lb = 3 * TILE, 2 * TILE
        return MergeCase(table(draw(rng, la, 1 << 20), la, w),
                         values(rng, la, la, FLOOR, VHI),
                         table(draw(rng, lb, 1 << 20), lb, w),
                         values(rng, lb, lb, FLOOR, VHI), FLOOR, TILE + 7)
    raise ValueError(f"unknown merge case {name!r}")
