"""Kernel D's row-keeping mode (K16) and kernel M's (K19) hard inputs.

`merge_writes` on the card (`mm_merge_writes`, kernels/csrc/merge_maps.cu)
is `mm_merge`'s merge path in a row-keeping mode: the tier's rows (A) and
the run bounds (B) merged, A first at equal keys, in tiles of SMALL_TILE
positions where one round of the grid holds them, else TILE; each merged
position's value comes from its merge coordinates alone (the A row before
it and the parity of the B rows before it), so the hard inputs are the
tile edges, the tie rule and the parity there, the sentinel tails and the
capacity. Each K16 case is a tier (keys [m, W] int32 bit patterns with a
sentinel tail, versions [m] int32, its floor and overflow flag), run bounds
[nb, W] (sorted, begin / end alternating, sentinel tail), the version and
the new floor, as numpy arrays:

* real rows (tier rows plus bounds before the tails) at 0, 1, TILE - 1,
  TILE and TILE + 1 (`live R`);
* a run begin equal to a tier key at every multiple of SMALL_TILE, the
  two rows on either side of the edge (`begin on a tier key at every
  edge`), every bound equal to a tier key, an empty bound list (sentinel
  rows only, and no rows), an empty tier, one run over every key, every
  value and the version under the floor, a capacity under the count, and
  an overflow already latched;
* `large ...`: the edge case, the capacity case and `chip_smoke.py`'s
  shape (655,360 live tier rows of 786,432 and 131,072 bounds, an eighth
  equal to tier keys) past LARGE_R real rows, where the card takes
  TILE-position tiles at W = 3 and 5; the card alone runs them.

The CPU-sized K16 cases share a few shapes (TIER rows of tier, BOUNDS
rows of bounds), so that the JAX program compiles once a width.

Kernel M: `build4` / `query4` at BUILD_ROWS (about B's 4,096-row tile,
past it, the fixpoint's 2^18 leaves) with queries empty, inverted, past
both ends, of every level's span and the whole width; `min_cover4` at
COVER_LEAVES (odd log2 widths included) with intervals of every level,
full-width ones, ones from lo < 0 and to hi > leaves, and ones across
every 2,048-leaf edge (C's tile). Max and min.

The card lane (tests/test_torch_cuda.py), chip_smoke.py's phase 2 and the
CPU tests (tests/test_torch_writes_radix4.py) draw the same cases.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from foundationdb_tpu_torch.testing.benchgen import int_keys_packed

#: merged positions of kernel D's large and small tiles (kTile, kSmallTile)
TILE = 2048
SMALL_TILE = 1024
#: real rows past which the card's grid (at most 660 co-resident blocks
#: at W = 3, fewer at W = 5) takes TILE-position tiles
LARGE_R = 700_000
#: the rows of a CPU-sized case's tier and bounds
TIER = 3 * TILE
BOUNDS = TILE
#: chip_smoke.py's shape: a tier and a batch's bounds
BIG_TIER = 786_432
BIG_BOUNDS = 131_072
NEG = -(2**31) + 1
SENT = 0xFFFFFFFF
#: the versions the tiers draw, the floor that GCs the lowest fifth, the
#: run version
VLO, VHI, FLOOR, VERSION = 1_000, 6_000, 2_000, 7_000
INT32_POS = 2**31 - 1


class WriteCase(NamedTuple):
    main_keys: np.ndarray   # [m, W] int32, sorted, sentinel tail
    main_ver: np.ndarray    # [m] int32
    oldest: int
    overflow: bool
    runs: np.ndarray        # [nb, W] int32, sorted bounds, sentinel tail
    version: int
    floor: int


#: real rows of the size cases
LIVE = (0, 1, TILE - 1, TILE, TILE + 1)
#: the cases padded past LARGE_R
LARGE = ("begin on a tier key at every edge", "capacity under the count")
#: every K16 case's name; `large ...` ones are for the card only
NAMES = (*(f"live {r}" for r in LIVE), "begin on a tier key at every edge",
         "every bound on a tier key", "no bounds", "no bound rows",
         "empty tier", "one run over every key", "all under the floor",
         "capacity under the count", "overflow latched",
         *(f"large {n}" for n in LARGE), "large")
CPU_NAMES = tuple(n for n in NAMES if not n.startswith("large"))


def table(ints: np.ndarray, rows: int, w: int) -> np.ndarray:
    """[rows, w] int32 keys: the sorted 8-byte keys of `ints`, then
    sentinel rows."""
    out = np.full((rows, w), SENT, np.uint32)
    out[: ints.shape[0]] = int_keys_packed(np.sort(ints), 8, w)
    return out.view(np.int32)


def versions(rng, live: int, rows: int, lo: int = VLO, hi: int = VHI
             ) -> np.ndarray:
    """[rows] int32: random versions over the live rows, a fifth of them
    repeating their predecessor's, every ninth NEG; NEG on the tail."""
    out = np.full((rows,), NEG, np.int32)
    v = rng.integers(lo, hi, live).astype(np.int32)
    v[1::5] = v[0::5][: v[1::5].shape[0]]
    v[::9] = NEG
    out[:live] = v
    return out


def write_case(rng, tier: np.ndarray, bounds: np.ndarray, w: int, *,
               m: int = TIER, nb: int = BOUNDS, lo: int = VLO,
               hi: int = VHI, version: int = VERSION, floor: int = FLOOR,
               overflow: bool = False, ver: np.ndarray = None) -> WriteCase:
    """A case from the tier's and the bounds' integer keys (the bounds
    cut to an even count, sorted, distinct); `ver`, else versions()."""
    bounds = np.unique(bounds)
    bounds = bounds[: bounds.shape[0] // 2 * 2]
    if ver is None:
        ver = versions(rng, tier.shape[0], m, lo, hi)
    return WriteCase(table(tier, m, w), ver, FLOOR // 2, overflow,
                     table(bounds, nb, w), version, floor)


def over_capacity(rng, m: int, nb: int, w: int) -> WriteCase:
    """A full tier of m rows with versions above the floor and nb bounds
    of one-key runs between its keys: every tier row and every bound is
    kept, m + nb rows in all, past the capacity m."""
    space = 4 * (m + nb)
    tier = 4 * rng.choice(space, m, replace=False)
    runs = 4 * rng.choice(space, nb // 2, replace=False)
    ver = rng.integers(FLOOR, VHI, m).astype(np.int32)
    return write_case(rng, tier, np.concatenate([runs + 1, runs + 2]), w,
                      m=m, nb=nb, ver=ver)


def split(rng, real: int, keyspace: int) -> tuple:
    """Distinct tier keys and an even count of bound keys, real rows in
    all (about a quarter bounds), a few of the bounds on tier keys."""
    nb = min(real // 4 // 2 * 2, BOUNDS)
    keys = rng.choice(keyspace, size=real, replace=False)
    tier, bounds = keys[nb:], keys[:nb]
    if nb >= 4 and tier.shape[0]:
        bounds[: nb // 8] = rng.choice(tier, nb // 8, replace=False)
    return tier, bounds


def edge_pattern(n: int) -> tuple:
    """Tier keys 2, 4, .., 2n and bounds 1, 2, 4, .., 2n - 2: merged, the
    rows of key 2k sit at positions 2k - 1 (tier) and 2k (bound k, a
    begin for even k), so a begin on a tier key straddles every even
    edge."""
    tier = 2 * np.arange(1, n + 1)
    return tier, np.concatenate([[1], tier[:-1]])


def case(name: str, w: int = 3) -> WriteCase:
    """The named K16 case (NAMES) at key width w, from a seed of its own."""
    rng = np.random.default_rng([NAMES.index(name), w])
    if name.startswith("live "):
        real = int(name[5:])
        return write_case(rng, *split(rng, real, 4 * real + 8), w)
    if name == "begin on a tier key at every edge":
        tier, bounds = edge_pattern(TILE + 3 * SMALL_TILE // 2)
        return write_case(rng, tier, bounds[:BOUNDS - 2], w)
    if name == "every bound on a tier key":
        tier = rng.choice(1 << 20, TIER - 100, replace=False)
        return write_case(rng, tier, rng.choice(tier, BOUNDS - 2,
                                                replace=False), w)
    if name == "no bounds":
        return write_case(rng, rng.choice(1 << 20, TIER - 5, replace=False),
                          np.zeros(0, np.int64), w)
    if name == "no bound rows":
        return write_case(rng, rng.choice(1 << 20, TIER - 5, replace=False),
                          np.zeros(0, np.int64), w, nb=0)
    if name == "empty tier":
        return write_case(rng, np.zeros(0, np.int64),
                          rng.choice(1 << 20, BOUNDS - 10, replace=False), w)
    if name == "one run over every key":
        tier = 10 + rng.choice(1 << 20, TIER - 7, replace=False)
        return write_case(rng, tier, np.array([3, (1 << 20) + 20]), w)
    if name == "all under the floor":
        tier, bounds = split(rng, TIER, 1 << 20)
        return write_case(rng, tier, bounds, w, lo=0, hi=FLOOR,
                          version=FLOOR - 1)
    if name == "capacity under the count":
        return over_capacity(rng, TIER, BOUNDS, w)
    if name == "overflow latched":
        tier, bounds = split(rng, TILE + 77, 1 << 20)
        return write_case(rng, tier, bounds, w, overflow=True)
    if name == "large begin on a tier key at every edge":
        tier, bounds = edge_pattern(BIG_TIER - 10)
        return write_case(rng, tier, bounds[: BIG_BOUNDS - 2], w,
                          m=BIG_TIER, nb=BIG_BOUNDS)
    if name == "large capacity under the count":
        return over_capacity(rng, LARGE_R - BIG_BOUNDS + 10_000, BIG_BOUNDS,
                             w)
    if name == "large":
        n_live = BIG_TIER - BIG_BOUNDS
        keys = rng.choice(1 << 40, n_live + BIG_BOUNDS, replace=False)
        tier, bounds = keys[:n_live], keys[n_live:]
        bounds[: BIG_BOUNDS // 8] = rng.choice(tier, BIG_BOUNDS // 8,
                                               replace=False)
        return write_case(rng, tier, bounds, w, m=BIG_TIER, nb=BIG_BOUNDS)
    raise ValueError(f"unknown merge_writes case {name!r}")


def real_rows(keys: np.ndarray) -> int:
    """Rows before a sorted key table's sentinel tail."""
    return int((keys.view(np.uint32)[:, -1] != SENT).sum())


# ---------------------------------------------------------------------------
# K19: kernel M

#: build4 / query4 sizes: about B's 4,096-row tile, past 16 tiles, 2^18
BUILD_ROWS = (1, 3, 4095, 4096, 4097, 65_537, 262_144)
#: min_cover4 widths (odd log2: 2^17, 2^19)
COVER_LEAVES = (1, 64, 4096, 1 << 17, 1 << 18, 1 << 19)
#: the sizes the CPU tests run (the JAX functions on the CPU)
CPU_BUILD_ROWS = (1, 3, 4095, 4096, 4097, 65_537)
CPU_COVER_LEAVES = (1, 64, 4096, 1 << 17)
#: C's tile, whose edges the cover's intervals straddle
COVER_TILE = 2048
QUERIES = 8192
INTERVALS = 8192


def build_case(m: int) -> tuple:
    """(values [m] int32, lo [QUERIES], hi [QUERIES]) for build4 / query4:
    random values; queries of -3 .. 64 rows, of every level's span 4^k and
    4^k +- 1, up to and past the whole width, empty and inverted, from
    below 0 and to past m."""
    rng = np.random.default_rng([m, 19])
    vals = rng.integers(-10**9, 10**9, m).astype(np.int32)
    lo = rng.integers(-3, m + 3, QUERIES)
    length = rng.integers(-3, 65, QUERIES)
    spans = [1 << (2 * k) for k in range(10) if 1 << (2 * k) <= m + 1]
    sel = np.concatenate([[s - 1, s, s + 1] for s in spans])
    n = sel.shape[0]
    length[:n] = sel
    lo[:n] = rng.integers(0, max(m - sel.max(), 1), n)
    wide = slice(n, n + QUERIES // 8)
    lo[wide] = rng.integers(-3, max(m // 2, 1), QUERIES // 8)
    length[wide] = rng.integers(0, m + 5, QUERIES // 8)
    ends = np.array([[0, m], [-5, m + 3], [0, 0], [m, m - 1], [1, m],
                     [m - 1, m], [-4, 1]])
    lo[-7:], length[-7:] = ends[:, 0], ends[:, 1] - ends[:, 0]
    hi = lo + length
    return vals, lo.astype(np.int32), hi.astype(np.int32)


def cover_case(leaves: int) -> tuple:
    """(lo, hi, val [INTERVALS] int32) for min_cover4: intervals of every
    level's span (4^k and 4^(k+1) - 1), ones across every COVER_TILE edge,
    full-width ones (one from lo < 0 to hi > leaves), the rest short or as
    wide as the leaves, empty and inverted ones, lo from -4; a fifth of
    the values INT32_POS."""
    rng = np.random.default_rng([leaves, 4])
    n = INTERVALS
    lo = rng.integers(-4, leaves + 4, n)
    length = np.concatenate([rng.integers(-2, 300, n // 2),
                             rng.integers(-2, leaves + 8, n - n // 2)])
    spans = []
    for k in range(11):
        for s in ((1 << (2 * k)), (1 << (2 * k + 2)) - 1):
            if s <= leaves:
                spans.append(s)
    spans = np.array(spans)
    j = spans.shape[0]
    length[:j] = spans
    lo[:j] = rng.integers(0, leaves - spans + 1)
    edges = np.arange(COVER_TILE, max(leaves, COVER_TILE), COVER_TILE)
    e = edges.shape[0]
    lo[j:j + e] = edges - 3
    length[j:j + e] = 7
    lo[j + e:j + 2 * e] = edges - rng.integers(1, COVER_TILE, e)
    length[j + e:j + 2 * e] = rng.integers(COVER_TILE, 4 * COVER_TILE, e)
    lo[-3:] = [0, -5, -3]
    length[-3:] = [leaves, leaves + 10, 4]
    val = rng.integers(0, n, n)
    val[::5] = INT32_POS
    return (lo.astype(np.int32), (lo + length).astype(np.int32),
            val.astype(np.int32))
