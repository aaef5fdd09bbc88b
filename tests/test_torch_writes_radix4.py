"""K16 (kernel D's row-keeping mode) and K19 (kernel M) on the inputs
their designs find hard, held against the JAX package on the CPU.

On the card `merge_writes` is one launch of `mm_merge_writes` (kernels/
csrc/merge_maps.cu), `build4` kernel B's launch at radix 4 and
`min_cover4` kernel C's (`rm4_build`, `mc_cover4`), `query4` one launch
of kernels/csrc/rangemax4.cu; each is held bit for bit to its plain
version there (tests/test_torch_cuda.py, chip_smoke.py phase 2). Here,
on every CPU-sized case of `testing/writes_cases` at W = 3 and 5 (max and
min for M):

* the port's `merge_writes` (its plain version on CPU tensors) against
  JAX `merge_writes`, row for row, with `oldest` and `overflow`;
* a numpy model of the card's merge-coordinate rule against JAX
  `merge_writes`: the case cut into tiles of 1,024 and 2,048 merged
  positions, each found by its merge-path split (i0, j0) alone, each
  thread's 4 or 8 positions from its own split in the tile, the value
  before a thread's first position from the tier row before it (the
  halo) and the parity of the bounds before it, never from another
  tile; and the same model with the tie rule flipped, or the parity,
  disagreeing with JAX, so the comparison can see those two faults;
* the port's `build4` / `query4` and `min_cover4` against the JAX
  functions (and the cover against the radix-2 `min_cover`), and numpy
  transcriptions of the card designs (B's tile levels at radix 4, one
  exchange a level, and its sixteen-read levels above the tile; C's
  fill, four-position scatter, two-level passes and per-tile sweep over
  its left halo, a row outside the halo poisoned) against the plain
  versions.

Every output is an integer or a bool: the tolerance is equality. The
`large ...` K16 cases (past 700,000 real rows, where the card takes its
2,048-position tiles) and M's widths past the CPU sizes are the card's;
here only their shapes are checked.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import history as JH
from foundationdb_tpu.ops import rangemax as JR
from foundationdb_tpu.ops import segtree as JS
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.ops import rangemax as R
from foundationdb_tpu_torch.ops import segtree as S
from foundationdb_tpu_torch.testing import writes_cases as WC
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

NEG = H.VERSION_NEG
POS = WC.INT32_POS
#: (tile, positions a thread) of the card's two tile shapes
TILES = ((WC.SMALL_TILE, 4), (WC.TILE, 8))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# K16: merge_writes

@functools.lru_cache(maxsize=None)
def jax_writes(name: str, w: int) -> tuple:
    """JAX merge_writes on a case: (keys [m, w] int32, versions, oldest,
    overflow) as numpy."""
    c = WC.case(name, w)
    js = JH.VersionHistory(jnp.asarray(c.main_keys.view(np.uint32)),
                           jnp.asarray(c.main_ver), jnp.int32(c.oldest),
                           jnp.asarray(c.overflow))
    out = jax.jit(JH.merge_writes)(js, jnp.asarray(c.runs.view(np.uint32)),
                                   jnp.int32(c.version), jnp.int32(c.floor))
    return (np.asarray(out.main_keys).view(np.int32),
            np.asarray(out.main_ver), int(out.oldest), bool(out.overflow))


def port_writes(c: WC.WriteCase) -> H.VersionHistory:
    state = H.VersionHistory(t(c.main_keys), t(c.main_ver), c.oldest,
                             torch.tensor(c.overflow))
    return H.merge_writes(state, t(c.runs), c.version, c.floor)


@pytest.mark.parametrize("w", [3, 5])
@pytest.mark.parametrize("name", WC.CPU_NAMES)
def test_merge_writes_matches_jax(name, w):
    c = WC.case(name, w)
    got = port_writes(c)
    keys, ver, oldest, overflow = jax_writes(name, w)
    assert np.array_equal(got.main_keys.numpy(), keys)
    assert np.array_equal(got.main_ver.numpy(), ver)
    assert got.oldest == oldest
    assert bool(got.overflow) == overflow
    if name in ("capacity under the count", "overflow latched"):
        assert overflow
    elif name != "every bound on a tier key":
        assert not overflow
    if name == "all under the floor":
        assert (ver == NEG).all()
    if name == "begin on a tier key at every edge":
        # both rows of a begin on a tier key are kept: keys repeat
        live = keys[keys[:, -1] != -1]
        assert len({tuple(r) for r in live}) < live.shape[0]


def model_writes(c: WC.WriteCase, tile: int, items: int,
                 flip_tie: bool = False, flip_parity: bool = False):
    """The card's rule in merge coordinates, walked as its tiles and
    threads walk it: (keys, versions, overflow)."""
    a = [tuple(r) for r in c.main_keys.view(np.uint32).tolist()]
    b = [tuple(r) for r in c.runs.view(np.uint32).tolist()]
    av = c.main_ver.tolist()
    na, nb = len(a), len(b)
    ra, rb = WC.real_rows(c.main_keys), WC.real_rows(c.runs)
    real = ra + rb

    def b_first(bk, ak):   # the tie rule: A first at equal keys
        return bk <= ak if flip_tie else bk < ak

    def split(d):
        """How many of the first d merged rows are A rows: the first i
        with B[d - 1 - i] first."""
        lo, hi = max(0, d - nb), min(d, na)
        while lo < hi:
            mid = (lo + hi) // 2
            if b_first(b[d - 1 - mid], a[mid]):
                hi = mid
            else:
                lo = mid + 1
        return lo

    def value(i, j):
        v = av[i - 1] if i > 0 else NEG
        if (j & 1) != flip_parity:
            v = max(v, c.version)
        return NEG if v < c.floor else v

    kept = []
    for d0 in range(0, real, tile):
        d1 = min(d0 + tile, real)
        i0 = split(d0)
        i1 = ra if d1 == real else split(d1)
        j0, j1 = d0 - i0, d1 - i1
        la, lb = i1 - i0, j1 - j0
        for k0 in range(0, d1 - d0, items):
            # the thread's split among the tile's staged rows
            lo, hi = max(0, k0 - lb), min(k0, la)
            while lo < hi:
                mid = (lo + hi) // 2
                if b_first(b[j0 + k0 - 1 - mid], a[i0 + mid]):
                    hi = mid
                else:
                    lo = mid + 1
            ia, jb = lo, k0 - lo
            before = value(i0 + ia, j0 + jb)
            for _ in range(min(items, d1 - d0 - k0)):
                take_a = ia < la and (jb >= lb or not b_first(
                    b[j0 + jb], a[i0 + ia]))
                key = a[i0 + ia] if take_a else b[j0 + jb]
                ia, jb = ia + take_a, jb + (not take_a)
                v = value(i0 + ia, j0 + jb)
                if key[-1] != WC.SENT and v != before:
                    kept.append((key, v))
                before = v
    m, w = c.main_keys.shape
    keys = np.full((m, w), WC.SENT, np.uint32)
    ver = np.full((m,), NEG, np.int32)
    for r, (key, v) in enumerate(kept[:m]):
        keys[r], ver[r] = key, v
    return keys.view(np.int32), ver, c.overflow or len(kept) > m


@pytest.mark.parametrize("tile,items", TILES)
@pytest.mark.parametrize("w", [3, 5])
@pytest.mark.parametrize("name", WC.CPU_NAMES)
def test_merge_coordinate_model_matches_jax(name, w, tile, items):
    keys, ver, overflow = model_writes(WC.case(name, w), tile, items)
    want = jax_writes(name, w)
    assert np.array_equal(keys, want[0])
    assert np.array_equal(ver, want[1])
    assert overflow == want[3]


@pytest.mark.parametrize("fault", ["tie", "parity"])
def test_merge_coordinate_model_sees_a_flipped_rule(fault):
    """The model with the tie rule (B first at equal keys) or the parity
    flipped disagrees with JAX: the comparison above can see both."""
    for name in ("begin on a tier key at every edge", "live 2049"):
        got = model_writes(WC.case(name), WC.SMALL_TILE, 4,
                           flip_tie=fault == "tie",
                           flip_parity=fault == "parity")
        want = jax_writes(name, 3)
        assert not (np.array_equal(got[0], want[0])
                    and np.array_equal(got[1], want[1])), name


@pytest.mark.parametrize("name", [n for n in WC.NAMES
                                  if n.startswith("large")])
def test_large_cases_pass_the_large_tile_threshold(name):
    for w in (3, 5):
        c = WC.case(name, w)
        assert c.main_keys.shape[1] == c.runs.shape[1] == w
        assert (WC.real_rows(c.main_keys) + WC.real_rows(c.runs)
                > WC.LARGE_R)
        bounds = WC.real_rows(c.runs)
        assert bounds % 2 == 0 and bounds > 0


# ---------------------------------------------------------------------------
# K19: build4, query4, min_cover4

@pytest.mark.parametrize("m", WC.CPU_BUILD_ROWS)
def test_build4_query4_match_jax(m):
    vals, lo, hi = WC.build_case(m)
    for op in ("max", "min"):
        want_t = JR.build4(jnp.asarray(vals), op=op)
        got_t = R.build4(t(vals), op=op)
        assert np.array_equal(got_t.numpy(), np.asarray(want_t)), op
        want = JR.query4(want_t, jnp.asarray(lo), jnp.asarray(hi), op=op)
        got = R.query4(got_t, t(lo), t(hi), op=op)
        assert np.array_equal(got.numpy(), np.asarray(want)), op


@pytest.mark.parametrize("leaves", WC.CPU_COVER_LEAVES)
def test_min_cover4_matches_jax(leaves):
    lo, hi, val = WC.cover_case(leaves)
    want = JS.min_cover4(leaves, jnp.asarray(lo), jnp.asarray(hi),
                         jnp.asarray(val))
    got = S.min_cover4(leaves, t(lo), t(hi), t(val))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, S.min_cover(leaves, t(lo), t(hi), t(val)))


def model_build4(vals: np.ndarray, op: str) -> np.ndarray:
    """Kernel B at radix 4: each 2,048-row tile and its 4,096-row halo
    (the identity past m) through the radix-4 levels 0 .. min(L4 - 1, 6),
    level k + 1 at j the op of level k at j + c 4^k, c < 4, where those
    rows lie in the span (a row past it keeps a partial window: no level
    of a tile row reads it); then two levels a grid sync, level k from
    level k - 1 at i + e 4^(k-1), e < 4, and level k + 1 at e < 16."""
    fn = np.minimum if op == "min" else np.maximum
    ident = POS if op == "min" else -POS
    m = vals.shape[0]
    levels = R._num_levels4(m)
    tile, in_tile = 2048, min(levels - 1, 6)
    span = tile + 4096
    table = np.full((levels, m), 12345, np.int64)
    for a in range(0, m, tile):
        v = np.full(span, ident, np.int64)
        part = vals[a:a + span]
        v[:part.shape[0]] = part
        for k in range(in_tile + 1):
            n = min(tile, m - a)
            table[k, a:a + n] = v[:n]
            if k < in_tile:
                s = 1 << (2 * k)
                w = v.copy()
                for c in (1, 2, 3):
                    w[:span - c * s] = fn(w[:span - c * s], v[c * s:])
                v = w
    for k in range(in_tile + 1, levels, 2):
        h = 1 << (2 * (k - 1))
        prev = np.concatenate([table[k - 1], np.full(15 * h, ident)])
        x = [prev[e * h:e * h + m] for e in range(16)]
        y = fn(fn(x[0], x[1]), fn(x[2], x[3]))
        table[k] = y
        if k + 1 < levels:
            table[k + 1] = functools.reduce(fn, x[4:], y)
    return table.astype(np.int32)


def model_cover4(leaves: int, lo, hi, val) -> np.ndarray:
    """Kernel C at radix 4: fill, the four-position scatter, the levels
    above the tile's top (5) two a pass (one when one is left), then each
    2,048-leaf tile down the levels in shared memory over its left halo,
    one level a step; rows a tile stages nothing for hold a poison value
    that no real value equals, so a read outside the halo shows."""
    tile, span, top_in = 2048, 4096, 5
    log = leaves.bit_length() - 1
    nlev = (log + 1) // 2 + 1
    t4 = np.full((nlev, leaves), POS, np.int64)
    lo = np.clip(lo.astype(np.int64), 0, leaves)
    hi = np.clip(hi.astype(np.int64), 0, leaves)
    live = hi > lo
    ln = np.where(live, hi - lo, 1)
    k = np.minimum(np.floor(np.log2(ln)).astype(np.int64) >> 1, nlev - 1)
    s = np.left_shift(1, 2 * k)
    for c in range(4):
        pos = np.minimum(lo + c * s, hi - s)
        np.minimum.at(t4, (k[live], pos[live]), val[live])

    def shifted(row, sh):   # row[i - sh], +inf left of leaf 0
        if sh >= leaves:
            return np.full(leaves, POS)
        return np.concatenate([np.full(sh, POS), row[:leaves - sh]])

    top = nlev - 1
    while top > top_in:
        two = top - 2 >= top_in
        s1 = 1 << (2 * (top - 1))
        whole1 = functools.reduce(np.minimum, [t4[top - 1]] + [
            shifted(t4[top], e * s1) for e in range(4)])
        if two:
            s2 = s1 >> 2
            t4[top - 2] = functools.reduce(np.minimum, [t4[top - 2]] + [
                shifted(whole1, c * s2) for c in range(4)])
            top -= 2
        else:
            t4[top - 1] = whole1
            top -= 1

    def halo(lv):
        return 0 if lv == 0 else 1 << (2 * lv)

    poison = -7
    out = np.empty(leaves, np.int64)
    for base in range(-tile, leaves - tile, tile):
        rows = {}
        for lv in range(top + 1):
            r = np.full(span, poison, np.int64)
            p = np.arange(tile - halo(lv), span)
            x = base + p
            inside = (x >= 0) & (x < leaves)
            r[p] = np.where(inside, t4[lv, np.clip(x, 0, leaves - 1)], POS)
            rows[lv] = r
        cur = rows[top]
        for j in range(top, 0, -1):
            s = 1 << (2 * (j - 1))
            nxt = np.full(span, poison, np.int64)
            p = np.arange(tile - halo(j - 1), span)
            x = base + p
            v = functools.reduce(np.minimum, [rows[j - 1][p]] + [
                cur[p - c * s] for c in range(4)])
            nxt[p] = np.where((x >= 0) & (x < leaves), v, POS)
            cur = nxt
        n = min(tile, leaves - base - tile)
        out[base + tile:base + tile + n] = cur[tile:tile + n]
    return out.astype(np.int32)


@pytest.mark.parametrize("m", WC.CPU_BUILD_ROWS)
def test_build4_design_matches_plain(m):
    vals = WC.build_case(m)[0]
    for op in ("max", "min"):
        assert np.array_equal(model_build4(vals, op),
                              R.build4_plain(t(vals), op=op).numpy()), op


@pytest.mark.parametrize("leaves", WC.CPU_COVER_LEAVES)
def test_cover4_design_matches_plain(leaves):
    lo, hi, val = WC.cover_case(leaves)
    got = model_cover4(leaves, lo, hi, val)
    assert np.array_equal(got, S.min_cover4_plain(leaves, t(lo), t(hi),
                                                  t(val)).numpy())
