"""Kernels A's probe (K4) and H's fold (K14) on the inputs their designs
find hard, held against the JAX package on the CPU.

Every case of `foundationdb_tpu_torch/testing/probe_cases.py` runs through
the JAX function and the port's CPU path (the plain versions the card's
kernels are held to in tests/test_torch_cuda.py and chip_smoke.py):

* the probe: `JH.query_reads_vmax` under `jax.jit` against
  `H.query_reads_vmax` on CPU tensors, at W = 3 and 5. Each case holds a
  read past the JAX program's 4-boundary window, so its probe takes its
  full-search branch, the formula the plain version writes; its window
  branch answers an inverted or empty read from the segment of its
  begin, so it is held separately to the cases' forward reads that stay
  inside the window, where its two branches agree;
* the fold: the JAX fold (the scatter / cumsum / where of
  foundationdb_tpu/ops/group.py:588-597, as tests/test_torch_group.py
  writes it out) against `G.seg_fold` on CPU tensors, in place.

Beside them, numpy transcriptions of the card designs' control flow (the
probe's fence, bucket, window and fall-back steps on order ranks of the
rows; the fold's choice between the direct paint and the count) are held
to the plain versions on every case, with each case shown to reach the
part of the design it is named for. Every output is an integer, so the
tolerance is equality throughout.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import history as JH
from foundationdb_tpu_torch import interop
from foundationdb_tpu_torch.ops import group as G
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.ops import rangemax as R
from foundationdb_tpu_torch.testing import probe_cases as PC
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

WIDTHS = (3, 5)
_JAX_PROBE = jax.jit(JH.query_reads_vmax)


@functools.lru_cache(maxsize=None)
def probe_case(name: str, w: int) -> PC.ProbeCase:
    return PC.probe_case(name, w)


@functools.lru_cache(maxsize=None)
def fold_case(name: str) -> PC.FoldCase:
    return PC.fold_case(name)


def t(a: np.ndarray) -> torch.Tensor:
    return interop.to_torch(np.asarray(a), "cpu")


def jax_probe(keys, ver, rb, re) -> np.ndarray:
    state = JH.VersionHistory(jnp.asarray(keys.view(np.uint32)),
                              jnp.asarray(ver), jnp.int32(PC.NEG),
                              jnp.asarray(False))
    return np.asarray(_JAX_PROBE(state, jnp.asarray(rb.view(np.uint32)),
                                 jnp.asarray(re.view(np.uint32))))


def port_probe(keys, ver, rb, re) -> np.ndarray:
    hist = interop.history_from_numpy(keys.view(np.uint32), ver, PC.NEG,
                                      False, "cpu")
    return H.query_reads_vmax(hist, t(rb), t(re)).numpy()


def ranks(c: PC.ProbeCase):
    """Order ranks of the tier's rows and the reads' ends (rows compared
    as uint32 words, left to right: FDB's key order)."""
    rows = np.concatenate([c.keys, c.rb, c.re]).view(np.uint32)
    _, inv = np.unique(rows, axis=0, return_inverse=True)
    inv = inv.reshape(-1).astype(np.int64)
    m, q = c.keys.shape[0], c.rb.shape[0]
    return inv[:m], inv[m:m + q], inv[m + q:]


def probe_model(c: PC.ProbeCase) -> tuple:
    """The card probe's steps (keysearch.cu probe_kernel) on order ranks:
    the fence and its bucket for il; for ir the window and the rest of
    il's bucket where no fence row lies between, else the fence and re's
    own bucket: (vmax [Q], the stats of which step answered each read)."""
    k, b, e = ranks(c)
    m, w = c.keys.shape
    s = PC.fence_shift(m, w)
    fence = k[:: 1 << s]
    nf = fence.shape[0]

    def fence_count(q, right):
        c, z = np.zeros_like(q), np.full_like(q, nf)
        for _ in range(nf.bit_length()):
            on = c < z
            mid = (c + z) >> 1
            row = fence[np.clip(mid, 0, nf - 1)]
            past = row <= q if right else row < q
            c = np.where(on & past, mid + 1, c)
            z = np.where(on & ~past, mid, z)
        return c

    def bucket_of(c):
        return (np.where(c == 0, 0, ((c - 1) << s) + 1),
                np.where(c == 0, 0, np.minimum(c << s, m)))

    def bucket(q, right, lo, hi):
        assert (hi - lo < (1 << s)).all()
        for _ in range(s):
            on = lo < hi
            mid = (lo + hi) >> 1
            row = k[np.clip(mid, 0, m - 1)]
            past = row <= q if right else row < q
            lo = np.where(on & past, mid + 1, lo)
            hi = np.where(on & ~past, mid, hi)
        return lo

    passed = fence_count(b, True)
    first = bucket(b, True, *bucket_of(passed))
    il = first - 1
    fwd = b < e
    # near: no fence row past il's below re, so the answer is in
    # [il + 1, min(c << s, m)]: the window, then that bucket's rest
    near = fwd & ((passed == nf) | (fence[np.clip(passed, 0, nf - 1)] >= e))
    cnt = np.zeros_like(b)
    for d in range(PC.WINDOW):
        at = first + d
        cnt += (at < m) & (k[np.clip(at, 0, m - 1)] < e)
    lo = np.where(near, first + cnt, 0)
    hi = np.where(near & (cnt == PC.WINDOW), np.minimum(passed << s, m), lo)
    flo, fhi = bucket_of(fence_count(e, False))
    lo = np.where(near, lo, np.minimum(np.maximum(flo, np.where(
        fwd, first, 0)), fhi))
    hi = np.where(near, hi, fhi)
    end = bucket(e, False, lo, hi)
    far = ~near
    vmax = R.query_plain(R.build_plain(t(c.ver), op="max"),
                         t(np.maximum(il, 0).astype(np.int32)),
                         t(end.astype(np.int32)), op="max").numpy()
    sent = int(np.unique(np.concatenate([c.keys, c.rb, c.re]).view(
        np.uint32), axis=0).shape[0]) - 1   # the all-ones row sorts last
    has_sent = (c.keys.view(np.uint32) == PC.SENT).all(axis=1).any() or \
        (c.rb.view(np.uint32) == PC.SENT).all(axis=1).any()
    stats = dict(
        window=int((near & (cnt < PC.WINDOW)).sum()),
        past_window=int((fwd & ~(near & (cnt < PC.WINDOW))).sum()),
        full=int((~fwd).sum()), at_fence=int(np.isin(b, fence).sum()
                                             + np.isin(e, fence).sum()),
        inverted_in_segment=int(((e < b) & (end - 1 == il)).sum()),
        inverted_across=int(((e < b) & (end - 1 < il)).sum()),
        empty=int((e == b).sum()), before_row_0=int((b < k[0]).sum()),
        at_sentinel=int((b == sent).sum()) if has_sent else 0,
        dead=int(((b == sent) & (e == sent)).sum()) if has_sent else 0,
        live_rows=int((k != sent).sum()) if has_sent else m,
        duplicate_rows=int(((np.diff(k) == 0) & (k[1:] != sent)).sum()),
        shift=s)
    return vmax, stats


#: what each probe case must reach, from probe_model's stats
REACHES = {
    "point reads": lambda st: st["window"] > 1_000,
    "fence rows": lambda st: st["at_fence"] > 1_000,
    "past the window": lambda st: st["past_window"] > 800,
    "inverted in a segment": lambda st: st["inverted_in_segment"] > 100,
    "inverted across segments": lambda st: st["inverted_across"] > 200,
    "tier ends": lambda st: st["before_row_0"] > 100
    and st["at_sentinel"] > 100,
    "dead rows": lambda st: st["dead"] >= PC.READS // 3,
    "empty reads": lambda st: st["empty"] >= 400,
    "full tier": lambda st: st["live_rows"] == PC.TIER,
    "duplicate keys": lambda st: st["duplicate_rows"] > 1_000,
    "small tier": lambda st: st["shift"] == 0,
}


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("name", PC.PROBE_NAMES)
def test_probe_case_matches_jax(name, w):
    c = probe_case(name, w)
    want = jax_probe(*c)
    got = port_probe(*c)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("name", PC.PROBE_NAMES)
def test_probe_window_branch_matches_jax_on_forward_reads(name, w):
    """The case's forward reads that end within the JAX window of their
    begin, alone in one call: JAX's window branch, equal to the port."""
    c = probe_case(name, w)
    k, b, e = ranks(c)
    il = np.searchsorted(k, b, side="right") - 1
    ir = np.searchsorted(k, e, side="left") - 1
    keep = np.flatnonzero((b < e) & (ir - il < PC.WINDOW))
    assert keep.shape[0] > 0
    keep = np.resize(keep, c.rb.shape[0])    # the case's shape, so one
    rb, re = c.rb[keep], c.re[keep]          # compile serves every case
    assert np.array_equal(port_probe(c.keys, c.ver, rb, re),
                          jax_probe(c.keys, c.ver, rb, re))


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("name", PC.PROBE_NAMES)
def test_probe_design_matches_plain(name, w):
    """The card probe's steps on every read of the case equal the plain
    version, and the case reaches the part it is named for."""
    c = probe_case(name, w)
    got, stats = probe_model(c)
    assert np.array_equal(got, port_probe(*c))
    assert REACHES[name](stats), stats


def jax_fold(seg_ver, rwb, rwe, cw, ver):
    """The JAX program's fold, foundationdb_tpu/ops/group.py:588-597."""
    r_rows = seg_ver.shape[0]
    dd = (
        jnp.zeros((r_rows + 1,), jnp.int32)
        .at[jnp.where(cw, rwb, r_rows)].add(1)
        .at[jnp.where(cw, rwe, r_rows)].add(-1)[:r_rows]
    )
    covered = jnp.cumsum(dd) > 0
    return jnp.where(covered, ver, seg_ver)


def port_fold(c: PC.FoldCase) -> np.ndarray:
    painted = t(c.seg_ver).clone()
    got = G.seg_fold(painted, t(c.wb), t(c.we), t(c.cw), c.version)
    assert got is painted                        # in place
    return got.numpy()


@pytest.mark.parametrize("name", PC.FOLD_JAX)
def test_fold_case_matches_jax(name):
    c = fold_case(name)
    want = np.asarray(jax_fold(*(jnp.asarray(a) for a in c[:4]), c.version))
    assert np.array_equal(port_fold(c), want)


@pytest.mark.parametrize("name", PC.FOLD_NAMES)
def test_fold_design_matches_plain(name):
    """sf_fold's choice on the case is the one FOLD_PATH names, and what
    that part computes (each committed write painted directly, or the
    difference array counted with ranks clamped to [0, n]) equals the
    plain version."""
    c = fold_case(name)
    path = PC.fold_path(c)
    assert path == PC.FOLD_PATH[name]
    n = c.seg_ver.shape[0]
    b = np.clip(c.wb.astype(np.int64), 0, n)
    e = np.clip(c.we.astype(np.int64), 0, n)
    seg = c.seg_ver.copy()
    if path == "paint":
        for lo, hi in zip(b[c.cw], e[c.cw]):
            seg[lo:hi] = c.version
    else:
        dd = np.zeros(n + 1, np.int64)
        np.add.at(dd, b[c.cw], 1)
        np.add.at(dd, e[c.cw], -1)
        seg[np.cumsum(dd[:n]) > 0] = c.version
    assert np.array_equal(seg, port_fold(c))
