"""Kernel N's plain version (the stable lexicographic sort of packed-key
rows) and the paths built on it, held against numpy and the JAX package
on the CPU with keys over the bytes {0x00, 0x01, 0x7F, 0x80, 0xFF} at
every length from 0 to max_key_bytes: the bytes where a digit taken from
an int32 bit pattern as signed, or a word compared as signed, would put
0x80 before 0x7F.

Inputs are numpy (seeded generators), fed to both sides; every output is
an integer or a bool, so the tolerance is equality throughout:

* `lex_sort_perm_plain` against numpy's stable `lexsort` on unsigned
  words, at row widths Wr = 1, 3, 6 and 16 and P = 1, 513, 1000 and
  4,097 (no multiple of any tile), with sentinel rows, rows all ones but
  the last word, and all-sentinel inputs; and that it is stable;
* `sort_ranks` against JAX `sort_ranks` (foundationdb_tpu/ops/keys.py:84)
  on the same kinds of rows, with an invalid mask;
* `_main_stale` with read dedup against JAX `_main_stale`
  (foundationdb_tpu/ops/delta.py:120), U above, at and below the count
  of distinct live (begin, end) rows, n_uniq against numpy's count;
* a tiered and a classic group of 4 through `resolve_group_args` (the
  coverage sort of every batch's committed writes, `ops/group._coverage`,
  and the group ranks), every field and the history against JAX's
  `TpuConflictSet`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.config import KernelConfig as JaxConfig
from foundationdb_tpu.models import conflict_set as JCS
from foundationdb_tpu.ops import delta as JD
from foundationdb_tpu.ops import history as JH
from foundationdb_tpu.ops import keys as JK
from foundationdb_tpu.ops import rangemax as JR
from foundationdb_tpu_torch import interop, make_conflict_set
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.ops import delta as D
from foundationdb_tpu_torch.ops import keys as K
from foundationdb_tpu_torch.ops import rangemax as R
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import packing

from test_torch_group import assert_same_out, canonical_map

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

#: the bytes either side of the signed boundaries of a byte and a word
WIDE = np.array([0x00, 0x01, 0x7F, 0x80, 0xFF], np.uint8)
SENT = 0xFFFFFFFF
NEG = JH.VERSION_NEG


def t(a) -> torch.Tensor:
    return interop.to_torch(np.asarray(a), "cpu")


def u32(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def wide_key(rng, max_len: int) -> bytes:
    """A key of 0..max_len bytes drawn from WIDE."""
    return bytes(WIDE[rng.integers(0, len(WIDE), int(rng.integers(
        0, max_len + 1)))])


def wide_range(rng, max_len: int):
    while True:
        a, b = wide_key(rng, max_len), wide_key(rng, max_len)
        if a != b:
            return min(a, b), max(a, b)


def wide_rows(rng, p: int, wr: int) -> np.ndarray:
    """[p, wr] uint32 rows. Wr = 1: words of four WIDE bytes. Otherwise
    packed keys of max_key_bytes = 4 (Wr - 1) (Wr = 3), or a begin and an
    end key of Wr / 2 words each (Wr = 6, 16), as the read-dedup rows are.
    About a third of the rows repeat another."""
    if wr == 1:
        rows = WIDE[rng.integers(0, len(WIDE), (p, 4))].view(">u4").astype(
            np.uint32)
    else:
        halves = 1 if wr == 3 else 2
        w = wr // halves
        mkb = 4 * (w - 1)
        rows = np.concatenate([
            np.stack([packing.pack_key(wide_key(rng, mkb), mkb)
                      for _ in range(p)]) for _ in range(halves)], axis=1)
    dup = rng.integers(0, p, p // 3)
    rows[dup] = rows[rng.integers(0, p, len(dup))]
    return np.ascontiguousarray(rows, np.uint32)


def shaped(rng, rows: np.ndarray, case: str) -> np.ndarray:
    rows = rows.copy()
    p, wr = rows.shape
    if case in ("sentinel", "ones but the last word"):
        rows[rng.random(p) < 0.25] = SENT
    if case == "ones but the last word":
        m = rng.random(p) < 0.3
        rows[m, :wr - 1] = SENT
        rows[m, wr - 1] = WIDE[rng.integers(0, len(WIDE), int(m.sum()))]
    if case == "all sentinel":
        rows[:] = SENT
    return rows


CASES = ("keys", "sentinel", "ones but the last word", "all sentinel")


# ---------------------------------------------------------------------------
# kernel N's plain version

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("p", [1, 513, 1000, 4097])
@pytest.mark.parametrize("wr", [1, 3, 6, 16])
def test_lex_sort_perm_plain_matches_numpy(wr, p, case):
    rng = np.random.default_rng(wr * 10_000 + p)
    rows = shaped(rng, wide_rows(rng, p, wr), case)
    perm, srt = K.lex_sort_perm_plain(t(rows))
    want = np.lexsort(rows.T[::-1])          # column 0 most significant
    assert perm.dtype == torch.int32
    assert np.array_equal(perm.numpy(), want)
    assert np.array_equal(u32(srt), rows[want])


@pytest.mark.parametrize("wr", [1, 3, 16])
def test_lex_sort_perm_plain_is_stable(wr):
    """Few distinct rows, each many times: equal rows keep their input
    order, and the order is the unsigned one (0x80... after 0x7F...)."""
    rng = np.random.default_rng(wr)
    pool = wide_rows(rng, 9, wr)
    rows = pool[rng.integers(0, len(pool), 3000)]
    perm, srt = K.lex_sort_perm_plain(t(rows))
    perm = perm.numpy()
    want = sorted(range(len(rows)), key=lambda i: (tuple(rows[i]), i))
    assert perm.tolist() == want
    s = u32(srt)
    same = np.all(s[1:] == s[:-1], axis=1)
    assert np.all(perm[1:][same] > perm[:-1][same])


def test_lex_sort_perm_dispatches_on_the_device():
    """CPU tensors take the plain version, whatever their width; the
    wrapper refuses what is not [P, Wr]."""
    rows = wide_rows(np.random.default_rng(5), 64, 16)
    got = K.lex_sort_perm(t(rows))
    want = K.lex_sort_perm_plain(t(rows))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        K.lex_sort_perm(t(rows[:, 0]))


# ---------------------------------------------------------------------------
# K17: sort_ranks

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("p,wr", [(1, 3), (1000, 3), (4097, 3), (513, 6),
                                  (700, 16)])
def test_sort_ranks_matches_jax(p, wr, case):
    rng = np.random.default_rng(p + wr)
    pts = shaped(rng, wide_rows(rng, p, wr), case)
    valid = rng.random(p) < 0.85
    want = JK.sort_ranks(jnp.asarray(pts), jnp.asarray(valid))
    got = K.sort_ranks(t(pts), t(valid))
    for name, g, w in zip(("ranks", "unique_keys", "unique_count"), got,
                          want):
        assert np.array_equal(u32(g), np.asarray(w)), name


# ---------------------------------------------------------------------------
# K12: _main_stale with read dedup

_JAX_MAIN_STALE = jax.jit(JD._main_stale, static_argnums=(6,))
MKB = 8
W = MKB // 4 + 1


def wide_main_tier(rng, n, cap):
    """[cap, W] sorted distinct wide keys with a sentinel tail, and their
    versions."""
    keys = sorted({wide_key(rng, MKB) for _ in range(n)})
    rows = np.full((cap, W), SENT, np.uint32)
    rows[:len(keys)] = packing.pack_keys(keys, MKB)
    ver = np.full((cap,), NEG, np.int32)
    ver[:len(keys)] = rng.integers(0, 10_000, len(keys))
    return rows, ver


def wide_reads(rng, nr, n_live):
    """Read ranges over a small pool of wide ranges (so they repeat, some
    differing only in the end key), dead rows carrying live rows' keys,
    and snapshots straddling the versions."""
    pool = [wide_range(rng, MKB) for _ in range(40)]
    pool += [(b, wide_range(rng, MKB)[1] + b"\xff") for b, _ in pool[:6]]
    pick = [pool[i] for i in rng.integers(0, len(pool), nr)]
    rb = packing.pack_keys([b for b, _ in pick], MKB)
    re = packing.pack_keys([e for _, e in pick], MKB, round_up=True)
    rvalid = np.zeros(nr, bool)
    rvalid[:n_live] = True
    rb[n_live:] = rb[:nr - n_live]
    rsnap = rng.integers(0, 10_000, nr).astype(np.int32)
    return rb, re, rsnap, rvalid


@pytest.mark.parametrize("where", ["above", "equal", "below"])
@pytest.mark.parametrize("seed", range(2))
def test_main_stale_dedup_matches_jax(seed, where):
    rng = np.random.default_rng(600 + seed)
    keys, ver = wide_main_tier(rng, 120, 192)
    rb, re, rsnap, rvalid = wide_reads(rng, 160, 130)
    n = len(np.unique(np.concatenate([rb[rvalid], re[rvalid]], axis=1),
                      axis=0))
    u = {"above": n + 7, "equal": n, "below": n - 1}[where]
    j_stale, j_ok = _JAX_MAIN_STALE(
        JH.VersionHistory(jnp.asarray(keys), jnp.asarray(ver),
                          jnp.int32(NEG), jnp.asarray(False)),
        JR.build(jnp.asarray(ver), op="max"), jnp.asarray(rb),
        jnp.asarray(re), jnp.asarray(rsnap), jnp.asarray(rvalid), u)
    main = interop.history_from_numpy(keys, ver, NEG, False, "cpu")
    tab = R.build(main.main_ver, op="max")
    stale, ok = D._main_stale(main, tab, t(rb), t(re), t(rsnap), t(rvalid), u)
    _, n_uniq = D.dedup_vmax(main, tab, t(rb), t(re), t(rvalid), u)
    assert int(n_uniq) == n
    assert bool(ok) == bool(j_ok) == (where != "below")
    if where != "below":
        exact, _ = D._main_stale(main, tab, t(rb), t(re), t(rsnap),
                                 t(rvalid), 0)
        assert np.array_equal(stale.numpy(), np.asarray(j_stale))
        assert np.array_equal(stale.numpy(), exact.numpy())
        assert stale.numpy().any() and not stale.numpy().all()


# ---------------------------------------------------------------------------
# a tiered and a classic group of 4 (the coverage sort and group ranks)

GROUP_KW = dict(max_key_bytes=MKB, max_txns=16, max_reads=32, max_writes=32,
                history_capacity=512, window_versions=1000)


def wide_stream(rng, n_batches, base=1000, step=100, n_txns=14):
    out = []
    for i in range(n_batches):
        txns = [CommitTransaction(
            read_conflict_ranges=[] if rng.random() < 0.15 else [
                wide_range(rng, MKB) for _ in range(1 + int(rng.integers(
                    0, 2)))],
            write_conflict_ranges=[wide_range(rng, MKB) for _ in range(
                1 + int(rng.integers(0, 2)))],
            read_snapshot=int(rng.integers(max(0, base - 2 * step),
                                           base + (i + 1) * step)))
            for _ in range(n_txns)]
        out.append((txns, base + (i + 1) * step))
    return out


def history_maps(port, jax_cs):
    """(port, JAX) canonical maps of every tier."""
    if port.tiered:
        tiers = interop.tiered_state_to_numpy(port.state)
        jtiers = (jax_cs.state.main, jax_cs.state.delta)
    else:
        tiers = (interop.history_to_numpy(port.state),)
        jtiers = (jax_cs.state,)
    return ([canonical_map(k, v) for k, v, _, _ in tiers],
            [canonical_map(np.asarray(j.main_keys), np.asarray(j.main_ver))
             for j in jtiers])


@pytest.mark.parametrize("tiered", [True, False], ids=["tiered", "classic"])
def test_group_of_4_matches_jax(tiered):
    kw = dict(GROUP_KW, delta_capacity=256, compact_interval=3) if tiered \
        else GROUP_KW
    jax_cs = JCS.make_conflict_set(JaxConfig(**kw), "tpu-force")
    port = make_conflict_set(KernelConfig(**kw), "cuda", device="cpu")
    assert port.tiered == tiered
    rng = np.random.default_rng(70 + tiered)
    batches = [packing.pack_batch(txns, v, 0, port.config)
               for txns, v in wide_stream(rng, 8)]
    committed = 0
    for lo in (0, 4):
        stacked = packing.stack_device_args(batches[lo:lo + 4])
        got = port.resolve_group_args(stacked)
        assert_same_out(got, jax_cs.resolve_group_args(stacked),
                        f"group at {lo}:")
        got_maps, want_maps = history_maps(port, jax_cs)
        assert got_maps == want_maps
        committed += int(got.committed_count.sum())
    assert committed > 0
