"""The port's primitives held against the JAX package, on the CPU.

Each function of foundationdb_tpu_torch/ops that stands in for a kernel
runs its plain PyTorch version here (CPU tensors) and must give exactly
the JAX function's output on the same seeded numpy inputs: every output
is an integer or a bool, so the tolerance is equality. The CUDA kernels
behind the same functions are held against these plain versions on the
card (chip_smoke.py, tests/test_torch_cuda.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import delta as JD
from foundationdb_tpu.ops import group as JG
from foundationdb_tpu.ops import history as JH
from foundationdb_tpu.ops import keys as JK
from foundationdb_tpu.ops import rangemax as JR
from foundationdb_tpu.ops import segtree as JS
from foundationdb_tpu_torch import interop
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.ops import delta as D
from foundationdb_tpu_torch.ops import group as G
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.ops import keys as K
from foundationdb_tpu_torch.ops import rangemax as R
from foundationdb_tpu_torch.ops import segtree as S
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import packing

from conftest import random_range

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

KEY_BYTES = 8
W = KEY_BYTES // 4 + 1
NEG = JH.VERSION_NEG
SENT = 0xFFFFFFFF
CFG = KernelConfig(max_key_bytes=KEY_BYTES, max_txns=16, max_reads=32,
                   max_writes=32, history_capacity=64, window_versions=1000,
                   delta_capacity=64)


def t(a: np.ndarray) -> torch.Tensor:
    return interop.to_torch(np.asarray(a), "cpu")


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x)


def keys_of(x) -> np.ndarray:
    """Packed keys as uint32 (torch holds int32 bit patterns)."""
    return np_of(x).astype(np.int64).astype(np.uint32)


def rand_bytes(rng, max_len=KEY_BYTES, alphabet=(0, 1, 0x7F, 0x80, 0xFF)):
    n = int(rng.integers(0, max_len + 1))
    return bytes(alphabet[i] for i in rng.integers(0, len(alphabet), n))


def sorted_key_table(rng, n_keys, cap, dup_every=0):
    """[cap, W] sorted packed keys (sentinel tail) and the live count."""
    ks = sorted({rand_bytes(rng) for _ in range(n_keys)})
    if dup_every:
        ks = sorted(ks + ks[::dup_every])
    assert len(ks) <= cap
    table = np.full((cap, W), SENT, np.uint32)
    table[: len(ks)] = packing.pack_keys(ks, KEY_BYTES)
    return table, ks


# ---------------------------------------------------------------------------
# K1 / K2: compare and search

def test_lex_less_and_eq_match_jax():
    rng = np.random.default_rng(0)
    a = packing.pack_keys([rand_bytes(rng) for _ in range(300)], KEY_BYTES)
    b = packing.pack_keys([rand_bytes(rng) for _ in range(300)], KEY_BYTES)
    b[::7] = a[::7]
    b[::11] = SENT
    assert np.array_equal(np_of(K.lex_less(t(a), t(b))),
                          np.asarray(JK.lex_less(jnp.asarray(a), jnp.asarray(b))))
    assert np.array_equal(np_of(K.lex_eq(t(a), t(b))),
                          np.asarray(JK.lex_eq(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("dup_every", [0, 3])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("seed", range(2))
def test_searchsorted_matches_jax(seed, side, dup_every):
    """Left/right, queries equal to keys, prefixes of keys, random keys,
    the empty key and sentinel queries; keys with repeats and a
    sentinel tail."""
    rng = np.random.default_rng(seed)
    table, ks = sorted_key_table(rng, 80, 120, dup_every)
    qs = ([rand_bytes(rng) for _ in range(50)] + ks[::2]
          + [k[:-1] for k in ks if k] + [b""])
    q = np.concatenate([packing.pack_keys(qs, KEY_BYTES),
                        np.full((3, W), SENT, np.uint32)])
    want = np.asarray(JK.searchsorted(jnp.asarray(table), jnp.asarray(q),
                                      side=side))
    got = K.searchsorted(t(table), t(q), side=side)
    assert got.dtype == torch.int32
    assert np.array_equal(np_of(got), want)


def test_dense_ranks_match_jax_sort_ranks():
    rng = np.random.default_rng(3)
    ks = [rand_bytes(rng, 4) for _ in range(200)]
    pts = packing.pack_keys(ks, KEY_BYTES)
    valid = np.ones((200,), bool)
    want, _, _ = JK.sort_ranks(jnp.asarray(pts), jnp.asarray(valid))
    assert np.array_equal(np_of(K.dense_ranks(t(pts))), np.asarray(want))


# ---------------------------------------------------------------------------
# K3: the doubling table

@pytest.mark.parametrize("m", [1, 2, 3, 37, 256, 1000])
@pytest.mark.parametrize("op", ["max", "min"])
def test_rangemax_build_and_query_match_jax(op, m):
    rng = np.random.default_rng(m)
    vals = rng.integers(-(2**31) + 1, 2**31 - 1, size=m).astype(np.int32)
    vals[:: 5] = NEG
    vals[1:: 7] = JR.INT32_POS
    tab_j = JR.build(jnp.asarray(vals), op=op)
    tab_t = R.build(t(vals), op=op)
    assert np.array_equal(np_of(tab_t), np.asarray(tab_j))
    lo = rng.integers(-3, m + 3, size=400).astype(np.int32)
    hi = rng.integers(-3, m + 3, size=400).astype(np.int32)
    hi[:50] = lo[:50]  # empty ranges
    want = JR.query(tab_j, jnp.asarray(lo), jnp.asarray(hi), op=op)
    got = R.query(tab_t, t(lo), t(hi), op=op)
    assert np.array_equal(np_of(got), np.asarray(want))


def test_floor_log2_matches_jax():
    n = np.array([1, 2, 3, 4, 5, 7, 8, 1023, 1024, 2**24 - 1, 2**24,
                  2**24 + 1, 2**30, 2**31 - 1], np.int32)
    want = JR._floor_log2(jnp.asarray(n), 32)
    assert np.array_equal(np_of(R._floor_log2(t(n), 32)), np.asarray(want))


# ---------------------------------------------------------------------------
# K4: the history probe

_JAX_PROBE = jax.jit(JH.query_reads_vmax)


@pytest.mark.parametrize("seed", range(3))
def test_query_reads_vmax_matches_jax(seed):
    """Reads spanning one segment, none, and more than the JAX probe's
    4-boundary window (which then falls back to a full search)."""
    rng = np.random.default_rng(10 + seed)
    table, ks = sorted_key_table(rng, 60, 80)
    ver = rng.integers(0, 10_000, size=80).astype(np.int32)
    ver[len(ks):] = NEG
    pairs = []
    while len(pairs) < 100:
        a, b = sorted((rand_bytes(rng), rand_bytes(rng)))
        if a != b:
            pairs.append((a, b))
    for i in rng.integers(0, len(ks) - 6, size=20):  # wide reads
        pairs.append((ks[i], ks[min(i + int(rng.integers(5, 30)),
                                    len(ks) - 1)]))
    rb = packing.pack_keys([p[0] for p in pairs], KEY_BYTES)
    re = packing.pack_keys([p[1] for p in pairs], KEY_BYTES, round_up=True)
    jstate = JH.VersionHistory(jnp.asarray(table), jnp.asarray(ver),
                               jnp.int32(NEG), jnp.asarray(False))
    want = np.asarray(_JAX_PROBE(jstate, jnp.asarray(rb), jnp.asarray(re)))
    tstate = interop.history_from_numpy(table, ver, NEG, False, "cpu")
    got = np_of(H.query_reads_vmax(tstate, t(rb), t(re)))
    assert np.array_equal(got, want)
    il = np.searchsorted(ks, [p[0] for p in pairs], side="right") - 1
    ir = np.searchsorted(ks, [p[1] for p in pairs], side="left") - 1
    assert (ir - il > 4).any(), "no read spans more than 4 segments"


# ---------------------------------------------------------------------------
# K5 / K6: the writer cover and the per-txn windows

@pytest.mark.parametrize("leaves", [1, 64, 256])
def test_min_cover_matches_jax(leaves):
    rng = np.random.default_rng(leaves)
    n = 300
    lo = rng.integers(-4, leaves + 4, size=n).astype(np.int32)
    hi = (lo + rng.integers(-3, leaves // 2 + 2, size=n)).astype(np.int32)
    val = rng.integers(0, 1000, size=n).astype(np.int32)
    val[::4] = JR.INT32_POS
    want = JS.min_cover(leaves, jnp.asarray(lo), jnp.asarray(hi),
                        jnp.asarray(val))
    got = S.min_cover(leaves, t(lo), t(hi), t(val))
    assert np.array_equal(np_of(got), np.asarray(want))


@pytest.mark.parametrize("n_live", [0, 1, 20, 32])
def test_sorted_counts_matches_jax(n_live):
    rng = np.random.default_rng(n_live)
    b, nr = 16, 32
    ids = np.full((nr,), b, np.int32)
    ids[:n_live] = np.sort(rng.integers(0, b, size=n_live))
    want = JG._sorted_counts(jnp.asarray(ids), b + 1)
    assert np.array_equal(np_of(G._sorted_counts(t(ids), b + 1)),
                          np.asarray(want))


# ---------------------------------------------------------------------------
# K7 at G=1 and its merge; K9

def random_batch(rng, version, *, n_txns=12, snap_lo=0):
    txns = []
    for _ in range(n_txns):
        reads = [] if rng.random() < 0.15 else [
            random_range(rng) for _ in range(1 + int(rng.integers(0, 2)))]
        writes = [random_range(rng) for _ in range(1 + int(rng.integers(0, 2)))]
        txns.append(CommitTransaction(reads, writes,
                                      int(rng.integers(snap_lo, version))))
    return packing.pack_batch(txns, version, 0, CFG)


_JAX_GROUP = jax.jit(lambda s, g, e: JG.resolve_group(s, g, extra_stale=e))


def _assert_verdicts_equal(got, want):
    for f in JG.GroupVerdict._fields:
        assert np.array_equal(np_of(getattr(got, f)),
                              np.asarray(getattr(want, f))), f


def _assert_history_equal(got: H.VersionHistory, want):
    assert np.array_equal(keys_of(got.main_keys), np.asarray(want.main_keys))
    assert np.array_equal(np_of(got.main_ver), np.asarray(want.main_ver))
    assert got.oldest == int(want.oldest)
    assert bool(got.overflow) == bool(want.overflow)


@pytest.mark.parametrize("cap", [64, 2])
@pytest.mark.parametrize("seed", range(3))
def test_resolve_group_and_merge_match_jax(seed, cap):
    """A stream of batches through the G=1 group kernel on one tier: the
    verdicts, the merged tier (row for row, including GC at the floor
    and, at cap 2, the overflow latch) and, separately, merge_maps of
    the committed-write coverage against the state JAX returns."""
    rng = np.random.default_rng(100 + seed)
    jstate = JH.VersionHistory(
        jnp.asarray(np.full((cap, W), SENT, np.uint32)),
        jnp.full((cap,), NEG, jnp.int32), jnp.int32(NEG), jnp.asarray(False))
    tstate = H.empty(cap, W, "cpu")
    for i in range(6):
        version = 1000 + 400 * i  # the window is 1000: GC after batch 2
        pb = random_batch(rng, version, snap_lo=max(0, version - 900))
        g = packing.stack_device_args([pb])
        extra = rng.random((1, CFG.max_reads)) < 0.1
        j_in = jstate
        jstate, jout = _JAX_GROUP(j_in, {k: jnp.asarray(v) for k, v in g.items()},
                                  jnp.asarray(extra))
        t_in = tstate
        tstate, tout = G.resolve_group(
            t_in, interop.device_args_to_torch(g, "cpu"),
            extra_stale=t(extra))
        _assert_verdicts_equal(tout, jout)
        _assert_history_equal(tstate, jstate)

        committed = np.asarray(jout.verdict[0]) == JG.COMMITTED
        wt = np.clip(pb.write_txn, 0, CFG.max_txns - 1)
        cw = pb.write_valid & committed[wt]
        cov_keys, cov_val = G._coverage(t(pb.write_begin), t(pb.write_end),
                                        t(cw), version)
        keys, ver, count = H.merge_maps(
            t_in.main_keys, t_in.main_ver, cov_keys, cov_val,
            floor=int(pb.new_oldest), capacity=cap)
        assert np.array_equal(keys_of(keys), np.asarray(jstate.main_keys))
        assert np.array_equal(np_of(ver), np.asarray(jstate.main_ver))
        assert bool(t_in.overflow) or (int(count) > cap) == bool(
            jstate.overflow)
    if cap == 2:
        assert bool(jstate.overflow), "the small tier never overflowed"


def random_tier(rng, cap, n_live, vlo, vhi, *, intervals=False):
    """A tier of up to `cap` rows: redundant rows and NEG segments, or
    (intervals) alternating [begin, end) rows as write coverage gives."""
    table, ks = sorted_key_table(rng, n_live, 2 * cap)
    table = table[:cap]
    n = min(len(ks), cap)
    ver = np.full((cap,), NEG, np.int32)
    v = rng.integers(vlo, vhi, size=n).astype(np.int32)
    if intervals:
        v[1::2] = NEG
    else:
        v[1::5] = v[0::5][: len(v[1::5])]  # redundant rows
        v[::9] = NEG
    ver[:n] = v
    return table, ver


_JAX_COMPACT = jax.jit(JD.compact)


@pytest.mark.parametrize(
    "n_main,n_delta,delta_vals,oldest,delta_overflow,canonical_main,overflows",
    [
        (100, 20, (2000, 6000), NEG, False, False, False),   # no GC
        (100, 20, (2000, 6000), 3000, False, False, False),  # GC at the floor
        (200, 60, (0, 1000), NEG, False, True, True),    # main overflows
        (40, 30, (2000, 6000), 2000, True, False, True),  # delta's latch
    ],
)
def test_compact_matches_jax(n_main, n_delta, delta_vals, oldest,
                             delta_overflow, canonical_main, overflows):
    rng = np.random.default_rng(n_main + n_delta)
    main = random_tier(rng, 128, n_main, 0, 5000, intervals=canonical_main)
    delta = random_tier(rng, 64, n_delta, *delta_vals, intervals=True)
    j_state = JD.TieredState(
        main=JH.VersionHistory(jnp.asarray(main[0]), jnp.asarray(main[1]),
                               jnp.int32(oldest), jnp.asarray(False)),
        delta=JH.VersionHistory(jnp.asarray(delta[0]), jnp.asarray(delta[1]),
                                jnp.int32(oldest), jnp.asarray(delta_overflow)),
    )
    want = _JAX_COMPACT(j_state)
    got = D.compact(interop.tiered_state_from_numpy(
        (*main, oldest, False), (*delta, oldest, delta_overflow), "cpu"))
    _assert_history_equal(got.main, want.main)
    _assert_history_equal(got.delta, want.delta)
    assert bool(want.main.overflow) == overflows
