"""The port's group kernel at G > 1 and its two new kernels, held against
the JAX package on the CPU.

* `build2_plain` / `query2_plain` against JAX `build2` / `query2`: both
  tables and every query (lengths not a multiple of 32, spans under and
  over a chunk, empty and clipped ranges, max and min);
* `seg_fold_plain` against the JAX fold (the scatter / cumsum / where of
  foundationdb_tpu/ops/group.py:588-597, written out below in jnp),
  including a write over the whole space and inverted writes;
* `resolve_group` at G in {2, 3, 8} against JAX `resolve_group`, the
  cases of tests/test_group_parity.py (random, snapshots straddling the
  group versions, tooOld and blind writes, hot-key contention,
  continuation across groups, a non-empty prestate) plus the rank-space
  edge cases (equal keys across batches, a write end equal to a read
  begin, keys equal to tier boundaries, empty and inverted ranges, dead
  rows), and against the port's own sequential resolve_batch;
* the fixpoint latch at G > 1: a deep chain trips `unconverged`
  group-wide and hands back the input state, as JAX does;
* G = 1 equals resolve_batch; G = 17 raises on both sides.

Inputs are numpy (seeded generators, packed once, fed to both sides).
The tolerance is equality throughout: every output is an integer or a
bool, and the history must be the same canonical map (JAX's
tests/test_group_parity.canonical_map) with the same floor and overflow.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.config import KernelConfig as JaxConfig
from foundationdb_tpu.ops import conflict as JC
from foundationdb_tpu.ops import group as JG
from foundationdb_tpu.ops import history as JH
from foundationdb_tpu.ops import rangemax as JR
from foundationdb_tpu_torch import interop
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.ops import conflict as C
from foundationdb_tpu_torch.ops import group as G
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.ops import rangemax as R
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import packing

from conftest import random_range

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

KW = dict(max_key_bytes=8, max_txns=16, max_reads=32, max_writes=32,
          history_capacity=512, window_versions=1000)
TCFG = KernelConfig(**KW)
JCFG = JaxConfig(**KW)


# ---------------------------------------------------------------------------
# K14: the two-level table and the fold

@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("m", [1, 33, 1000])
def test_build2_query2_match_jax(m, op):
    rng = np.random.default_rng(m)
    vals = rng.integers(-10**9, 10**9, m).astype(np.int32)
    lo = rng.integers(-3, m + 40, 2000).astype(np.int32)
    span = rng.integers(-5, 100, 2000)
    span[::7] = rng.integers(0, 33, len(span[::7]))       # within a chunk
    span[1::7] = rng.integers(33, max(34, m + 5), len(span[1::7]))
    hi = (lo + span).astype(np.int32)
    want = JR.build2(jnp.asarray(vals), op=op)
    got = R.build2_plain(torch.from_numpy(vals), op=op)
    for part, w, t in zip(("fine", "coarse"), want, got):
        assert np.array_equal(np.asarray(w), t.numpy()), part
    q_want = np.asarray(JR.query2(want, jnp.asarray(lo), jnp.asarray(hi),
                                  op=op))
    q_got = R.query2_plain(got, torch.from_numpy(lo), torch.from_numpy(hi),
                           op=op)
    assert np.array_equal(q_want, q_got.numpy())
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(R.query2(R.build2(torch.from_numpy(vals), op=op),
                                torch.from_numpy(lo), torch.from_numpy(hi),
                                op=op), q_got)


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


@pytest.mark.parametrize("seed", range(3))
def test_seg_fold_matches_jax(seed):
    rng = np.random.default_rng(10 + seed)
    n, nw = 997, 300
    seg = rng.integers(-5, 50, n).astype(np.int32)
    seg[rng.random(n) < 0.5] = G.VERSION_NEG
    wb = rng.integers(0, n, nw).astype(np.int32)
    we = np.minimum(wb + rng.integers(0, 40, nw), n - 1).astype(np.int32)
    we[:5] = wb[:5] - 3                          # inverted writes
    wb[5], we[5] = 0, n - 1                      # the whole space
    cw = rng.random(nw) < 0.6
    cw[5] = seed == 0
    want = np.asarray(jax_fold(jnp.asarray(seg), jnp.asarray(wb),
                               jnp.asarray(we), jnp.asarray(cw), 77))
    args = [torch.from_numpy(a) for a in (seg, wb, we, cw)]
    painted = args[0].clone()
    got = G.seg_fold_plain(painted, *args[1:], 77)
    assert got is painted                        # in place
    assert np.array_equal(want, got.numpy())
    # the wrapper on CPU tensors is the plain version, in place too
    again = args[0].clone()
    assert G.seg_fold(again, *args[1:], 77) is again
    assert torch.equal(again, got)


# ---------------------------------------------------------------------------
# the group kernel

@functools.lru_cache(maxsize=None)
def jax_group(unroll: int = 3, latch: bool = False):
    return jax.jit(functools.partial(JG.resolve_group, fixpoint_unroll=unroll,
                                     fixpoint_latch=latch))


_JAX_BATCH = jax.jit(JC.resolve_batch)


def canonical_map(keys, ver):
    """tests/test_group_parity.canonical_map on numpy leaves."""
    dedup = {}
    for j in range(keys.shape[0]):
        if np.all(keys[j] == 0xFFFFFFFF):
            continue
        dedup[tuple(int(x) for x in keys[j])] = int(ver[j])
    out = []
    for k in sorted(dedup):
        if not out or out[-1][1] != dedup[k]:
            out.append((k, dedup[k]))
    return out


def assert_same_state(port_state, jax_state):
    keys, ver, oldest, overflow = interop.history_to_numpy(port_state)
    assert canonical_map(keys, ver) == canonical_map(
        np.asarray(jax_state.main_keys), np.asarray(jax_state.main_ver))
    assert oldest == int(jax_state.oldest)
    assert overflow == bool(jax_state.overflow)


def assert_same_out(got, want, tag=""):
    for f in want._fields:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f"{tag} {f}"


def random_txn(rng, *, snap_lo, snap_hi, blind_prob=0.15):
    reads = [] if rng.random() < blind_prob else [
        random_range(rng) for _ in range(1 + int(rng.integers(0, 2)))]
    writes = [random_range(rng) for _ in range(1 + int(rng.integers(0, 2)))]
    return CommitTransaction(read_conflict_ranges=reads,
                             write_conflict_ranges=writes,
                             read_snapshot=int(rng.integers(snap_lo, snap_hi)))


def gen_group(rng, g, base=1000, step=100, n_txns=12):
    """G batches whose snapshots straddle the group's commit versions."""
    return [packing.pack_batch(
        [random_txn(rng, snap_lo=max(0, base - 2 * step),
                    snap_hi=base + (i + 1) * step) for _ in range(n_txns)],
        base + (i + 1) * step, 0, TCFG) for i in range(g)]


def run_both(batches, *, pre=(), unroll=3, latch=False):
    """The group through both kernels after `pre` batches (resolve_batch
    on both sides). Returns ((jax state, out), (port state, out), the
    input states)."""
    js, ts = JH.init(JCFG), H.init(TCFG, "cpu")
    for pb in pre:
        js, _ = _JAX_BATCH(js, pb.device_args())
        ts, _ = C.resolve_batch(ts, pb.device_args())
    stacked = packing.stack_device_args(batches)
    j2, jo = jax_group(unroll, latch)(js, stacked)
    t2, to = G.resolve_group(ts, interop.device_args_to_torch(stacked, "cpu"),
                             fixpoint_unroll=unroll, fixpoint_latch=latch)
    return (j2, jo), (t2, to), (js, ts)


def assert_group_matches(batches, *, pre=()):
    """Port group == JAX group (every field, the map), and == the port's
    own batches in sequence."""
    (j2, jo), (t2, to), (_, ts) = run_both(batches, pre=pre)
    assert_same_out(to, jo, "vs JAX:")
    assert_same_state(t2, j2)
    seq = ts
    for i, pb in enumerate(batches):
        seq, out = C.resolve_batch(seq, pb.device_args())
        for f in out._fields:
            if f == "overflow":
                continue
            assert torch.equal(getattr(to, f)[i], getattr(out, f)), (i, f)
    s_keys, s_ver, _, _ = interop.history_to_numpy(seq)
    g_keys, g_ver, _, _ = interop.history_to_numpy(t2)
    assert canonical_map(g_keys, g_ver) == canonical_map(s_keys, s_ver)
    return to


@pytest.mark.parametrize("gn,seed", [(2, 0), (2, 1), (3, 2), (3, 3), (8, 4),
                                     (8, 5)])
def test_group_matches_jax_random(gn, seed):
    rng = np.random.default_rng(seed)
    assert_group_matches(gen_group(rng, gn))


def test_group_snapshot_straddles_versions():
    """A read whose snapshot is at or past an earlier batch's version saw
    that batch's write; one under it conflicts."""
    k = lambda i: bytes([i])  # noqa: E731
    writer = CommitTransaction([], [(k(5), k(6))], read_snapshot=50)
    reader_new = CommitTransaction([(k(5), k(6))], [(k(9), k(10))],
                                   read_snapshot=150)
    reader_old = CommitTransaction([(k(5), k(6))], [(k(11), k(12))],
                                   read_snapshot=90)
    b0 = packing.pack_batch([writer], 100, 0, TCFG)
    b1 = packing.pack_batch([reader_new, reader_old], 200, 0, TCFG)
    out = assert_group_matches([b0, b1])
    assert out.verdict[1, 0] == C.COMMITTED
    assert out.verdict[1, 1] == C.CONFLICT


def test_group_too_old_and_blind_writes():
    cfg = TCFG.scaled(window_versions=100)
    k = lambda i: bytes([i])  # noqa: E731
    stale = CommitTransaction([(k(1), k(2))], [(k(1), k(2))], read_snapshot=5)
    blind = CommitTransaction([], [(k(3), k(4))], read_snapshot=5)
    b0 = packing.pack_batch([stale, blind], 200, 0, cfg)
    b1 = packing.pack_batch([stale], 300, 0, cfg)
    b2 = packing.pack_batch([blind, stale], 400, 0, cfg)
    out = assert_group_matches([b0, b1, b2])
    assert out.verdict[0, 0] == C.TOO_OLD
    assert out.verdict[0, 1] == C.COMMITTED


@pytest.mark.parametrize("seed", range(2))
def test_group_hot_key_contention(seed):
    """Every batch reads and writes one hot range: long cross-batch
    chains."""
    rng = np.random.default_rng(100 + seed)
    hot = (b"\x10", b"\x11")
    batches = []
    for i in range(8):
        version = 1000 + (i + 1) * 100
        txns = [CommitTransaction(
            [hot] if rng.random() < 0.7 else [random_range(rng)],
            [hot] if rng.random() < 0.7 else [random_range(rng)],
            read_snapshot=int(rng.integers(900, version)))
            for _ in range(8)]
        batches.append(packing.pack_batch(txns, version, 0, TCFG))
    assert_group_matches(batches)


def test_group_continuation_across_groups():
    """Group 2 sees group 1's writes as ordinary history."""
    rng = np.random.default_rng(7)
    batches = gen_group(rng, 6, n_txns=10)
    js, ts = JH.init(JCFG), H.init(TCFG, "cpu")
    for lo in (0, 3):
        stacked = packing.stack_device_args(batches[lo:lo + 3])
        js, jo = jax_group()(js, stacked)
        ts, to = G.resolve_group(ts, interop.device_args_to_torch(stacked,
                                                                  "cpu"))
        assert_same_out(to, jo, f"group at {lo}:")
        assert_same_state(ts, js)


@pytest.mark.parametrize("seed", range(2))
def test_group_parity_with_prestate(seed):
    """A non-empty tier before the group: a txn condemned by pre-group
    history still reports its cross-batch conflicting reads."""
    rng = np.random.default_rng(200 + seed)
    pre = gen_group(rng, 2, base=500)
    assert_group_matches(gen_group(rng, 3), pre=pre)


def test_group_rank_space_edges():
    """Endpoint ties the group-wide ranks must order as the JAX block
    index does: keys equal across batches, a write end equal to a read
    begin, keys equal to tier boundaries, empty and inverted ranges, and
    dead rows (a too-old txn, padding)."""
    cfg = TCFG.scaled(window_versions=150)
    k = lambda i: bytes([i])  # noqa: E731
    T = CommitTransaction
    # the tier: boundaries at 10, 20, 30, 40
    pre = [packing.pack_batch([T([], [(k(10), k(20))], read_snapshot=0),
                               T([], [(k(30), k(40))], read_snapshot=0)],
                              100, 0, cfg)]
    b0 = packing.pack_batch([
        T([(k(1), k(2))], [(k(20), k(30))], read_snapshot=150),  # tier ties
        T([(k(5), k(5))], [(k(5), k(8))], read_snapshot=150),    # empty read
        T([(k(9), k(7))], [(k(50), k(60))], read_snapshot=150),  # inverted
        T([(k(3), k(4))], [(k(3), k(4))], read_snapshot=1),      # too old
    ], 200, 0, cfg)
    b1 = packing.pack_batch([
        T([(k(8), k(20))], [(k(60), k(61))], read_snapshot=150),  # wb end
        T([(k(30), k(35))], [(k(12), k(12))], read_snapshot=190),
        T([(k(50), k(60))], [(k(70), k(65))], read_snapshot=150),  # equal
        T([(k(5), k(6))], [(k(20), k(30))], read_snapshot=250),
    ], 300, 0, cfg)
    b2 = packing.pack_batch([
        T([(k(60), k(62))], [(k(1), k(100))], read_snapshot=250),
        T([(k(19), k(21))], [(k(0), k(1))], read_snapshot=290),
        T([(k(0), k(100))], [], read_snapshot=350),
    ], 400, 0, cfg)
    js, ts = JH.init(JaxConfig(**{**KW, "window_versions": 150})), H.init(
        cfg, "cpu")
    for pb in pre:
        js, _ = _JAX_BATCH(js, pb.device_args())
        ts, _ = C.resolve_batch(ts, pb.device_args())
    stacked = packing.stack_device_args([b0, b1, b2])
    j2, jo = jax_group()(js, stacked)
    t2, to = G.resolve_group(ts, interop.device_args_to_torch(stacked, "cpu"))
    assert_same_out(to, jo)
    assert_same_state(t2, j2)
    assert to.verdict[0, 3] == C.TOO_OLD
    assert set(to.verdict.reshape(-1).tolist()) >= {C.COMMITTED, C.CONFLICT}


def test_group_of_one_equals_resolve_batch():
    rng = np.random.default_rng(3)
    (pb,) = gen_group(rng, 1)
    stacked = packing.stack_device_args([pb])
    s1, o1 = G.resolve_group(H.init(TCFG, "cpu"),
                             interop.device_args_to_torch(stacked, "cpu"))
    s2, o2 = C.resolve_batch(H.init(TCFG, "cpu"), pb.device_args())
    js, jo = _JAX_BATCH(JH.init(JCFG), pb.device_args())
    for f in o2._fields:
        assert torch.equal(getattr(o1, f)[0], getattr(o2, f)), f
        assert np.array_equal(getattr(o2, f).numpy(),
                              np.asarray(getattr(jo, f))), f
    assert torch.equal(s1.main_keys, s2.main_keys)
    assert torch.equal(s1.main_ver, s2.main_ver)
    assert_same_state(s2, js)


def test_group_of_seventeen_raises():
    rng = np.random.default_rng(4)
    stacked = packing.stack_device_args(gen_group(rng, 17, n_txns=2))
    with pytest.raises(ValueError, match="MAX_GROUP"):
        JG.resolve_group(JH.init(JCFG), stacked)
    with pytest.raises(ValueError, match="MAX_GROUP"):
        G.resolve_group(H.init(TCFG, "cpu"),
                        interop.device_args_to_torch(stacked, "cpu"))


def chain_batches(n=12):
    """Batch 0: a writer; batch 1: a chain txn i reads key i-1 and writes
    key i (depth ~n, the worst case for a bounded unroll)."""
    T = CommitTransaction
    b0 = packing.pack_batch([T([], [(b"zz", b"zz\x00")], read_snapshot=5)],
                            10, 0, TCFG)
    txns = []
    for i in range(n):
        prev = b"ch%02d" % (i - 1) if i else b"yy"
        cur = b"ch%02d" % i
        txns.append(T([(prev, prev + b"\x00")], [(cur, cur + b"\x00")],
                      read_snapshot=5))
    return [b0, packing.pack_batch(txns, 20, 0, TCFG)]


def test_group_latch_trips_and_keeps_the_state():
    """fixpoint_latch at G = 2 with a shallow unroll: the group-wide trip
    as in JAX, the input state handed back unchanged; with a deep enough
    unroll the latched group equals the exact one."""
    batches = chain_batches()
    pre = gen_group(np.random.default_rng(5), 1, base=0, step=5)
    (j2, jo), (t2, to), (js, ts) = run_both(batches, pre=pre, unroll=2,
                                            latch=True)
    assert bool(to.unconverged.all()) and bool(np.asarray(jo.unconverged).all())
    assert t2 is ts
    assert_same_state(t2, j2)
    assert_same_state(ts, js)
    (je, jeo), (te, teo), _ = run_both(batches, pre=pre)
    assert not bool(teo.unconverged.any())
    assert_same_out(teo, jeo)
    (_, _), (tl, tlo), _ = run_both(batches, pre=pre, unroll=14, latch=True)
    assert not bool(tlo.unconverged.any())
    for f in ("verdict", "hist_conflict_read", "intra_first_range"):
        assert torch.equal(getattr(tlo, f), getattr(teo, f)), f
    assert torch.equal(tl.main_ver, te.main_ver)
    assert_same_state(te, je)
