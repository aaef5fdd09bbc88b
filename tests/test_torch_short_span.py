"""The short-span Resolver variant (K13) and the last ported XLA programs
(K16 merge_writes, K17 sort_ranks, K19 radix-4), held against the JAX
package on the CPU.

Inputs are numpy (seeded generators), fed to both packages; every output
is an integer or a bool, so the tolerance is equality throughout:

* `sort_ranks` against JAX `sort_ranks` (invalid points, duplicates, a
  valid all-ones key, one point);
* `merge_writes` against JAX `merge_writes`, row for row (run bounds
  equal to tier keys, GC below the floor, capacity overflow);
* `build4` / `query4` / `min_cover4` against the JAX functions at widths
  1024, 4096 and 131072 (an odd log2 width) and at odd lengths;
* kernel K's plain versions (the range op, the cover and one fixpoint
  application, `ss_apply`) against a jnp transcription of the JAX
  direct ops;
* `resolve_group(short_span_limit=S)` at G = 1, 2 and 8 with S in
  {2, 4, 8} against JAX `resolve_group(short_span_limit=S)` on the point
  workloads of tests/test_group_parity.py, every GroupVerdict field and
  the history (canonical map, floor, overflow);
* the three trip cases: the wide read of tests/test_group_parity.py, a
  write wider than S, and a G = 2 group whose read covers S point ranks
  but more than S of the JAX co-sort's blocks because tier rows lie
  inside it; both packages set `overflow` there and nowhere else;
* `span_widths` (the spans the latch checks) on those cases: at S = the
  widest span the group passes, one below it trips;
* `TorchConflictSet` against `TpuConflictSet` with `short_span_limit`
  set: classic through `resolve_group_args`, tiered (`resolve`,
  `resolve_group_args`, also with the fixpoint latch and read dedup,
  and with the range sweep and delta spill) and sharded at 2 and 4
  shards, every field, every tier and the counters, decisions against
  the oracle; both raise HistoryOverflowError on the same group when the
  span latch trips; and a group where the fixpoint latch and the span
  latch trip together gives JAX's `unconverged`, `overflow` and state
  raw, and its exact fallback (which keeps S) raises in both.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.config import KernelConfig as JaxConfig
from foundationdb_tpu.models import conflict_set as JCS
from foundationdb_tpu.models.conflict_set import TpuConflictSet
from foundationdb_tpu.ops import group as JG
from foundationdb_tpu.ops import history as JH
from foundationdb_tpu.ops import keys as JK
from foundationdb_tpu.ops import rangemax as JR
from foundationdb_tpu.ops import segtree as JS
from foundationdb_tpu.parallel.mesh import cpu_mesh
from foundationdb_tpu_torch import HistoryOverflowError, interop
from foundationdb_tpu_torch import make_conflict_set
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.ops import group as G
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.ops import keys as K
from foundationdb_tpu_torch.ops import rangemax as R
from foundationdb_tpu_torch.ops import segtree as S
from foundationdb_tpu_torch.testing.oracle import (
    MultiResolverOracle,
    OracleTxn,
)
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import packing

from test_torch_group import assert_same_out, assert_same_state
from test_torch_variants import txns_of

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

KW = dict(max_key_bytes=8, max_txns=16, max_reads=32, max_writes=32,
          history_capacity=512, window_versions=1000)
TCFG = KernelConfig(**KW)
JCFG = JaxConfig(**KW)
SENT = np.uint32(0xFFFFFFFF)


def t(a) -> torch.Tensor:
    """numpy (uint32 words allowed) -> a CPU torch tensor."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def np_of(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 and a.ndim == 2 else a


def packed_keys(ints, w=3) -> np.ndarray:
    """int keys < 2^32 -> [N, w] uint32 rows (a big-endian word, zero
    words, then the length word 8)."""
    ints = np.asarray(ints, dtype=np.uint64)
    out = np.zeros((len(ints), w), np.uint32)
    out[:, 0] = ints.astype(np.uint32)
    out[:, -1] = 8
    return out


# ---------------------------------------------------------------------------
# K17: sort_ranks

@pytest.mark.parametrize("p,seed", [(1, 0), (64, 1), (300, 2), (1000, 3)])
def test_sort_ranks_matches_jax(p, seed):
    rng = np.random.default_rng(seed)
    pts = packed_keys(rng.integers(0, max(2, p // 3), p))
    pts[:, 1] = rng.integers(0, 3, p)               # a second word in play
    pts[rng.random(p) < 0.1] = SENT                 # valid all-ones rows
    valid = rng.random(p) < 0.8
    want = JK.sort_ranks(jnp.asarray(pts), jnp.asarray(valid))
    got = K.sort_ranks(t(pts), t(valid))
    for name, g, w in zip(("ranks", "unique_keys", "unique_count"), got,
                          want):
        assert np.array_equal(np_of(g), np.asarray(w)), name
    # the wrapper without a mask is dense_ranks
    assert torch.equal(K.sort_ranks(t(pts))[0], K.dense_ranks(t(pts)))


# ---------------------------------------------------------------------------
# K16: merge_writes

def tier_and_runs(rng, m, n_live, n_runs, on_tier):
    """A canonical tier of n_live rows (sentinel tail) and 2 * n_runs
    sorted disjoint run bounds; `on_tier` of the bounds are tier keys."""
    keys = np.sort(rng.choice(np.arange(10, 100_000, 7), n_live,
                              replace=False))
    main = np.full((m, 3), SENT, np.uint32)
    main[:n_live] = packed_keys(keys)
    ver = np.full((m,), JH.VERSION_NEG, np.int32)
    ver[:n_live] = rng.integers(0, 5000, n_live)
    pool = rng.choice(np.arange(5, 100_005, 3), 2 * n_runs, replace=False)
    pick = rng.choice(2 * n_runs, min(on_tier, 2 * n_runs), replace=False)
    pool[pick] = rng.choice(keys, len(pick), replace=False)
    bounds = np.unique(pool)
    bounds = bounds[: len(bounds) // 2 * 2]
    runs = np.full((2 * n_runs + 4, 3), SENT, np.uint32)
    runs[: len(bounds)] = packed_keys(bounds)
    return main, ver, runs


@pytest.mark.parametrize("seed,m,n_live,n_runs,on_tier,floor", [
    (0, 64, 40, 10, 0, 0),
    (1, 64, 40, 10, 8, 0),        # run keys equal to tier keys
    (2, 256, 200, 40, 30, 2500),  # and GC below the floor
    (3, 64, 60, 30, 20, 1000),    # past capacity: overflow
    (4, 32, 0, 5, 0, 0),          # an empty tier
])
def test_merge_writes_matches_jax(seed, m, n_live, n_runs, on_tier, floor):
    rng = np.random.default_rng(seed)
    main, ver, runs = tier_and_runs(rng, m, n_live, n_runs, on_tier)
    version = 6000
    js = JH.VersionHistory(jnp.asarray(main), jnp.asarray(ver),
                           jnp.int32(-5), jnp.asarray(False))
    want = jax.jit(JH.merge_writes)(js, jnp.asarray(runs), jnp.int32(version),
                                    jnp.int32(floor))
    ts = H.VersionHistory(t(main), t(ver), -5, torch.tensor(False))
    got = H.merge_writes(ts, t(runs), version, floor)
    assert np.array_equal(np_of(got.main_keys), np.asarray(want.main_keys))
    assert np.array_equal(got.main_ver.numpy(), np.asarray(want.main_ver))
    assert got.oldest == int(want.oldest)
    assert bool(got.overflow) == bool(want.overflow)
    if seed == 3:
        assert bool(got.overflow)
    if on_tier:   # the JAX rows keep a begin equal to a tier key twice
        keys = [tuple(r) for r in np_of(got.main_keys) if r[-1] != SENT]
        assert len(keys) > len(set(keys))


# ---------------------------------------------------------------------------
# K19: the radix-4 table and cover

@pytest.mark.parametrize("leaves", [1024, 4096, 131072])
def test_radix4_matches_jax(leaves):
    rng = np.random.default_rng(leaves)
    vals = rng.integers(0, 1 << 30, leaves).astype(np.int32)
    q = 2048
    lo = rng.integers(-2, leaves, q).astype(np.int32)
    hi = np.minimum(lo + rng.integers(-3, leaves, q), leaves + 3).astype(
        np.int32)
    for op in ("max", "min"):
        want_t = JR.build4(jnp.asarray(vals), op=op)
        got_t = R.build4(t(vals), op=op)
        assert np.array_equal(got_t.numpy(), np.asarray(want_t)), op
        want = JR.query4(want_t, jnp.asarray(lo), jnp.asarray(hi), op=op)
        assert np.array_equal(R.query4(got_t, t(lo), t(hi), op=op).numpy(),
                              np.asarray(want)), op
    n_int = 4096
    ilo = rng.integers(-2, leaves, n_int).astype(np.int32)
    ihi = (ilo + rng.integers(-2, max(leaves // 4, 2), n_int)).astype(
        np.int32)
    ival = rng.integers(0, n_int, n_int).astype(np.int32)
    want = JS.min_cover4(leaves, jnp.asarray(ilo), jnp.asarray(ihi),
                         jnp.asarray(ival))
    got = S.min_cover4(leaves, t(ilo), t(ihi), t(ival))
    assert np.array_equal(got.numpy(), np.asarray(want))
    # same answers as the radix-2 cover
    assert torch.equal(got, S.min_cover(leaves, t(ilo), t(ihi), t(ival)))


@pytest.mark.parametrize("m", [1, 2, 5, 17, 1000])
def test_build4_query4_odd_lengths_match_jax(m):
    rng = np.random.default_rng(m)
    vals = rng.integers(-10**9, 10**9, m).astype(np.int32)
    lo = rng.integers(-3, m + 3, 500).astype(np.int32)
    hi = (lo + rng.integers(-3, m + 5, 500)).astype(np.int32)
    for op in ("max", "min"):
        want_t = JR.build4(jnp.asarray(vals), op=op)
        got_t = R.build4(t(vals), op=op)
        assert np.array_equal(got_t.numpy(), np.asarray(want_t))
        assert np.array_equal(
            R.query4(got_t, t(lo), t(hi), op=op).numpy(),
            np.asarray(JR.query4(want_t, jnp.asarray(lo), jnp.asarray(hi),
                                 op=op)))


# ---------------------------------------------------------------------------
# K13: the direct ops (kernel K's plain versions)

def jax_direct_range_op(values, lo, hi, *, op, span):
    """foundationdb_tpu/ops/group.py:353-363, written out."""
    fn, ident = JR._OPS[op]
    n = values.shape[0]
    acc = jnp.full(lo.shape, ident, values.dtype)
    for d in range(span):
        pos = lo + d
        v = values[jnp.clip(pos, 0, n - 1)]
        acc = fn(acc, jnp.where(pos < hi, v, ident))
    return acc


def jax_cover(leaves, wlo, whi, val, span):
    """foundationdb_tpu/ops/group.py:511-519, written out."""
    flat = jnp.full((leaves + 1,), JR.INT32_POS, jnp.int32)
    for d in range(span):
        pos = wlo + d
        idx = jnp.where(pos < whi, pos, leaves)
        flat = flat.at[idx].min(val)
    return flat[:leaves]


@pytest.mark.parametrize("span", [1, 2, 4, 8])
def test_direct_ops_match_jax(span):
    rng = np.random.default_rng(span)
    n = 512
    vals = rng.integers(-10**6, 10**6, n).astype(np.int32)
    lo = rng.integers(0, n, 3000).astype(np.int32)
    hi = (lo + rng.integers(-2, 12, 3000)).astype(np.int32)
    hi[:5] = n + 4                                     # past the end
    for op in ("max", "min"):
        want = jax_direct_range_op(jnp.asarray(vals), jnp.asarray(lo),
                                   jnp.asarray(hi), op=op, span=span)
        got = G.ss_range(t(vals), t(lo), t(hi), span, op=op)
        assert np.array_equal(got.numpy(), np.asarray(want)), op
    wlo = rng.integers(0, n, 700).astype(np.int32)
    whi = np.minimum(wlo + rng.integers(-1, 10, 700), n).astype(np.int32)
    val = rng.integers(0, 700, 700).astype(np.int32)
    val[::3] = JR.INT32_POS                             # uncommitted
    want = jax_cover(n, jnp.asarray(wlo), jnp.asarray(whi),
                     jnp.asarray(val), span)
    got = G.ss_cover_plain(n, t(wlo), t(whi), t(val), span)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # one fixpoint application: the cover, then the reads' min over it
    want = jax_direct_range_op(want, jnp.asarray(lo), jnp.asarray(hi),
                               op="min", span=span)
    got = G.ss_apply(n, t(wlo), t(whi), t(val), t(lo), t(hi), span)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the group kernel under short_span_limit

@functools.lru_cache(maxsize=None)
def jax_group(ss: int):
    return jax.jit(functools.partial(JG.resolve_group, short_span_limit=ss))


def point_txn(rng, lo=0, hi=40):
    """tests/test_group_parity.py's point workload: one-byte keys, [k,
    k + b"\\x01") reads and writes."""
    k = bytes([int(rng.integers(lo, hi))])
    k2 = bytes([int(rng.integers(lo, hi))])
    return CommitTransaction(
        read_conflict_ranges=[(k, k + b"\x01")],
        write_conflict_ranges=[(k2, k2 + b"\x01")],
        read_snapshot=int(rng.integers(900, 1100 + 100 * rng.integers(1, 3))),
    )


def point_group(rng, gn, base=1000, n_txns=10):
    return [packing.pack_batch([point_txn(rng) for _ in range(n_txns)],
                               base + (i + 1) * 100, 0, TCFG)
            for i in range(gn)]


def run_port(batches, ss, pre=()):
    """The group through the port's group kernel after `pre` groups:
    (state, out)."""
    ts = H.init(TCFG, "cpu")
    for grp in list(pre) + [batches]:
        stacked = packing.stack_device_args(grp)
        ts, to = G.resolve_group(
            ts, interop.device_args_to_torch(stacked, "cpu"),
            short_span_limit=ss)
    return ts, to


def run_both(batches, ss, pre=()):
    """The group through both packages after `pre` groups (each through
    the same group kernel on both sides). Returns ((jax state, out),
    (port state, out))."""
    js = JH.init(JCFG)
    for grp in list(pre) + [batches]:
        js, jo = jax_group(ss)(js, packing.stack_device_args(grp))
    return (js, jo), run_port(batches, ss, pre)


@pytest.mark.parametrize("ss", [2, 4, 8])
@pytest.mark.parametrize("gn", [1, 2, 8])
def test_short_span_group_matches_jax(gn, ss):
    rng = np.random.default_rng(10 * gn + ss)
    pre = [point_group(rng, 2, base=400)]
    batches = point_group(rng, gn)
    (js, jo), (ts, to) = run_both(batches, ss, pre=pre)
    assert_same_out(to, jo, f"G={gn} S={ss}:")
    assert_same_state(ts, js)
    assert not bool(to.overflow.any()), "the point workload must not trip"
    # and the same decisions and history as the general path
    te, teo = run_port(batches, 0, pre=pre)
    for f in G.GroupVerdict._fields:
        assert torch.equal(getattr(to, f), getattr(teo, f)), f
    assert torch.equal(ts.main_keys, te.main_keys)
    assert torch.equal(ts.main_ver, te.main_ver)


def wide_read_batch(version=1100):
    """tests/test_group_parity.py:326-343: one read over many keys."""
    return packing.pack_batch([CommitTransaction(
        read_conflict_ranges=[(b"\x00", b"\x30")],
        write_conflict_ranges=[(bytes([i]), bytes([i]) + b"\x01")
                               for i in range(12)],
        read_snapshot=1000)], version, 0, TCFG)


def wide_write_batch(version=1100):
    """A write over many point reads of its batch: its local span > S."""
    txns = [CommitTransaction([(bytes([i]), bytes([i]) + b"\x01")], [],
                              read_snapshot=1000) for i in range(8)]
    txns.append(CommitTransaction([], [(b"\x00", b"\x30")],
                                  read_snapshot=1000))
    return packing.pack_batch(txns, version, 0, TCFG)


def block_trip_group():
    """A tier at 0x10, 0x11, 0x12, 0x13 and a group of 2 whose batch-1
    read [0x0f, 0x13) spans 4 point ranks (its begin and batch 0's points
    0x10 01, 0x10 02, 0x11 05) and 3 tier segments, each within S = 4,
    but 7 of the JAX co-sort's blocks (the 4 point keys and the tier keys
    0x10, 0x11, 0x12): JAX's cross latch refuses it."""
    T = CommitTransaction
    pre = [packing.pack_batch([T([], [(b"\x10", b"\x11")], read_snapshot=0),
                               T([], [(b"\x12", b"\x13")], read_snapshot=0)],
                              900, 0, TCFG)]
    b0 = packing.pack_batch([
        T([(b"\x11\x05", b"\x20")], [(b"\x10\x01", b"\x10\x02")],
          read_snapshot=950)], 1000, 0, TCFG)
    b1 = packing.pack_batch([
        T([(b"\x0f", b"\x13")], [(b"\x30", b"\x31")], read_snapshot=950)],
        1100, 0, TCFG)
    return pre, [b0, b1]


def trip_case(case):
    """(groups before, the group) of a trip case."""
    if case == "blocks":
        pre, grp = block_trip_group()
        return [[pb] for pb in pre], grp
    return [], [wide_read_batch() if case == "wide read"
                else wide_write_batch()]


@pytest.mark.parametrize("case", ["wide read", "wide write", "blocks"])
def test_span_trips_match_jax(case):
    ss = 2 if case != "blocks" else 4
    pre, grp = trip_case(case)
    (js, jo), (ts, to) = run_both(grp, ss, pre=pre)
    assert bool(np.asarray(jo.overflow).all()), "JAX must trip"
    assert bool(to.overflow.all())
    assert_same_out(to, jo, case)
    assert_same_state(ts, js)
    if case == "blocks":
        # the port's own point ranks would have passed: only the block
        # count refuses this group, and each batch alone passes in both
        stacked = interop.device_args_to_torch(
            packing.stack_device_args(grp), "cpu")
        pts = torch.cat([stacked[k].reshape(-1, 3) for k in (
            "read_begin", "read_end", "write_begin", "write_end")])
        live = torch.cat([stacked["read_valid"].reshape(-1)] * 2
                         + [stacked["write_valid"].reshape(-1)] * 2)
        ranks, _, _ = K.sort_ranks(pts, live)
        nr = stacked["read_begin"].shape[0] * stacked["read_begin"].shape[1]
        read1 = KW["max_reads"]          # batch 1's first read
        assert int(ranks[nr + read1] - ranks[read1]) <= ss
        for pb in grp:
            (_, jo1), (_, to1) = run_both([pb], ss, pre=pre)
            assert not bool(to1.overflow.any())
            assert_same_out(to1, jo1, "one batch")


@pytest.mark.parametrize("case", ["wide read", "wide write", "blocks"])
def test_span_widths_are_the_latch_threshold(case):
    """span_widths reports the spans the latch holds to S: at S = the
    widest the group passes, one below it trips (no txn here is too old,
    so the packed validity is the latch's liveness)."""
    pre, grp = trip_case(case)
    state = H.init(TCFG, "cpu")
    for pg in pre:
        state, _ = G.resolve_group(state, interop.device_args_to_torch(
            packing.stack_device_args(pg), "cpu"))
    widths = G.span_widths(state, interop.device_args_to_torch(
        packing.stack_device_args(grp), "cpu"))
    assert ("blocks" in widths) == (len(grp) > 1)
    if case == "blocks":
        assert widths["blocks"] == 7 and widths["read"] <= 4
    top = max(widths.values())
    for ss, trips in ((top, False), (top - 1, True)):
        _, out = run_port(grp, ss, pre=pre)
        assert bool(out.overflow.any()) == trips, (widths, ss)


# ---------------------------------------------------------------------------
# the conflict set, classic, tiered and sharded

SET_KW = {**KW, "delta_capacity": 256, "compact_interval": 2}


def jax_set(kw, n_shards=0):
    if n_shards:
        return TpuConflictSet(JaxConfig(**kw), mesh=cpu_mesh(n_shards),
                              shard_boundaries=shard_splits(n_shards))
    return JCS.make_conflict_set(JaxConfig(**kw), "tpu-force")


def port_set(kw, n_shards=0):
    return make_conflict_set(
        KernelConfig(**kw), "cuda", device="cpu",
        shard_boundaries=shard_splits(n_shards) if n_shards else None)


def shard_splits(n):
    return [bytes([40 * (i + 1) // n]) for i in range(n - 1)]


def assert_fields(got, want, tag=""):
    for f in want._fields:
        assert np.array_equal(np_of(getattr(got, f)),
                              np_of(getattr(want, f))), f"{tag} {f}"


def jax_state_numpy(jcs):
    """The JAX set's state in store_state's leaf layout."""
    st = jcs.state
    if hasattr(st, "main"):
        return tuple([np.asarray(x) for x in tier] for tier in
                     (st.main, st.delta))
    return [np.asarray(x) for x in st]


def assert_set_state(port, jcs):
    got = port.store_state()[0]
    want = jax_state_numpy(jcs)
    tiers = ((got, want) if isinstance(got[0], (tuple, list))
             else ((got,), (want,)))
    for g_tier, w_tier in zip(*tiers):
        for name, a, b in zip(("keys", "ver", "oldest", "overflow"), g_tier,
                              w_tier):
            assert np.array_equal(np.asarray(a), np.asarray(b)), name


def point_stream(seed, n, base=1000):
    rng = np.random.default_rng(seed)
    return [packing.pack_batch([point_txn(rng) for _ in range(12)],
                               base + (i + 1) * 100, 0, TCFG)
            for i in range(n)]


#: the tiered profiles' knobs beside S (tests/test_torch_variants.py's
#: hot-key and range-scan configs), at unroll 1 so the latch trips
PROFILES = {
    "tiered latch + dedup": dict(fixpoint_latch=True, fixpoint_unroll=1,
                                 dedup_reads=16),
    "tiered sweep + spill": dict(range_sweep=True, delta_spill=True,
                                 fixpoint_latch=True, fixpoint_unroll=1),
}
COUNTERS = ("spills", "compactions", "latchTrips", "exactFallbacks",
            "sweepGroups")


@pytest.mark.parametrize("path", ["classic", "tiered", "2 shards",
                                  "4 shards", *PROFILES])
def test_conflict_set_short_span_matches_jax(path):
    n_shards = {"2 shards": 2, "4 shards": 4}.get(path, 0)
    kw = {**SET_KW, "short_span_limit": 4, "n_shards": n_shards,
          **PROFILES.get(path, {})}
    if path == "classic":
        kw["delta_capacity"] = 0
    port, jcs = port_set(kw, n_shards), jax_set(kw, n_shards)
    batches = point_stream(50 + n_shards + len(path), 9)
    if n_shards:   # a txn may merge on one shard and abort on another
        multi = MultiResolverOracle(shard_splits(n_shards),
                                    window=kw["window_versions"])

        def oracle_verdicts(txns, version):
            return multi.resolve([OracleTxn(
                t.read_conflict_ranges, t.write_conflict_ranges,
                t.read_snapshot, False) for t in txns], version).verdicts
    else:
        single = make_conflict_set(KernelConfig(**kw), "cpu")

        def oracle_verdicts(txns, version):
            return single.resolve(txns, version).verdicts
    for lo in range(0, 9, 3):
        stacked = packing.stack_device_args(batches[lo:lo + 3])
        got = port.resolve_group_args(stacked)
        assert_fields(got, jcs.resolve_group_args(stacked), f"{path} {lo}")
        assert_set_state(port, jcs)
        for i, pb in enumerate(batches[lo:lo + 3]):
            want = oracle_verdicts(txns_of(pb), int(pb.version))
            assert np_of(got.verdict[i])[:pb.n_txns].tolist() == [
                int(v) for v in want]
    if path == "tiered":   # resolve() per batch goes through the S path too
        for pb in point_stream(77, 2, base=2000):
            txns = txns_of(pb)
            got = port.resolve(txns, int(pb.version))
            want = jcs.resolve(txns, int(pb.version))
            assert [int(v) for v in got.verdicts] == [
                int(v) for v in want.verdicts]
            assert_set_state(port, jcs)
    port.check_overflow()
    jcs.check_overflow()
    for name in COUNTERS:
        assert port.metrics.counters.get(name) == jcs.metrics.counters.get(
            name), name
    if path in PROFILES:
        assert port.metrics.counters.get("latchTrips") > 0


@pytest.mark.parametrize("path", ["classic", "tiered", "2 shards"])
def test_conflict_set_span_trip_raises_with_jax(path):
    """A clean group, then a tripping one: both sets raise
    HistoryOverflowError at the check after the trip group, and not
    before. Classic: the G = 2 block-span group (its cross latch); the
    tiered paths resolve against the delta tier one batch at a time, so
    there the wide read trips."""
    n_shards = 2 if path == "2 shards" else 0
    kw = {**SET_KW, "short_span_limit": 4, "n_shards": n_shards}
    pre, grp = block_trip_group()
    if path == "classic":
        kw["delta_capacity"] = 0
    else:
        grp = [wide_read_batch()]
    port, jcs = port_set(kw, n_shards), jax_set(kw, n_shards)
    clean = packing.stack_device_args(pre)
    assert_fields(port.resolve_group_args(clean),
                  jcs.resolve_group_args(clean), "clean")
    port.check_overflow()
    jcs.check_overflow()
    trip = packing.stack_device_args(grp)
    got, want = port.resolve_group_args(trip), jcs.resolve_group_args(trip)
    assert_fields(got, want, "trip")
    assert bool(got.overflow.all())
    with pytest.raises(HistoryOverflowError):
        port.check_overflow()
    with pytest.raises(Exception, match="exceeded"):
        jcs.check_overflow()


def chain_and_wide_read_batch(version):
    """A conflict chain of depth 6 (t0 writes k0, t_i reads k_{i-1} and
    writes k_i: the fixpoint needs ~6 applications, so unroll 1 trips the
    fixpoint latch) and a read over all of the chain's keys (a local span
    of 12 ranks, over S = 4: the span latch trips too)."""
    def key(i):
        return b"k%d" % i

    txns = [CommitTransaction(
        [] if i == 0 else [(key(i - 1), key(i - 1) + b"\x00")],
        [(key(i), key(i) + b"\x00")], read_snapshot=version - 50)
        for i in range(6)]
    txns.append(CommitTransaction([(key(0), key(9))], [],
                                  read_snapshot=version - 50))
    return packing.pack_batch(txns, version, 0, TCFG)


@pytest.mark.parametrize("path", ["classic", "tiered"])
def test_fixpoint_and_span_latches_trip_together_as_in_jax(path):
    """Both latches on one group. Raw (check_latch=False): `unconverged`,
    `overflow`, every field and the state as JAX returns them. Checked:
    the exact fallback keeps S, so its span latch sets `overflow` as
    JAX's does, and both sets raise."""
    kw = {**SET_KW, "short_span_limit": 4, "fixpoint_latch": True,
          "fixpoint_unroll": 1, "compact_interval": 0}
    if path == "classic":
        kw["delta_capacity"] = 0
    stacked = packing.stack_device_args(
        [chain_and_wide_read_batch(v) for v in (1100, 1200)])
    port_raw, jax_raw = port_set(kw), jax_set(kw)
    raw = port_raw.resolve_group_args(stacked, check_latch=False)
    jraw = jax_raw.resolve_group_args(stacked, check_latch=False)
    assert_fields(raw, jraw, "raw")
    assert np_of(raw.unconverged).all()
    assert np.array_equal(np_of(raw.overflow), np.asarray(jraw.overflow))
    assert_set_state(port_raw, jax_raw)

    port, jcs = port_set(kw), jax_set(kw)
    got, want = port.resolve_group_args(stacked), jcs.resolve_group_args(
        stacked)
    assert_fields(got, want, "fallback")
    assert not np_of(got.unconverged).any()
    assert np_of(got.overflow).all()
    assert_set_state(port, jcs)
    for name in ("latchTrips", "exactFallbacks"):
        assert port.metrics.counters.get(name) == 1, name
        if path == "tiered":   # JAX's classic dispatch counts no trip
            assert jcs.metrics.counters.get(name) == 1, name
    with pytest.raises(HistoryOverflowError):
        port.check_overflow()
    with pytest.raises(Exception, match="exceeded"):
        jcs.check_overflow()
