"""The multi-resolver sharded path of the port (K18), held against the JAX
package on the CPU.

The port's plain PyTorch path (CPU tensors) and the JAX package run the
same seeded inputs; every output is an integer or a bool, so the
tolerance is equality (0 differences) throughout:

* kernel I's function, `clip_batch` / `clip_batch_plain`, against JAX
  `clip_batch` vmapped over the group, on every shard: ranges that
  straddle a boundary, touch lo or hi exactly, are empty, inverted or
  dead, txns whose reads all lie on other shards, keys with the high bit
  set, and the last shard's sentinel hi;
* kernel J's function, `combine_plain`, against a numpy statement of the
  JAX pmin / psum / pmax rules;
* the classic `ShardedConflictSet` against JAX `ShardedConflictSet` at
  S in {2, 4}: `resolve` and `resolve_group`, every field, each shard's
  tier after every step;
* `TorchConflictSet(n_shards = S)` against JAX `TpuConflictSet` on the
  virtual CPU mesh (tests/conftest.py gives 8 devices) at S in {2, 4, 8}:
  exact, latch + dedup (with a group that trips on one shard only, where
  every shard must keep its tiers and the exact fallback runs) and sweep
  + spill, every field and each shard's tiers after every group, and a
  JAX sharded state carried in and out mid-stream;
* compaction cadence, rebase, per-shard overflow, a degenerate partition
  against the single-device port, and both sets against the port's
  `MultiResolverOracle` (itself held to the JAX one).

One exception, as in the contract: the verdicts of a tripped (latched)
group are never compared; what must match is `unconverged`, the
unchanged state and, after the fallback, every field.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.config import KernelConfig as JaxConfig
from foundationdb_tpu.models.conflict_set import TpuConflictSet
from foundationdb_tpu.parallel import sharding as JSH
from foundationdb_tpu.parallel.mesh import cpu_mesh
from foundationdb_tpu.testing.oracle import (
    MultiResolverOracle as JaxMultiResolverOracle,
)
from foundationdb_tpu_torch import HistoryOverflowError, interop
from foundationdb_tpu_torch import make_conflict_set
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.models.conflict_set import REBASE_THRESHOLD
from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.ops import delta as D
from foundationdb_tpu_torch.parallel import sharding as SH
from foundationdb_tpu_torch.testing.oracle import (
    MultiResolverOracle,
    OracleTxn,
)
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import packing

from conftest import random_range

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

BASE_KW = dict(max_key_bytes=8, max_txns=16, max_reads=32, max_writes=32,
               history_capacity=512, window_versions=400,
               delta_capacity=256, compact_interval=1)


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x)


def even_boundaries(n: int) -> list:
    """Splits inside conftest.random_range's alphabet (bytes 0..3), so
    every shard sees traffic; at 8 shards the odd splits bisect each
    first-byte bucket."""
    if n <= 4:
        return [bytes([(4 * (i + 1)) // n]) for i in range(n - 1)]
    return [bytes([i // 2, 2]) if i % 2 else bytes([i // 2])
            for i in range(1, n)]


def random_txn(rng, snap_lo, snap_hi):
    reads = [] if rng.random() < 0.15 else [
        random_range(rng) for _ in range(1 + int(rng.integers(0, 2)))]
    writes = [random_range(rng) for _ in range(1 + int(rng.integers(0, 2)))]
    return CommitTransaction(reads, writes,
                             read_snapshot=int(rng.integers(snap_lo, snap_hi)),
                             report_conflicting_keys=bool(rng.random() < 0.5))


def gen_stream(rng, n_batches, *, base=1000, step=100, n_txns=10) -> list:
    """[(txns, version)]; snapshots reach below the window's floor."""
    return [([random_txn(rng, base - 2 * step, base + (i + 1) * step)
              for _ in range(n_txns)], base + (i + 1) * step)
            for i in range(n_batches)]


def to_oracle(txns) -> list:
    return [OracleTxn(t.read_conflict_ranges, t.write_conflict_ranges,
                      t.read_snapshot, t.report_conflicting_keys)
            for t in txns]


def port_set(kw, boundaries):
    return make_conflict_set(KernelConfig(**kw), "cuda", device="cpu",
                             shard_boundaries=boundaries)


def jax_set(kw, boundaries):
    return TpuConflictSet(JaxConfig(**kw), mesh=cpu_mesh(kw["n_shards"]),
                          shard_boundaries=boundaries)


def assert_fields(got, want):
    for f in want._fields:
        assert np.array_equal(np_of(getattr(got, f)),
                              np.asarray(getattr(want, f))), f


def assert_tiers_equal(got_tiers, want_tiers):
    """Leaf lists (keys, ver, oldest, overflow), each with or without a
    leading shard axis, equal."""
    for tier, (got, want) in enumerate(zip(got_tiers, want_tiers)):
        for name, a, b in zip(("keys", "ver", "oldest", "overflow"), got,
                              want):
            assert np.array_equal(np.asarray(a), np.asarray(b)), (tier, name)


def assert_sharded_state(port, jax_cs):
    """Each shard's main and delta tiers, row for row, in the JAX stacked
    layout."""
    got = port.store_state()[0]
    assert_tiers_equal(got, ([np.asarray(x) for x in jax_cs.state.main],
                             [np.asarray(x) for x in jax_cs.state.delta]))


def packed_stream(stream, cfg) -> list:
    return [packing.pack_batch(t, v, 0, cfg) for t, v in stream]


# ---------------------------------------------------------------------------
# kernel I: the clip

CLIP_PARTS = {
    "one shard": [],
    "high bit": [b"\x80"],
    "four": [b"\x01", b"\x02", b"\x80\x00\x01"],
    "eight": even_boundaries(8),
}


def clip_group(rng, cfg, boundaries, gn=3):
    """A stacked group whose ranges come from a pool of edge keys: the
    boundaries themselves, b"", keys beside them, keys with the high bit
    set, the longest key; ends drawn independently of begins, so ranges
    straddle, touch, come out empty or inverted. Some txns read only
    below the first boundary, some are blind; one read per batch is dead
    with live-looking keys (its txn's only read)."""
    pool = [b"", b"\x00", b"\x01", b"\x01\x00", b"\x02", b"\x03\xff",
            b"\x7f\xff\xff\xff", b"\x80", b"\x80\x00", b"\x80\x00\x01",
            b"\xfe", b"\xff", b"\xff" * 8] + list(boundaries)
    pool += [bytes(rng.integers(0, 256, size=int(rng.integers(1, 9)),
                                dtype=np.uint8)) for _ in range(8)]

    def key():
        return pool[int(rng.integers(0, len(pool)))]

    batches = []
    for i in range(gn):
        txns = []
        for t in range(12):
            kind = t % 4
            reads = ([] if kind == 3 else
                     [(b"\x00", b"\x00\x01")] if kind == 2 else
                     [(key(), key()) for _ in range(2)])
            txns.append(CommitTransaction(
                reads, [(key(), key())], read_snapshot=100 + i))
        pb = packing.pack_batch(txns, 200 + 10 * i, 0, cfg)
        # the first read of txn 2 (its only one) dead, keys left live
        pb.read_valid[int(np.flatnonzero(pb.read_txn == 2)[0])] = False
        batches.append(pb)
    return packing.stack_device_args(batches)


_JAX_CLIP = jax.jit(jax.vmap(JSH.clip_batch, in_axes=(0, None, None)))


@pytest.mark.parametrize("part", sorted(CLIP_PARTS))
def test_clip_batch_matches_jax(part):
    boundaries = CLIP_PARTS[part]
    cfg = KernelConfig(**{**BASE_KW, "max_reads": 32})
    rng = np.random.default_rng(len(boundaries))
    stacked = clip_group(rng, cfg, boundaries)
    lo, hi = SH.make_partition(boundaries, cfg)
    g = interop.device_args_to_torch(stacked, "cpu")
    got = SH.clip_batch(g, interop.to_torch(lo, "cpu"),
                        interop.to_torch(hi, "cpu"))
    jg = {k: jnp.asarray(v) for k, v in stacked.items()}
    survived = 0
    for s in range(len(boundaries) + 1):
        want = _JAX_CLIP(jg, jnp.asarray(lo[s]), jnp.asarray(hi[s]))
        for k in SH.CLIPPED:
            a = np_of(got[k][s])
            b = np.asarray(want[k])
            if a.dtype == np.int32:
                a = a.view(np.uint32)
            assert np.array_equal(a, b), (s, k)
        survived += int(np.asarray(want["read_valid"]).sum())
        # the txn whose only read is dead never has reads
        assert not np_of(got["has_reads"][s])[:, 2].any()
    # each live non-empty read survives on at least one shard
    assert survived >= int(stacked["read_valid"].sum()) // 2


def test_clip_keeps_boundary_ranges_whole():
    """[k, hi) stays whole on the lower shard, [hi, e) goes whole to the
    upper one, empty and inverted ranges drop everywhere."""
    cfg = KernelConfig(**BASE_KW)
    bnd = b"\x02"
    txns = [CommitTransaction([(b"\x01", bnd)], [(bnd, b"\x03")],
                              read_snapshot=0),
            CommitTransaction([(b"\x01", b"\x01")], [(b"\x03", b"\x01")],
                              read_snapshot=0)]
    g = interop.device_args_to_torch(packing.stack_device_args(
        [packing.pack_batch(txns, 10, 0, cfg)]), "cpu")
    lo, hi = SH.partition_tensors([bnd], cfg, "cpu")
    out = SH.clip_batch(g, lo, hi)
    rv, wv = np_of(out["read_valid"]), np_of(out["write_valid"])
    assert rv[:, 0, :2].tolist() == [[True, False], [False, False]]
    assert wv[:, 0, :2].tolist() == [[False, False], [True, False]]
    assert np.array_equal(np_of(out["read_end"][0, 0, 0]),
                          np_of(g["read_end"][0, 0]))
    assert np_of(out["has_reads"])[:, 0, :2].tolist() == [[True, False],
                                                          [False, False]]


# ---------------------------------------------------------------------------
# kernel J: the combine

@pytest.mark.parametrize("s", [1, 2, 5])
def test_combine_plain_matches_numpy_rules(s):
    rng = np.random.default_rng(s)
    gn, b, nr = 3, 40, 70
    verdict = rng.choice([0, 1, 3], size=(s, gn, b), p=[0.3, 0.1, 0.6])
    first = rng.integers(-1, nr, size=(s, gn, b))
    first[rng.random((s, gn, b)) < 0.5] = -1
    hist = rng.random((s, gn, nr)) < 0.1
    overflow = rng.random((s, gn)) < 0.2
    trip = rng.random(s) < 0.3
    valid = rng.random((gn, b)) < 0.8
    args = [torch.from_numpy(x) for x in (
        verdict.astype(np.int32), first.astype(np.int32), hist, overflow,
        trip, valid)]
    got = SH.combine(*args)
    v = verdict.min(axis=0)
    f = np.where(first < 0, 2**31 - 1, first).min(axis=0)
    want = dict(
        verdict=v, hist_conflict_read=hist.sum(axis=0) > 0,
        intra_first_range=np.where(f == 2**31 - 1, -1, f),
        committed_count=((v == 3) & valid).sum(axis=1),
        conflict_count=((v == 0) & valid).sum(axis=1),
        too_old_count=((v == 1) & valid).sum(axis=1),
        overflow=overflow.max(axis=0), trip=np.asarray(trip.max()))
    for k, w in want.items():
        assert np.array_equal(np_of(getattr(got, k)), w), k
    assert got.verdict.dtype == torch.int32
    assert got.committed_count.dtype == torch.int32


# ---------------------------------------------------------------------------
# the classic ShardedConflictSet

@pytest.mark.parametrize("n_shards", [2, 4])
def test_classic_sharded_matches_jax_and_oracle(n_shards):
    boundaries = even_boundaries(n_shards)
    kw = {**BASE_KW, "delta_capacity": 0}
    port = SH.ShardedConflictSet(KernelConfig(**kw), boundaries,
                                 device="cpu")
    jcs = JSH.ShardedConflictSet(JaxConfig(**kw), cpu_mesh(n_shards),
                                 boundaries)
    oracle = MultiResolverOracle(boundaries, window=kw["window_versions"])
    stream = gen_stream(np.random.default_rng(40 + n_shards), 6)

    def same_tiers():
        got = [np.stack([np_of(getattr(h, f)) for h in port.state])
               for f in ("main_keys", "main_ver")]
        assert np.array_equal(got[0].view(np.uint32),
                              np.asarray(jcs.state.main_keys))
        assert np.array_equal(got[1], np.asarray(jcs.state.main_ver))
        assert [h.oldest for h in port.state] == np.asarray(
            jcs.state.oldest).tolist()

    for txns, version in stream[:3]:
        got = port.resolve(txns, version)
        assert_fields(got, jcs.resolve(txns, version))
        same_tiers()
        want = oracle.resolve(to_oracle(txns), version).verdicts
        assert np_of(got.verdict)[:len(txns)].tolist() == want
    batches = [t for t, _ in stream[3:]]
    versions = [v for _, v in stream[3:]]
    got = port.resolve_group(batches, versions)
    assert_fields(got, jcs.resolve_group(batches, versions))
    same_tiers()
    for i, (txns, version) in enumerate(stream[3:]):
        want = oracle.resolve(to_oracle(txns), version).verdicts
        assert np_of(got.verdict[i])[:len(txns)].tolist() == want
    port.check_overflow()


def test_classic_sharded_overflow_raises():
    kw = {**BASE_KW, "delta_capacity": 0, "history_capacity": 4}
    port = SH.ShardedConflictSet(KernelConfig(**kw), [b"\x02"],
                                 device="cpu")
    txns = [CommitTransaction([], [(bytes([4 + 2 * i]), bytes([5 + 2 * i]))],
                              read_snapshot=50) for i in range(8)]
    with pytest.raises(HistoryOverflowError):
        port.resolve(txns, 100)
    with pytest.raises(HistoryOverflowError):
        port.check_overflow()


# ---------------------------------------------------------------------------
# the tiered sharded conflict set against the JAX mesh kernel

CONFIGS = {
    "exact": {},
    # dedup 4 of 64 read rows: the trip group below reads 40 distinct
    # ranges, all on shard 0
    "latch + dedup": {"fixpoint_latch": True, "fixpoint_unroll": 2,
                      "dedup_reads": 4, "max_reads": 64},
    "sweep + spill": {"range_sweep": True, "delta_spill": True,
                      "fixpoint_latch": True, "fixpoint_unroll": 4,
                      "compact_interval": 0},
}


def shard0_trip_batch(rng):
    """16 txns, 40 distinct reads below every test partition's first
    boundary (b"\\x00\\x01..."), writes anywhere."""
    txns = []
    for t in range(16):
        reads = [(b"\x00\x01" + bytes([t, j]), b"\x00\x01" + bytes([t, j, 1]))
                 for j in range(2 + (t % 3 == 0))]
        txns.append(CommitTransaction(reads, [random_range(rng)],
                                      read_snapshot=1000))
    return txns


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_tiered_matches_jax(n_shards, config):
    boundaries = even_boundaries(n_shards)
    kw = {**BASE_KW, "n_shards": n_shards, **CONFIGS[config]}
    cfg = KernelConfig(**kw)
    rng = np.random.default_rng(7 * n_shards + len(config))
    stream = gen_stream(rng, 9)
    latched = config == "latch + dedup"
    if latched:
        stream[0] = (shard0_trip_batch(rng), stream[0][1])
    batches = packed_stream(stream, cfg)
    groups = [packing.stack_device_args(batches[i:i + 3])
              for i in range(0, 9, 3)]
    port, jcs = port_set(kw, boundaries), jax_set(kw, boundaries)
    oracle = MultiResolverOracle(boundaries, window=kw["window_versions"])
    carried = dict.fromkeys(port.metrics.counters.as_dict(), 0)

    if latched:
        # the raw group: the trip on shard 0 refuses it on every shard
        raw_p, raw_j = port_set(kw, boundaries), jax_set(kw, boundaries)
        before = raw_p.store_state()[0]
        got = raw_p.resolve_group_args(groups[0], check_latch=False)
        want = raw_j.resolve_group_args(groups[0], check_latch=False)
        assert np_of(got.unconverged).all()
        assert np.asarray(want.unconverged).all()
        assert_tiers_equal(raw_p.store_state()[0], before)
        assert_sharded_state(raw_p, raw_j)

    for i, grp in enumerate(groups):
        got = port.resolve_group_args(grp)
        assert_fields(got, jcs.resolve_group_args(grp))
        assert_sharded_state(port, jcs)
        for j, (txns, version) in enumerate(stream[3 * i:3 * i + 3]):
            want = oracle.resolve(to_oracle(txns), version).verdicts
            assert np_of(got.verdict[j])[:len(txns)].tolist() == want
        if i == 0 and n_shards == 4:
            # carry the JAX sharded state into a fresh port set mid-stream
            fresh = port_set(kw, boundaries)
            fresh.load_state(
                ([np.asarray(x) for x in jcs.state.main],
                 [np.asarray(x) for x in jcs.state.delta]),
                jcs.base_version, jcs._batches_since_compact,
                jcs._spill_bound_rows)
            assert_sharded_state(fresh, jcs)
            carried, port = port.metrics.counters.as_dict(), fresh
    port.check_overflow()
    jcs.check_overflow()
    c = {k: n + carried[k] for k, n in port.metrics.counters.as_dict().items()}
    for name in ("spills", "latchTrips", "exactFallbacks", "sweepGroups"):
        assert c[name] == jcs.metrics.counters.get(name), name
    if latched:
        assert c["exactFallbacks"] >= 1
    if config == "sweep + spill":
        assert c["spills"] > 0 and c["sweepGroups"] == 3


def test_sharded_resolve_matches_oracle_with_reports_of_one_shard():
    """resolve() per batch at 2, 4 and 8 shards: verdicts identical to the
    port's MultiResolverOracle, which matches the JAX one verdict for
    verdict and report for report."""
    for n_shards in (2, 4, 8):
        boundaries = even_boundaries(n_shards)
        kw = {**BASE_KW, "n_shards": n_shards, "compact_interval": 2}
        cs = port_set(kw, boundaries)
        oracle = MultiResolverOracle(boundaries, window=kw["window_versions"])
        joracle = JaxMultiResolverOracle(boundaries,
                                         window=kw["window_versions"])
        n_conflict = 0
        for txns, version in gen_stream(np.random.default_rng(n_shards), 6):
            want = oracle.resolve(to_oracle(txns), version)
            jwant = joracle.resolve(to_oracle(txns), version)
            assert want.verdicts == jwant.verdicts
            assert want.conflicting_ranges == jwant.conflicting_ranges
            got = cs.resolve(txns, version)
            assert [int(v) for v in got.verdicts] == want.verdicts
            n_conflict += want.verdicts.count(0)
        assert n_conflict > 0
        assert cs.metrics.counters.get("compactions") == 3


def test_degenerate_partition_matches_single_device():
    """A boundary above every live key keeps all traffic on shard 0, so no
    phantom commit can happen: verdicts and conflict reports equal the
    single-device port's, and shard 1 stays empty."""
    kw = {**BASE_KW, "n_shards": 2}
    cs = port_set(kw, [b"\xf0\xf0\xf0"])
    single = make_conflict_set(KernelConfig(**{**kw, "n_shards": 0}), "cuda",
                               device="cpu")
    for txns, version in gen_stream(np.random.default_rng(5), 6):
        got, want = cs.resolve(txns, version), single.resolve(txns, version)
        assert got.verdicts == want.verdicts
        assert got.conflicting_key_ranges == want.conflicting_key_ranges
    cs.compact_history()
    single.compact_history()
    m_cnt, _ = D.boundary_counts_per_shard(cs.state)
    assert int(m_cnt[1]) == 0
    assert_tiers_equal(interop.tiered_state_to_numpy(cs.state[0]),
                       interop.tiered_state_to_numpy(single.state))


def canonical_map(keys, ver) -> list:
    rows = {}
    for k, v in zip(map(tuple, keys.tolist()), ver.tolist()):
        if all(x == 0xFFFFFFFF for x in k):
            continue
        rows[k] = v
    out = []
    for k in sorted(rows):
        if not out or out[-1][1] != rows[k]:
            out.append((k, rows[k]))
    return out


@pytest.mark.parametrize("interval", [2, 4, 0])
def test_compaction_cadence_invariance_per_shard(interval):
    """Decisions do not depend on when the shards fold delta into main,
    and after a final compaction each shard's map is the same."""
    stream = gen_stream(np.random.default_rng(42), 6)
    kw = {**BASE_KW, "n_shards": 2, "delta_capacity": 512}
    boundaries = even_boundaries(2)
    ref = port_set({**kw, "compact_interval": 1}, boundaries)
    cs = port_set({**kw, "compact_interval": interval}, boundaries)
    for txns, version in stream:
        assert ref.resolve(txns, version).verdicts == cs.resolve(
            txns, version).verdicts
    for x in (ref, cs):
        x.compact_history()
    _, d_cnt = D.boundary_counts_per_shard(cs.state)
    assert np_of(d_cnt).tolist() == [0, 0]
    mains = [x.store_state()[0][0] for x in (ref, cs)]
    for s in range(2):
        assert canonical_map(mains[0][0][s], mains[0][1][s]) == \
            canonical_map(mains[1][0][s], mains[1][1][s])


def test_sharded_rebase_matches_oracle():
    """The offset rebase shifts every shard's tiers: a cross-shard phantom
    write that survives the rebase still conflicts."""
    boundaries = [b"\x08"]
    kw = {**BASE_KW, "n_shards": 2, "window_versions": 1 << 33,
          "compact_interval": 0}
    k = lambda i: bytes([i])  # noqa: E731
    v0 = 1000
    far = v0 + REBASE_THRESHOLD + (1 << 21)
    stream = [
        ([CommitTransaction([], [(k(5), k(6))], read_snapshot=v0 - 1),
          CommitTransaction([], [(k(9), k(10))], read_snapshot=v0 - 1)], v0),
        ([CommitTransaction([(k(5), k(6))], [(k(9), k(10))],
                            read_snapshot=v0 - 1),
          CommitTransaction([(k(9), k(10))], [(k(11), k(12))],
                            read_snapshot=far - 1)], far),
    ]
    cs = port_set(kw, boundaries)
    oracle = MultiResolverOracle(boundaries, window=kw["window_versions"])
    for txns, version in stream:
        assert [int(v) for v in cs.resolve(txns, version).verdicts] == \
            oracle.resolve(to_oracle(txns), version).verdicts
    assert cs.metrics.counters.get("rebases") == 1
    assert cs.base_version > 0


def test_per_shard_overflow_survives_compaction_and_raises():
    """Writes aimed at shard 1 overflow only its delta tier; the latched
    flag folds into that shard's main across a compaction, and both the
    reply and check_overflow raise."""
    kw = {**BASE_KW, "n_shards": 2, "delta_capacity": 4,
          "compact_interval": 0}
    k = lambda i: bytes([i])  # noqa: E731
    txns = [CommitTransaction([], [(k(4 + 2 * i), k(5 + 2 * i))],
                              read_snapshot=50) for i in range(8)]
    cs = port_set(kw, [b"\x02"])
    batch = packing.pack_batch(txns, 100, 0, cs.config)
    cs.resolve_group_args(packing.stack_device_args([batch]),
                          check_latch=False)
    assert [bool(s.delta.overflow) for s in cs.state] == [False, True]
    cs.compact_history()
    assert not any(bool(s.delta.overflow) for s in cs.state)
    assert [bool(s.main.overflow) for s in cs.state] == [False, True]
    with pytest.raises(HistoryOverflowError):
        cs.check_overflow()
    with pytest.raises(HistoryOverflowError):
        port_set(kw, [b"\x02"]).resolve(txns, 100)


def test_sharded_metrics_and_store_layout():
    kw = {**BASE_KW, "n_shards": 4}
    cs = port_set(kw, even_boundaries(4))
    for txns, version in gen_stream(np.random.default_rng(17), 3):
        cs.resolve(txns, version)
    cs.check_overflow()
    m = cs.metrics.as_dict()
    assert m["shardCount"] == 4
    assert m["collectiveSeconds"]["count"] == 1
    assert m["mainLiveBoundaries"]["max"] > 0
    (main, delta), _ = cs.store_state()
    assert main[0].shape == (4, 512, 3) and main[0].dtype == np.uint32
    assert delta[1].shape == (4, 256) and main[2].shape == (4,)
    single = make_conflict_set(KernelConfig(**BASE_KW), "cuda", device="cpu")
    assert single.metrics.as_dict()["shardCount"] == 1


def test_sharded_config_validation():
    kw = {**BASE_KW, "n_shards": 2}
    with pytest.raises(ValueError, match="interior"):
        port_set(kw, [])
    with pytest.raises(ValueError, match="ascending"):
        port_set({**kw, "n_shards": 3}, [b"\x02", b"\x01"])
    with pytest.raises(ValueError, match="n_shards"):
        make_conflict_set(KernelConfig(**BASE_KW), "cuda", device="cpu",
                          shard_boundaries=[b"\x02"])
    with pytest.raises(ValueError):
        KernelConfig(**{**BASE_KW, "delta_capacity": 0, "n_shards": 2})
    assert SH.default_boundaries(4) == JSH.default_boundaries(4)
    cs = port_set({**kw, "n_shards": 4}, None)
    assert cs.shard_boundaries == JSH.default_boundaries(4)
