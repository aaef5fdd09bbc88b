"""Kernel D's yardstick on the inputs its tiled design finds hard.

On the card `merge_maps` is one launch of `mm_merge` (kernels/csrc/
merge_maps.cu), held bit for bit to `merge_maps_plain`. These CPU tests
hold that plain version, and the paths that run it, to an independent
reference and to the JAX package, on the shapes of the kernel's tiles
(1,024 or 2,048 merged positions) and on keys that repeat for hundreds of rows:

* `merge_maps_plain` on every case of `testing/merge_cases` (live rows
  at 0, 1, 2,047, 2,048 and 2,049 a map, all-sentinel maps, a 5,000-row
  run across two tile edges, keys shared at every edge, the coverage's
  own runs, duplicate keys in A, every value under the floor, a capacity
  under the count) at W = 3 and 5, against a straightforward walk over
  the union of the keys in Python; the cases of 600,000 rows and more
  (`large ...`, past which the kernel takes its large tiles) are the
  card's, and here only their shapes are checked;
* the port's `ops/delta.compact` against JAX `compact`
  (foundationdb_tpu/ops/delta.py:378) at tiers of 4,095, 4,096, 4,097 and
  8,193 rows with shared keys, redundant rows, NEG segments and a floor
  that GCs some, and at a capacity the fold overflows;
* a tiered stream one batch at a time and a classic group of 8 through
  `TorchConflictSet` against JAX `TpuConflictSet`, where most writes of
  every batch end (or begin) at one key, so each batch's coverage holds
  runs of hundreds of rows of it; keys over the bytes {0x00, 0x01, 0x7F,
  0x80, 0xFF} (tests/test_torch_lex_order.py's generator).

Every output is an integer or a bool: the tolerance is equality.
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
from foundationdb_tpu_torch import interop, make_conflict_set
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.ops import delta as D
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.testing import merge_cases as MC
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import packing

from test_torch_group import assert_same_out
from test_torch_lex_order import history_maps, wide_key

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

NEG = H.VERSION_NEG


def t(a) -> torch.Tensor:
    return interop.to_torch(np.asarray(a), "cpu")


def merge_reference(a_keys, a_val, b_keys, b_val, floor, capacity):
    """The canonical merge walked key by key over the union of the two
    maps' real keys: the value in force is each map's last row at or
    before the key, their max, NEG under the floor; a key is kept where
    that value differs from the previous key's. Returns (keys [cap, W]
    int32, ver [cap] int32, count)."""
    w = a_keys.shape[1]

    def rows(keys):
        return [tuple(int(x) for x in r) for r in keys.view(np.uint32)]

    ra, rb = rows(a_keys), rows(b_keys)
    union = sorted({k for k in ra + rb if k[-1] != MC.SENT})
    ia = ib = 0
    va = vb = prev = NEG
    out = []
    for k in union:
        while ia < len(ra) and ra[ia] <= k:
            va, ia = int(a_val[ia]), ia + 1
        while ib < len(rb) and rb[ib] <= k:
            vb, ib = int(b_val[ib]), ib + 1
        v = max(va, vb)
        v = NEG if v < floor else v
        if v != prev:
            out.append((k, v))
        prev = v
    keys = np.full((capacity, w), MC.SENT, np.uint32)
    ver = np.full((capacity,), NEG, np.int32)
    for i, (k, v) in enumerate(out[:capacity]):
        keys[i], ver[i] = k, v
    return keys.view(np.int32), ver, len(out)


@pytest.mark.parametrize("w", [3, 5])
@pytest.mark.parametrize("name", [n for n in MC.NAMES
                                  if not n.startswith("large")])
def test_merge_maps_plain_matches_reference(name, w):
    c = MC.case(name, w)
    keys, ver, count = H.merge_maps_plain(
        t(c.a_keys), t(c.a_val), t(c.b_keys), t(c.b_val), floor=c.floor,
        capacity=c.capacity)
    want = merge_reference(*c)
    assert np.array_equal(keys.numpy(), want[0])
    assert np.array_equal(ver.numpy(), want[1])
    assert count.dtype == torch.int64 and count.shape == ()
    assert int(count) == want[2]
    if name == "capacity under the count":
        assert want[2] > c.capacity
    if name in ("all under the floor", "all sentinel", "live 0+0"):
        assert want[2] == 0


@pytest.mark.parametrize("prefix", ["", "large "])
def test_merge_cases_reach_the_tile_edges(prefix):
    """The cases hold what their names say: the long run crosses two tile
    edges of the merged order, a pair of equal keys straddles every edge,
    and the coverage repeats its hot key for hundreds of rows; the
    `large` variants keep those edges and pass BIG_TILE_R real rows, so
    that the kernel takes its large tiles there."""
    def real(keys):
        return int((keys.view(np.uint32)[:, -1] != MC.SENT).sum())

    c = MC.case(prefix + "run 5000")
    b = c.b_keys.view(np.uint32)
    hot = MC.table(np.array([500_000]), 1, 3).view(np.uint32)[0]
    run = np.flatnonzero((b == hot).all(axis=1))
    a_before = int((c.a_keys.view(np.uint32)[:, 1] < hot[1]).sum())
    first, last = a_before + run[0], a_before + run[-1]
    assert run.shape[0] == 5_000 and first // MC.TILE + 2 <= last // MC.TILE
    if prefix:
        assert real(c.a_keys) + real(c.b_keys) > MC.BIG_TILE_R
        assert c.capacity > real(c.a_keys) + real(c.b_keys) + MC.TILE
    c = MC.case(prefix + "shared at every edge")
    a, b = c.a_keys.view(np.uint32)[:, 1], c.b_keys.view(np.uint32)[:, 1]
    merged = np.sort(np.concatenate([a, b]), kind="stable")
    n = 2 * (3 * MC.TILE // 2 + 5)   # the shared keys' merged positions
    for edge in range(MC.TILE, n, MC.TILE):
        assert merged[edge - 1] == merged[edge]
    if prefix:
        assert real(c.a_keys) + real(c.b_keys) > MC.BIG_TILE_R
    c = MC.case(prefix + "capacity under the count")
    if prefix:
        assert real(c.a_keys) + real(c.b_keys) > MC.BIG_TILE_R
        assert merge_reference(*c)[2] > c.capacity > MC.PAD // 2
    if not prefix:
        c = MC.case("coverage runs")
        _, counts = np.unique(c.b_keys.view(np.uint32), axis=0,
                              return_counts=True)
        assert counts.max() >= 700


_JAX_COMPACT = jax.jit(JD.compact)


@pytest.mark.parametrize("m,overflows", [(4_095, False), (4_096, False),
                                         (4_097, False), (8_193, False),
                                         (4_096, True)])
def test_compact_matches_jax_at_tile_sizes(m, overflows):
    """K9 at tiers about kernel D's tiles: main and delta share keys (one
    keyspace of 2 m keys), carry redundant rows and NEG segments, and the
    floor GCs the lowest values; at `overflows` main is nearly full and
    delta's keys mostly new, so the fold needs more rows than main
    holds."""
    rng = np.random.default_rng(m + overflows)
    keyspace = 40 * m if overflows else 2 * m
    n_main, n_delta = (m - 20, m - 10) if overflows else (3 * m // 5, m // 3)
    oldest = 1_500
    delta_val = MC.values(rng, n_delta, m, 2_000, 6_000)
    if not overflows:   # interval ends, as coverage leaves them
        delta_val[1:n_delta:2] = NEG
    main = (MC.table(MC.draw(rng, n_main, keyspace), m, 3),
            MC.values(rng, n_main, m, oldest if overflows else 0, 5_000))
    delta = (MC.table(MC.draw(rng, n_delta, keyspace), m, 3), delta_val)
    j_state = JD.TieredState(
        main=JH.VersionHistory(jnp.asarray(main[0].view(np.uint32)),
                               jnp.asarray(main[1]), jnp.int32(oldest),
                               jnp.asarray(False)),
        delta=JH.VersionHistory(jnp.asarray(delta[0].view(np.uint32)),
                                jnp.asarray(delta[1]), jnp.int32(oldest),
                                jnp.asarray(False)))
    want = _JAX_COMPACT(j_state)
    got = D.compact(interop.tiered_state_from_numpy(
        (*main, oldest, False), (*delta, oldest, False), "cpu"))
    for tier, jtier in ((got.main, want.main), (got.delta, want.delta)):
        assert np.array_equal(tier.main_keys.numpy().view(np.uint32),
                              np.asarray(jtier.main_keys))
        assert np.array_equal(tier.main_ver.numpy(),
                              np.asarray(jtier.main_ver))
        assert bool(tier.overflow) == bool(jtier.overflow)
    assert bool(want.main.overflow) == overflows


#: key bytes of the streams (tests/test_torch_lex_order.py's width)
MKB = 8
HOT = b"\x7f\x80\x01"
STREAM_KW = dict(max_key_bytes=MKB, max_txns=256, max_reads=256,
                 max_writes=512, history_capacity=4096, window_versions=1000)


def hot_stream(rng, n_batches, base=1000, step=100, n_txns=240):
    """Batches whose writes mostly end at HOT (a begin drawn below it) or
    begin there: each batch's coverage holds hundreds of rows of HOT."""
    def write():
        r = rng.random()
        if r < 0.6:
            lo = wide_key(rng, MKB - 1)
            return (lo if lo < HOT else b"", HOT)
        if r < 0.8:
            hi = wide_key(rng, MKB - 1)
            return (HOT, hi if hi > HOT else HOT + b"\x00")
        a, b = wide_key(rng, MKB - 1), wide_key(rng, MKB - 1)
        return (min(a, b), max(a, b) + b"\x00")

    def read():
        a, b = wide_key(rng, MKB - 1), wide_key(rng, MKB - 1)
        return (min(a, b), max(a, b) + b"\x00")

    out = []
    for i in range(n_batches):
        version = base + (i + 1) * step
        txns = [CommitTransaction(
            read_conflict_ranges=[] if rng.random() < 0.2 else [read()],
            write_conflict_ranges=[write() for _ in range(
                1 + int(rng.random() < 0.5))],
            read_snapshot=int(rng.integers(max(0, base - 2 * step),
                                           version)))
            for _ in range(n_txns)]
        out.append(packing.pack_batch(txns, version, 0,
                                      KernelConfig(**STREAM_KW)))
    return out


def hot_rows(pb) -> int:
    """Write-end rows of one batch equal to HOT, the run its coverage
    carries (begins at HOT add to it)."""
    hot = packing.pack_key(HOT, MKB)
    args = pb.device_args()
    live = args["write_valid"]
    return int(((args["write_end"] == hot).all(axis=1) & live).sum())


@pytest.mark.parametrize("tiered", [True, False], ids=["tiered", "classic"])
def test_long_coverage_runs_match_jax(tiered):
    """The tiered set one batch at a time (a compaction every 2), or the
    classic set in a group of 8, against JAX TpuConflictSet: every field
    of every batch, and the tiers' canonical maps after each."""
    kw = dict(STREAM_KW, delta_capacity=2048, compact_interval=2) \
        if tiered else STREAM_KW
    jax_cs = JCS.make_conflict_set(JaxConfig(**kw), "tpu-force")
    port = make_conflict_set(KernelConfig(**kw), "cuda", device="cpu")
    rng = np.random.default_rng(90 + tiered)
    batches = hot_stream(rng, 8)
    assert min(hot_rows(pb) for pb in batches) >= 150
    if tiered:
        for i, pb in enumerate(batches):
            assert_same_out(port.resolve_packed(pb),
                            jax_cs.resolve_packed(pb), f"batch {i}:")
            got_maps, want_maps = history_maps(port, jax_cs)
            assert got_maps == want_maps, f"batch {i}"
    else:
        stacked = packing.stack_device_args(batches)
        got = port.resolve_group_args(stacked)
        assert_same_out(got, jax_cs.resolve_group_args(stacked))
        got_maps, want_maps = history_maps(port, jax_cs)
        assert got_maps == want_maps
        assert int(got.committed_count.sum()) > 0
