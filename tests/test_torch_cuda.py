"""The hand-written kernels on the card, held against their plain versions.

Marked `cuda`: every test needs a CUDA card and skips without one (the
check runs inside the `cuda_device` fixture, never at import). On the
card: `python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`
(this file needs nothing from tests/conftest.py, which imports JAX). The CPU
tests (test_torch_ops.py) pin the plain versions to the JAX package;
these pin each kernel to its plain version, exactly, and show that a
CUDA tensor launches the kernel (its count moves) instead of falling
back.
"""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch import interop, kernels, make_conflict_set
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.ops import delta as D
from foundationdb_tpu_torch.ops import group as G
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.ops import keys as K
from foundationdb_tpu_torch.ops import rangemax as R
from foundationdb_tpu_torch.ops import segtree as S
from foundationdb_tpu_torch.parallel import sharding as SH
from foundationdb_tpu_torch.testing import merge_cases as MC
from foundationdb_tpu_torch.testing import probe_cases as PC
from foundationdb_tpu_torch.testing import search_cases as SSC
from foundationdb_tpu_torch.testing import span_cases as SC
from foundationdb_tpu_torch.testing import writes_cases as WC
from foundationdb_tpu_torch.testing.benchgen import (
    int_keys_packed,
    skiplist_style_batch,
    ycsb_batch,
)
from foundationdb_tpu_torch.utils.packing import stack_device_args

pytestmark = pytest.mark.cuda

#: the kernels only the classic group kernel at G > 1 launches
CLASSIC_ONLY = ("rangemax2.build", "rangemax2.query", "seg_fold")
#: the kernels only the sharded path launches
SHARDED_ONLY = ("shard_clip", "shard_combine")
#: the kernels only the short-span variant launches
SHORT_SPAN_ONLY = ("short_span.range", "short_span.apply")
#: the kernels no resolver path launches (the reference's scripts' K16
#: and K19)
OFF_PATH = ("merge_writes", "rangemax4.build", "rangemax4.query",
            "rangemax4.cover")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.reset_counts()
    return torch.device("cuda")


def sorted_keys(rng, n, cap, dev):
    ks = np.unique(rng.integers(0, 1 << 20, size=n))
    table = np.full((cap, 3), 0xFFFFFFFF, np.uint32)
    table[: len(ks)] = int_keys_packed(ks, 8, 3)
    return torch.from_numpy(table.view(np.int32)).to(dev), len(ks)


def assert_launched_and_equal(name, got, want):
    assert kernels.COUNTS[name] > 0, name
    assert torch.equal(got, want), name


@pytest.mark.parametrize("side", ["left", "right"])
def test_search(cuda_device, side):
    rng = np.random.default_rng(1)
    keys, n = sorted_keys(rng, 5000, 6000, cuda_device)
    q = torch.cat([keys[rng.integers(0, n, 500)],
                   sorted_keys(rng, 500, 600, cuda_device)[0]])
    assert_launched_and_equal(
        "keysearch.search", K.searchsorted(keys, q, side=side),
        K.searchsorted_plain(keys, q, side=side))


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("m", [1, 3, 1000, 4095, 4096, 4097, 65_537,
                               262_144, 786_432])
def test_build_and_query(cuda_device, op, m):
    """Kernel B at sizes inside, at and past its 4,096-row tile, up to the
    fixpoint's 2^18 leaves and the tiers' 786,432 rows: one launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    vals = torch.randint(-10**9, 10**9, (m,), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    tab = R.build(vals, op=op)
    assert kernels.COUNTS["rangemax_build"] == 1
    assert_launched_and_equal("rangemax_build", tab,
                              R.build_plain(vals, op=op))
    lo = torch.randint(-2, m + 2, (3000,), generator=gen, device=cuda_device,
                       dtype=torch.int32)
    hi = torch.randint(-2, m + 2, (3000,), generator=gen, device=cuda_device,
                       dtype=torch.int32)
    assert_launched_and_equal("keysearch.query", R.query(tab, lo, hi, op=op),
                              R.query_plain(tab, lo, hi, op=op))


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("m", [1, 5, 1000, 4097, 262_144])
def test_query_at_every_depth(cuda_device, op, m):
    """Kernel A's query over kernel B's table at every depth 1 .. full
    (the fixpoint's is ops/group.FIXPOINT_LEVELS), one launch a call,
    exact against its plain version: reads of -3 .. 64 leaves, past both
    ends, and up to the whole range (past 2^L: the warp's long path)."""
    gen = torch.Generator(device=cuda_device).manual_seed(7 * m)

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen,
                             device=cuda_device, dtype=torch.int32)

    vals = ints(-10**9, 10**9, m)
    lo = torch.cat([ints(-3, m + 3, 3000), ints(-3, m // 2 + 1, 256)])
    hi = lo + torch.cat([ints(-3, 64, 3000), ints(0, m + 4, 256)])
    lo[:3], hi[:3] = 0, m   # the whole range, three to a warp
    for levels in range(1, R._num_levels(m) + 1):
        tab = R.build(vals, op=op, levels=levels)
        assert torch.equal(tab, R.build_plain(vals, op=op, levels=levels))
        before = kernels.COUNTS["keysearch.query"]
        got = R.query(tab, lo, hi, op=op)
        assert kernels.COUNTS["keysearch.query"] == before + 1
        assert torch.equal(got, R.query_plain(tab, lo, hi, op=op)), levels


@pytest.mark.parametrize("w", [3, 5])
@pytest.mark.parametrize("case", ["random", *PC.PROBE_NAMES])
def test_probe(cuda_device, case, w):
    """Kernel A's probe against its plain version, one launch a call:
    random reads over a 6,000-row tier, and every case of
    testing/probe_cases (the fence's rows, the window, inverted, empty
    and dead reads, the tier's ends, duplicate keys) at W = 3 and 5."""
    if case == "random":
        if w != 3:
            pytest.skip("the random reads are 8-byte keys, W = 3")
        rng = np.random.default_rng(2)
        keys, n = sorted_keys(rng, 5000, 6000, cuda_device)
        ver = torch.randint(0, 10**6, (6000,), device=cuda_device,
                            dtype=torch.int32)
        b = rng.integers(0, 1 << 20, 2000)
        rb = torch.from_numpy(int_keys_packed(b, 8, 3).view(np.int32))
        re = torch.from_numpy(int_keys_packed(
            b + rng.integers(1, 5000, 2000), 8, 3).view(np.int32))
        rb, re = rb.to(cuda_device), re.to(cuda_device)
    else:
        keys, ver, rb, re = (torch.from_numpy(a).to(cuda_device)
                             for a in PC.probe_case(case, w))
    tab = R.build_plain(ver, op="max")
    hist = H.VersionHistory(keys, ver, H.VERSION_NEG,
                            torch.tensor(False, device=cuda_device))
    got = H.query_reads_vmax(hist, rb, re, tab)
    assert kernels.COUNTS["keysearch.probe"] == 1
    assert_launched_and_equal("keysearch.probe", got,
                              H.query_reads_vmax_plain(keys, tab, rb, re))


@pytest.mark.parametrize("leaves", [1, 64, 4096, 8192, 1 << 18, 1 << 20])
def test_min_cover(cuda_device, leaves):
    """Kernel C with intervals of every level (full-width ones, ones that
    straddle its 4,096-leaf tiles, lo < 0 and hi > leaves): one launch."""
    rng = np.random.default_rng(leaves)
    n = 5000
    lo = rng.integers(-4, leaves + 4, n)
    length = np.concatenate([rng.integers(-2, 300, n // 2),
                             rng.integers(-2, leaves + 8, n - n // 2)])
    log = leaves.bit_length() - 1
    k = np.arange(log + 1)  # one interval at each level, at a random start
    lo[:log + 1] = rng.integers(0, leaves - (1 << k) + 1)
    length[:log + 1] = 1 << k
    lo[-3:], length[-3:] = (0, -5, -3), (leaves, leaves + 10, 4)  # full width
    tiles = np.arange(4096, leaves, 4096)  # straddle every tile boundary
    lo[log + 1:log + 1 + len(tiles)] = tiles - 3
    length[log + 1:log + 1 + len(tiles)] = 7
    val = rng.integers(0, n, n)
    val[::5] = R.INT32_POS
    lo, hi, val = (torch.from_numpy(x.astype(np.int32)).to(cuda_device)
                   for x in (lo, lo + length, val))
    got = S.min_cover(leaves, lo, hi, val)
    assert kernels.COUNTS["min_cover"] == 1
    assert_launched_and_equal("min_cover", got,
                              S.min_cover_plain(leaves, lo, hi, val))


@pytest.mark.parametrize("w", [3, 5])
@pytest.mark.parametrize("name", MC.NAMES)
def test_merge_maps(cuda_device, name, w):
    """Kernel D against its plain version on the cases about its tiles
    (testing/merge_cases: live rows at 0, 1, T - 1, T, T + 1 and 786,432,
    a 5,000-row run across two tile edges, keys shared at every edge, the
    coverage's runs, every value under the floor, a capacity under the
    count; the run, the shared keys and the capacity again past 600,000
    real rows, where the kernel takes its 2,048-position tiles): keys,
    values and count exactly, from one launch."""
    c = MC.case(name, w)
    args = [torch.from_numpy(x).to(cuda_device) for x in c[:4]]
    got = H.merge_maps(*args, floor=c.floor, capacity=c.capacity)
    assert kernels.COUNTS["merge_maps"] == 1
    want = H.merge_maps_plain(*args, floor=c.floor, capacity=c.capacity)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert torch.equal(g, x)


def test_merge_maps_calls_in_a_row(cuda_device):
    """Calls of kernel D one after another on one scratch (growing it,
    and across an epoch wrap), on the card's own coverage: each exact,
    one launch each."""
    rng = np.random.default_rng(4)
    a, na = sorted_keys(rng, 3000, 4000, cuda_device)
    b, nb = sorted_keys(rng, 800, 1000, cuda_device)
    av = torch.randint(0, 5000, (4000,), device=cuda_device, dtype=torch.int32)
    bv = torch.randint(0, 5000, (1000,), device=cuda_device, dtype=torch.int32)
    cw = torch.rand((1000,), device=cuda_device) < 0.9
    cov = G._coverage(b, b.roll(-1, 0).contiguous(), cw, 6000)
    big = MC.case("run 5000")
    big = [torch.from_numpy(x).to(cuda_device) for x in big[:4]]
    calls = ((a[:5], av[:5], b[:3], bv[:3], 7), (a, av, b, bv, 4000),
             (a, av, *cov, 4000), (*big, 20_000), (a, av, b, bv, 1000))
    kernels.reset_counts()
    for i, (ak, aval, bk, bval, cap) in enumerate(calls * 2):
        if i == len(calls):   # the next call wraps the epoch
            H._MERGE_SCRATCH[H._scratch_key(a.device)][1] = H._EPOCH_MAX
        got = H.merge_maps(ak, aval, bk, bval, floor=2500, capacity=cap)
        want = H.merge_maps_plain(ak, aval, bk, bval, floor=2500,
                                  capacity=cap)
        for g, x in zip(got, want):
            assert torch.equal(g, x), i
    assert kernels.COUNTS["merge_maps"] == 2 * len(calls)
    assert H._MERGE_SCRATCH[H._scratch_key(a.device)][1] == len(calls)


def test_merge_maps_streams_and_graph_capture(cuda_device):
    """Kernel D on two streams at once, each with a scratch of its own,
    every call exact; and refused inside a CUDA graph's capture, since
    the epoch it is launched with comes from the host."""
    c = MC.case("run 5000")
    args = [torch.from_numpy(x).to(cuda_device) for x in c[:4]]
    want = H.merge_maps_plain(*args, floor=c.floor, capacity=c.capacity)
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize(cuda_device)
    kernels.reset_counts()
    got, scratch = [], []
    for _ in range(3):
        for s in streams:
            with torch.cuda.stream(s):
                got.append(H.merge_maps(*args, floor=c.floor,
                                        capacity=c.capacity))
    for s in streams:
        with torch.cuda.stream(s):
            scratch.append(H._MERGE_SCRATCH[H._scratch_key(args[0].device)])
    torch.cuda.synchronize(cuda_device)
    assert kernels.COUNTS["merge_maps"] == 6
    assert scratch[0][0].data_ptr() != scratch[1][0].data_ptr()
    for one in got:
        for g, x in zip(one, want):
            assert torch.equal(g, x)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph):
            H.merge_maps(*args, floor=c.floor, capacity=c.capacity)
    assert kernels.COUNTS["merge_maps"] == 6


def test_stream_matches_cpu_plain_path(cuda_device):
    cfg = KernelConfig(max_key_bytes=8, max_txns=1024, max_reads=1024,
                       max_writes=1024, history_capacity=12 * 1024,
                       delta_capacity=12 * 1024, window_versions=5000,
                       compact_interval=3)
    rng = np.random.default_rng(5)
    gpu = make_conflict_set(cfg, "cuda", device=cuda_device)
    cpu = make_conflict_set(cfg, "cuda", device="cpu")
    for i in range(7):
        pb = skiplist_style_batch(rng, cfg, 1024, version=1000 * (i + 1),
                                  keyspace=4000, snapshot_lag=2000)
        got, want = gpu.resolve_packed(pb), cpu.resolve_packed(pb)
        for f in want._fields:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    # the exact uniform tiered path launches every kernel but the two
    # variant probes (sweep_ranks, read_dedup: test_variant_stream_...
    # below), the classic group kernel's cross phase (kernels G and H:
    # test_classic_stream_matches_cpu_plain_path), the sharded path's
    # clip and combine (kernels I and J: test_sharded_stream_...), the
    # short-span kernel K and the search only its cross span at G > 1
    # runs (test_short_span_streams_..., test_short_span_search_launches)
    # and the kernels of no resolver path
    for name, n in kernels.counts().items():
        assert (n > 0) == (name not in (
            "keysearch.search", "sweep_ranks", "read_dedup", *CLASSIC_ONLY,
            *SHARDED_ONLY, *SHORT_SPAN_ONLY, *OFF_PATH)), name


def test_sweep_ranks(cuda_device):
    """Kernel E against its plain version: reads beginning and ending on
    main boundaries (both ties), outside the tier, dead reads, and an
    empty main tier."""
    rng = np.random.default_rng(6)
    keys, n = sorted_keys(rng, 3000, 4000, cuda_device)
    ks = keys[:n]
    r = 6000
    b = rng.integers(0, 1 << 20, r)
    rb = torch.from_numpy(int_keys_packed(b, 8, 3).view(np.int32))
    re = torch.from_numpy(int_keys_packed(b + rng.integers(1, 9000, r), 8,
                                          3).view(np.int32))
    rb, re = rb.to(cuda_device), re.to(cuda_device)
    rb[::4] = ks[torch.from_numpy(rng.integers(0, n, len(range(0, r, 4))))
                 .to(cuda_device)]
    re[1::4] = ks[torch.from_numpy(rng.integers(0, n, len(range(1, r, 4))))
                  .to(cuda_device)]
    rvalid = torch.from_numpy(rng.random(r) < 0.9).to(cuda_device)
    empty = K.sentinel_like(4000, 3, cuda_device)
    for main in (keys, empty):
        got = D.sweep_read_ranks(main, rb, re, rvalid)
        want = D.sweep_read_ranks_plain(main, rb, re, rvalid)
        for g, w in zip(got, want):
            assert_launched_and_equal("sweep_ranks", g, w)


@pytest.mark.parametrize("w", SSC.WIDTHS)
@pytest.mark.parametrize("name", SSC.SEARCH_NAMES)
def test_search_cases(cuda_device, name, w):
    """Kernel A's fenced search, left, right and both sides, against its
    plain version on every case of testing/search_cases (tiers of one
    row, in the fence, at and past its cap, full, repeated rows, a
    sentinel tail of the window's rows; sentinel queries), one launch a
    call."""
    keys, q = (torch.from_numpy(a).to(cuda_device)
               for a in SSC.search_case(name, w))
    for side in ("left", "right"):
        before = kernels.COUNTS["keysearch.search"]
        got = K.searchsorted(keys, q, side=side)
        assert kernels.COUNTS["keysearch.search"] == before + 1
        assert torch.equal(got, K.searchsorted_plain(keys, q, side=side)), side
    before = kernels.COUNTS["keysearch.search"]
    left, right = K.searchsorted(keys, q, side="both")
    assert kernels.COUNTS["keysearch.search"] == before + 1
    want = K.searchsorted_plain(keys, q, side="both")
    assert torch.equal(left, want[0]) and torch.equal(right, want[1])


@pytest.mark.parametrize("name", SSC.COUNT_NAMES)
def test_counts_cases(cuda_device, name):
    """Kernel A's counts entry against its plain version (the W = 1 left
    search): ids with gaps, all equal, 70,000 at B in one bin, none, a
    tile whose ids outnumber the block's threads and bins, ids past the last
    segment, a classic group of 8's 524,288 ids; one launch a call."""
    c = SSC.count_case(name)
    ids = torch.from_numpy(c.ids).to(cuda_device)
    got = G._sorted_counts(ids, c.n_seg)
    assert kernels.COUNTS["keysearch.counts"] == 1
    assert kernels.COUNTS["keysearch.search"] == 0
    assert torch.equal(got, G._sorted_counts_plain(ids, c.n_seg))


def assert_sweep_and_probe(keys, rb, re, live, dev):
    """Kernel E and A's probe against their plain versions, one launch
    each: E on every read (dead ones (-1, -1)), the probe on every read
    over random versions of the tier."""
    kernels.reset_counts()
    got = D.sweep_read_ranks(keys, rb, re, live)
    assert kernels.COUNTS["sweep_ranks"] == 1
    for g, w in zip(got, D.sweep_read_ranks_plain(keys, rb, re, live)):
        assert torch.equal(g, w)
    ver = torch.randint(0, 10**6, (keys.shape[0],), device=dev,
                        dtype=torch.int32)
    tab = R.build_plain(ver, op="max")
    hist = H.VersionHistory(keys, ver, H.VERSION_NEG,
                            torch.tensor(False, device=dev))
    got = H.query_reads_vmax(hist, rb, re, tab)
    assert kernels.COUNTS["keysearch.probe"] == 1
    assert torch.equal(got, H.query_reads_vmax_plain(keys, tab, rb, re))


@pytest.mark.parametrize("w", SSC.WIDTHS)
@pytest.mark.parametrize("name", SSC.SEARCH_NAMES)
def test_sweep_and_probe_search_cases(cuda_device, name, w):
    c = SSC.sweep_case(name, w)
    assert_sweep_and_probe(*(torch.from_numpy(a).to(cuda_device)
                             for a in c), cuda_device)


@pytest.mark.parametrize("w", [3, 5])
@pytest.mark.parametrize("case", PC.PROBE_NAMES)
def test_sweep_probe_cases(cuda_device, case, w):
    """Kernel E on testing/probe_cases (the probe's own cases: the fence
    rows, the window, inverted, empty and dead reads, the tier's ends,
    duplicate keys), dead where the case's read is all-ones."""
    keys, _, rb, re = (torch.from_numpy(a).to(cuda_device)
                       for a in PC.probe_case(case, w))
    live = ~torch.all(rb == K.SENTINEL_WORD, dim=1)
    assert_sweep_and_probe(keys, rb, re, live, cuda_device)


def test_short_span_search_launches(cuda_device):
    """The launches ISSUE's prediction names: phase (b)'s segments are one
    kernel E launch (no search), the cross span at G > 1 one both-sides
    and one left search; a short-span classic group of 4 launches
    kernel A's search twice, E once and the counts once, a tiered batch
    at S no search, E once and the counts once."""
    n = 1024
    rng = np.random.default_rng(21)
    keys, m = sorted_keys(rng, 3000, 4000, cuda_device)
    rb = keys[torch.from_numpy(rng.integers(0, m, n)).to(cuda_device)]
    re = keys[torch.from_numpy(rng.integers(0, m, n)).to(cuda_device)]
    rb, re = torch.minimum(rb, re).contiguous(), torch.maximum(rb,
                                                               re).contiguous()
    live = torch.from_numpy(rng.random(n) < 0.9).to(cuda_device)
    kernels.reset_counts()
    lo, hi = G._tier_segments(keys, rb, re, live)
    assert kernels.counts()["sweep_ranks"] == 1
    assert kernels.counts()["keysearch.search"] == 0
    pts = torch.cat([rb, re])
    rank, ukeys, _ = K.sort_ranks(pts)
    kernels.reset_counts()
    G._block_spans(keys, ukeys, rank[:n], rank[n:], rb, hi)
    assert kernels.counts()["keysearch.search"] == 2
    assert kernels.counts()["sweep_ranks"] == 0
    for classic in (True, False):
        cfg = KernelConfig(max_key_bytes=8, max_txns=n, max_reads=n,
                           max_writes=n, history_capacity=24 * n,
                           delta_capacity=0 if classic else 12 * n,
                           window_versions=5000, compact_interval=0,
                           short_span_limit=8)
        batches = [skiplist_style_batch(rng, cfg, n, version=1000 * (i + 1),
                                        keyspace=4000, snapshot_lag=2000)
                   for i in range(8)]
        gpu = make_conflict_set(cfg, "cuda", device=cuda_device)
        for lo_i in range(0, 8, 4):
            stacked = stack_device_args(batches[lo_i:lo_i + 4])
            kernels.reset_counts()
            gpu.resolve_group_args(stacked)
            c = kernels.counts()
            per = 1 if classic else 4   # a group, or one a batch
            assert c["keysearch.search"] == (2 if classic else 0), c
            assert c["sweep_ranks"] == per, c
            assert c["keysearch.counts"] == per, c


@pytest.mark.parametrize("u", [4096, 64])
def test_read_dedup(cuda_device, u):
    """Kernel F against its plain version, U above the distinct count
    and below it (the tripping case: the vmax of every row still agrees,
    and n_uniq is exact)."""
    rng = np.random.default_rng(7)
    keys, n = sorted_keys(rng, 3000, 4000, cuda_device)
    ver = torch.randint(0, 10**6, (4000,), device=cuda_device,
                        dtype=torch.int32)
    tab = R.build_plain(ver, op="max")
    hist = H.VersionHistory(keys, ver, H.VERSION_NEG,
                            torch.tensor(False, device=cuda_device))
    nr = 8192
    pool = rng.integers(0, 1 << 20, 900)
    b = pool[rng.integers(0, len(pool), nr)]
    rb = torch.from_numpy(int_keys_packed(b, 8, 3).view(np.int32))
    re = torch.from_numpy(int_keys_packed(
        b + rng.integers(1, 3, nr) * 1000, 8, 3).view(np.int32))
    rb, re = rb.to(cuda_device), re.to(cuda_device)
    rvalid = torch.from_numpy(rng.random(nr) < 0.8).to(cuda_device)
    vmax, n_uniq = D.dedup_vmax(hist, tab, rb, re, rvalid, u)
    rows = D.dedup_rows(rb, re, rvalid)
    want_v, want_n = D.dedup_vmax_plain(keys, tab, rows, u)
    assert_launched_and_equal("read_dedup", vmax, want_v)
    assert int(n_uniq) == int(want_n)
    live = rvalid.cpu().numpy()
    pairs = np.concatenate([rb.cpu().numpy()[live], re.cpu().numpy()[live]],
                           axis=1)
    assert int(n_uniq) == len(np.unique(pairs, axis=0))
    if u >= int(n_uniq):
        exact = H.query_reads_vmax_plain(keys, tab, rb, re)
        assert torch.equal(vmax[rvalid], exact[rvalid])


def test_selftest_on_the_card(cuda_device):
    R.flat_gather_selftest(50_000, device=cuda_device, force=True)
    assert kernels.COUNTS["rangemax_build"] > 0
    assert kernels.COUNTS["keysearch.query"] > 0


@pytest.mark.parametrize("profile", ["hot_key", "range_scan"])
def test_variant_stream_matches_cpu_plain_path(cuda_device, profile):
    """A latched zipf stream with read dedup, and a YCSB-E stream with
    the sweep and spill, in groups of 3: the card and the CPU plain path
    field for field, counters alike, kernels E/F launched."""
    n = 1024
    kw = dict(max_key_bytes=8, max_txns=n, max_reads=n, max_writes=n,
              history_capacity=12 * n, window_versions=5000,
              fixpoint_latch=True)
    if profile == "hot_key":
        kw.update(delta_capacity=12 * n, compact_interval=3,
                  fixpoint_unroll=3, dedup_reads=256)
    else:
        kw.update(delta_capacity=8 * n, compact_interval=0,
                  fixpoint_unroll=6, range_sweep=True, delta_spill=True)
    cfg = KernelConfig(**kw)
    rng = np.random.default_rng(8)
    batches = []
    for i in range(9):
        v = 1000 * (i + 1)
        if profile == "hot_key":
            batches.append(skiplist_style_batch(
                rng, cfg, n, version=v, keyspace=100_000, zipf=1.1,
                snapshot_lag=2000))
        else:
            batches.append(ycsb_batch(rng, cfg, n, "ycsb_e", version=v,
                                      keyspace=50_000, snapshot_lag=2000))
    gpu = make_conflict_set(cfg, "cuda", device=cuda_device)
    cpu = make_conflict_set(cfg, "cuda", device="cpu")
    kernels.reset_counts()
    for lo in range(0, 9, 3):
        stacked = stack_device_args(batches[lo:lo + 3])
        got = gpu.resolve_group_args(stacked)
        want = cpu.resolve_group_args(stacked)
        for f in want._fields:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert gpu.metrics.counters.as_dict() == cpu.metrics.counters.as_dict()
    name = "read_dedup" if profile == "hot_key" else "sweep_ranks"
    assert kernels.COUNTS[name] > 0


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("m", [1, 33, 5000, 70_001, 2_097_152])
def test_rangemax2(cuda_device, op, m):
    """Kernel G against the plain two-level structure: the chunk maxima
    and the superchunk table row for row, and every query (spans within
    a chunk, across chunks and superchunks, empty, clipped), up to the
    2,097,152 ranks of a bench-shape group of 8 (all 12 table levels)."""
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    vals = torch.randint(-10**9, 10**9, (m,), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    built = R.build2(vals, op=op)
    plain = R.build2_plain(vals, op=op)
    chunk = plain[0][R.CHUNK_BITS][::R.CHUNK]
    assert_launched_and_equal("rangemax2.build", built[1], chunk)
    ident = R.INT32_POS if op == "min" else R.INT32_NEG
    ns = built[2].shape[1]
    padded = torch.full((ns * R.CHUNK,), ident, dtype=torch.int32,
                        device=cuda_device)
    padded[:chunk.shape[0]] = chunk
    fold = padded.reshape(ns, R.CHUNK)
    fold = fold.min(dim=1).values if op == "min" else fold.max(dim=1).values
    assert torch.equal(built[2], R.build_plain(fold, op=op))
    q = 20_000
    lo = torch.randint(-3, m + 40, (q,), generator=gen, device=cuda_device,
                       dtype=torch.int32)
    span = torch.randint(-4, 40, (q,), generator=gen, device=cuda_device,
                         dtype=torch.int32)
    span[::3] = torch.randint(0, m + 64, (len(range(0, q, 3)),),
                              generator=gen, device=cuda_device,
                              dtype=torch.int32)
    span[1::3] = torch.randint(0, 3000, (len(range(1, q, 3)),),
                               generator=gen, device=cuda_device,
                               dtype=torch.int32)
    hi = lo + span
    assert_launched_and_equal("rangemax2.query",
                              R.query2(built, lo, hi, op=op),
                              R.query2_plain(plain, lo, hi, op=op))


def rm2_layout(vals, op):
    """Kernel G's chunk maxima and superchunk table, from the plain
    (JAX-layout) structure."""
    plain = R.build2_plain(vals, op=op)
    chunk = plain[0][R.CHUNK_BITS][::R.CHUNK]
    ns = -(-vals.shape[0] // R.SUPER)
    padded = torch.full((ns * R.CHUNK,), R.INT32_POS if op == "min"
                        else R.INT32_NEG, dtype=torch.int32,
                        device=vals.device)
    padded[:chunk.shape[0]] = chunk
    fold = padded.reshape(ns, R.CHUNK)
    fold = fold.min(dim=1).values if op == "min" else fold.max(dim=1).values
    return chunk, R.build_plain(fold, op=op)


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("m", [1, 700, 1024, 1025, 2048, 2049 * 1024])
def test_rangemax2_build_is_one_launch(cuda_device, op, m):
    """Kernel G's build is one launch a call at one superchunk (m < 1,024,
    m = 1,024), two, and 2,049 (its last block's table of 12 levels), and
    exact call after call: the last block sets the arrival counter back,
    so the next call's last block is found again."""
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    for rep in range(3):
        vals = torch.randint(-10**9, 10**9, (m,), generator=gen,
                             device=cuda_device, dtype=torch.int32)
        before = kernels.COUNTS["rangemax2.build"]
        built = R.build2(vals, op=op)
        assert kernels.COUNTS["rangemax2.build"] == before + 1
        chunk, table = rm2_layout(vals, op)
        assert torch.equal(built[1], chunk), rep
        assert torch.equal(built[2], table), rep
    key = (vals.device, torch.cuda.current_stream().cuda_stream)
    assert int(R._BUILD2_ARRIVE[key]) == 0


def test_rangemax2_build_fails_on_a_counter_left_off(cuda_device):
    """A build whose stream's arrival counter does not start at 0 fails
    its launch by a device assert, never a wrong table in silence. In a
    child process: the assert leaves that process's CUDA context
    unusable."""
    code = textwrap.dedent("""
        import torch
        from foundationdb_tpu_torch.ops import rangemax as R
        vals = torch.arange(1 << 21, dtype=torch.int32, device="cuda")
        R.build2(vals)
        torch.cuda.synchronize()
        R._build2_arrive(vals.device).fill_(1 << 20)
        R.build2(vals)
        torch.cuda.synchronize()
        print("built with no error")
    """)
    done = subprocess.run([sys.executable, "-c", code],
                          cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=300)
    said = done.stdout + done.stderr
    assert done.returncode != 0, said
    assert "built with no error" not in said
    assert "device-side assert" in said, said


def test_rangemax2_build_refuses_too_many_superchunks(cuda_device):
    m = R.MAX_SUPER * R.SUPER + 1
    with pytest.raises(ValueError, match="superchunks"):
        R.build2(torch.zeros((m,), dtype=torch.int32, device=cuda_device))


def test_rangemax2_in_a_cuda_graph(cuda_device):
    """G's build and query captured in a CUDA graph replay exact: the
    capture's arrival counter lives in the graph's memory and returns to 0
    each replay; eager builds on the stream between replays stay exact."""
    m, q = 70_001, 5000
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    vals = torch.randint(-10**9, 10**9, (m,), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    lo = torch.randint(-3, m, (q,), generator=gen, device=cuda_device,
                       dtype=torch.int32)
    hi = lo + torch.randint(-2, 3000, (q,), generator=gen,
                            device=cuda_device, dtype=torch.int32)
    st = torch.cuda.Stream()
    with torch.cuda.stream(st):   # warm: the library loads outside
        R.query2(R.build2(vals, op="max"), lo, hi, op="max")
    st.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=st):
        built = R.build2(vals, op="max")
        out = R.query2(built, lo, hi, op="max")
    for rep in range(3):
        vals.copy_(torch.randint(-10**9, 10**9, (m,), generator=gen,
                                 device=cuda_device, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        chunk, table = rm2_layout(vals, "max")
        assert torch.equal(built[1], chunk) and torch.equal(built[2], table)
        assert torch.equal(out, R.query2_plain(R.build2_plain(vals, op="max"),
                                               lo, hi, op="max")), rep
        with torch.cuda.stream(st):
            eager = R.build2(vals, op="min")
        st.synchronize()
        assert torch.equal(eager[2], rm2_layout(vals, "min")[1])


@pytest.mark.parametrize(
    "case", ["random n=1", "random n=4096", "random n=20000",
             *PC.FOLD_NAMES])
def test_seg_fold(cuda_device, case):
    """Kernel H against its plain version, one launch a call, painting in
    place: random writes with inverted and empty ones, then one write over
    the whole space (one scratch serves both folds, each leaving it zero);
    and every case of testing/probe_cases, on the paint and the count."""
    if case.startswith("random"):
        n = int(case.split("=")[1])
        gen = torch.Generator(device=cuda_device).manual_seed(n)
        nw = 3000
        seg = torch.randint(-5, 50, (n,), generator=gen, device=cuda_device,
                            dtype=torch.int32)
        wb = torch.randint(0, n, (nw,), generator=gen, device=cuda_device,
                           dtype=torch.int32)
        we = (wb + torch.randint(-3, 300, (nw,), generator=gen,
                                 device=cuda_device, dtype=torch.int32)
              ).clamp(0, n - 1)
        cw = torch.rand((nw,), generator=gen, device=cuda_device) < 0.7
        folds = [(False, 77), (True, 77)]
    else:
        c = PC.fold_case(case)
        seg, wb, we, cw = (torch.from_numpy(a).to(cuda_device)
                           for a in c[:4])
        n = seg.shape[0]
        folds = [(False, c.version)]
    scratch = G.seg_fold_scratch(n, cuda_device)
    for whole, version in folds:
        if whole:
            wb[0], we[0], cw[0] = 0, n - 1, True
        want = G.seg_fold_plain(seg.clone(), wb, we, cw, version)
        got = seg.clone()
        before = kernels.COUNTS["seg_fold"]
        assert G.seg_fold(got, wb, we, cw, version, scratch) is got
        assert kernels.COUNTS["seg_fold"] - before == 1
        assert_launched_and_equal("seg_fold", got, want)
        assert not scratch.any()


def test_classic_stream_matches_cpu_plain_path(cuda_device):
    """The classic single-tier path in groups of 4 (the group kernel with
    its cross phase) and batch by batch (resolve_batch): the card and
    the CPU plain path field for field, the tier alike, kernels G and H
    launched by the groups."""
    n = 1024
    cfg = KernelConfig(max_key_bytes=8, max_txns=n, max_reads=n,
                       max_writes=n, history_capacity=24 * n,
                       window_versions=5000)
    rng = np.random.default_rng(9)
    batches = [skiplist_style_batch(rng, cfg, n, version=1000 * (i + 1),
                                    keyspace=4000, snapshot_lag=2000)
               for i in range(8)]
    gpu = make_conflict_set(cfg, "cuda", device=cuda_device)
    cpu = make_conflict_set(cfg, "cuda", device="cpu")
    seq = make_conflict_set(cfg, "cuda", device=cuda_device)
    kernels.reset_counts()
    for lo in (0, 4):
        stacked = stack_device_args(batches[lo:lo + 4])
        got = gpu.resolve_group_args(stacked)
        want = cpu.resolve_group_args(stacked)
        for f in want._fields:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
        for i, pb in enumerate(batches[lo:lo + 4]):
            one = seq.resolve_packed(pb)
            for f in one._fields:
                assert torch.equal(getattr(one, f).cpu(),
                                   getattr(want, f)[i]), f
    for part in ("main_keys", "main_ver"):
        assert torch.equal(getattr(gpu.state, part).cpu(),
                           getattr(cpu.state, part)), part
    for name in CLASSIC_ONLY:
        assert kernels.COUNTS[name] > 0, name


@pytest.mark.parametrize("bounds", [[], [1000, 2000, 3000], [2**31 + 5]])
def test_shard_clip(cuda_device, bounds):
    """Kernel I against its plain version on a group of 3 scan batches:
    ranges straddling and touching the boundaries, keys with the high
    bit set, dead rows, one shard and the sentinel hi."""
    n = 1024
    cfg = KernelConfig(max_key_bytes=8, max_txns=n, max_reads=n,
                       max_writes=n, history_capacity=n)
    rng = np.random.default_rng(len(bounds))
    batches = [skiplist_style_batch(rng, cfg, n - 10 * i, version=10 * (i + 1),
                                    keyspace=4000, range_len=300,
                                    snapshot_lag=5) for i in range(3)]
    for pb in batches:
        pb.read_begin[::7] = int_keys_packed(np.array(bounds or [9]), 8, 3)[0]
        pb.write_end[::5] = int_keys_packed(np.array([2**31 + 7]), 8, 3)[0]
        pb.read_valid[::11] = False
    g = interop.device_args_to_torch(stack_device_args(batches), cuda_device)
    keys = [int(x).to_bytes(8, "big") for x in bounds]
    lo, hi = SH.partition_tensors(keys, cfg, cuda_device)
    got = SH.clip_batch(g, lo, hi)
    want = SH.clip_batch_plain(g, lo, hi)
    assert kernels.COUNTS["shard_clip"] == 1
    for k in SH.CLIPPED:
        assert torch.equal(got[k], want[k]), k
    assert bool(want["read_valid"].any())


@pytest.mark.parametrize("s,gn,b,nr", [(1, 1, 16, 32), (4, 8, 1000, 2500),
                                       (5, 3, 100, 70)])
def test_shard_combine(cuda_device, s, gn, b, nr):
    """Kernel J against its plain version: rows not a multiple of 32,
    more reads than txns and fewer."""
    gen = torch.Generator(device=cuda_device).manual_seed(s * gn)

    def rand(*shape, p):
        return torch.rand(shape, generator=gen, device=cuda_device) < p

    codes = torch.tensor([0, 1, 3], dtype=torch.int32, device=cuda_device)
    verdict = codes[torch.randint(0, 3, (s, gn, b), generator=gen,
                                  device=cuda_device)]
    first = torch.randint(-1, nr, (s, gn, b), generator=gen,
                          device=cuda_device, dtype=torch.int32)
    first[rand(s, gn, b, p=0.5)] = -1
    args = (verdict, first, rand(s, gn, nr, p=0.1), rand(s, gn, p=0.2),
            rand(s, p=0.3), rand(gn, b, p=0.8))
    got, want = SH.combine(*args), SH.combine_plain(*args)
    assert kernels.COUNTS["shard_combine"] == 1
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("latched", [False, True])
def test_sharded_stream_matches_cpu_plain_path(cuda_device, latched):
    """Four shards at the keyspace quartiles, groups of 3: the card and
    the CPU plain path field for field, every shard's tiers alike,
    kernels I and J launched; latched with a dedup cap that trips."""
    n = 1024
    kw = dict(max_key_bytes=8, max_txns=n, max_reads=n, max_writes=n,
              history_capacity=12 * n, delta_capacity=12 * n,
              window_versions=5000, compact_interval=3, n_shards=4)
    if latched:
        kw.update(fixpoint_latch=True, fixpoint_unroll=2, dedup_reads=64)
    cfg = KernelConfig(**kw)
    keys = [int(i * 1000).to_bytes(8, "big") for i in (1, 2, 3)]
    rng = np.random.default_rng(10)
    batches = [skiplist_style_batch(rng, cfg, n, version=1000 * (i + 1),
                                    keyspace=4000, range_len=40,
                                    snapshot_lag=2000) for i in range(9)]
    gpu = make_conflict_set(cfg, "cuda", device=cuda_device,
                            shard_boundaries=keys)
    cpu = make_conflict_set(cfg, "cuda", device="cpu", shard_boundaries=keys)
    kernels.reset_counts()
    for lo in range(0, 9, 3):
        stacked = stack_device_args(batches[lo:lo + 3])
        got = gpu.resolve_group_args(stacked)
        want = cpu.resolve_group_args(stacked)
        for f in want._fields:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
        for a, b in zip(gpu.store_state()[0], cpu.store_state()[0]):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)
    assert gpu.metrics.counters.as_dict() == cpu.metrics.counters.as_dict()
    if latched:
        assert gpu.metrics.counters.get("exactFallbacks") > 0
    for name in SHARDED_ONLY:
        assert kernels.COUNTS[name] > 0, name


# ---------------------------------------------------------------------------
# kernels K, L, M and merge_writes on kernel D

def flat_state(cs) -> list:
    """A conflict set's tiers as a flat list of numpy leaves."""
    state = cs.store_state()[0]
    tiers = state if isinstance(state[0], tuple) else (state,)
    return [np.asarray(x) for tier in tiers for x in tier]


@pytest.mark.parametrize("span", [1, 4, 8])
def test_short_span_kernels(cuda_device, span):
    gen = torch.Generator(device=cuda_device).manual_seed(span)
    n, q = 4096, 20000
    vals = torch.randint(-10**9, 10**9, (n,), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    lo = torch.randint(-2, n, (q,), generator=gen, device=cuda_device,
                       dtype=torch.int32)
    hi = lo + torch.randint(-2, 12, (q,), generator=gen, device=cuda_device,
                            dtype=torch.int32)
    for op in ("max", "min"):
        assert_launched_and_equal(
            "short_span.range", G.ss_range(vals, lo, hi, span, op=op),
            G.ss_range_plain(vals, lo, hi, span, op=op))
    wlo = lo.clamp(0, n - 1)
    whi = (wlo + torch.randint(-1, 10, (q,), generator=gen,
                               device=cuda_device,
                               dtype=torch.int32)).clamp(max=n)
    val = torch.randint(0, q, (q,), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    val[::3] = R.INT32_POS
    assert_launched_and_equal(
        "short_span.apply", G.ss_apply(n, wlo, whi, val, lo, hi, span),
        G.ss_apply_plain(n, wlo, whi, val, lo, hi, span))
    assert_cover_reads_clear(lo.device)


def assert_cover_reads_clear(dev):
    """Every leaf of kernel K's cover for the current stream of `dev` (a
    tensor's device, with its index) reads as INT32_POS at its current
    stamp: what the next launch starts from."""
    cover = G._SPAN_COVER[H._scratch_key(dev)]
    stamp = int(cover[-1]) & 0xFFFFFFFF
    high = (cover[:-1] >> 32) & 0xFFFFFFFF
    low = cover[:-1] & 0xFFFFFFFF
    assert not bool(((high == stamp) & (low != 0xFFFFFFFF)).any())


def span_inputs(case, dev):
    """A span case's (wlo, whi, [vals], qlo, qhi) on the card."""
    def on(x):
        return torch.from_numpy(x).to(dev)
    return (on(case.wlo), on(case.whi), [on(v) for v in case.vals],
            on(case.qlo), on(case.qhi))


@pytest.mark.parametrize("w", [3, 5])
@pytest.mark.parametrize("name", SC.NAMES)
def test_span_apply(cuda_device, name, w):
    """Kernel K's apply entry against its plain version on every span
    case, each application in a row at S in {1, 2, 4, 8}, one launch a
    call, the cover reading clear after each."""
    c = SC.span_case(name, w)
    wlo, whi, vals, qlo, qhi = span_inputs(c, cuda_device)
    for span in (1, 2, 4, 8):
        for val in vals:
            before = kernels.COUNTS["short_span.apply"]
            got = G.ss_apply(c.leaves, wlo, whi, val, qlo, qhi, span)
            assert kernels.COUNTS["short_span.apply"] == before + 1
            assert torch.equal(got, G.ss_apply_plain(c.leaves, wlo, whi,
                                                     val, qlo, qhi, span))
            assert_cover_reads_clear(wlo.device)


def test_span_apply_in_a_row_and_the_last_stamp(cuda_device):
    """200 applications in a row over every case and span stay exact;
    then the launches across the last stamp (0): the one that holds it
    sets every leaf and the stamp back to all ones, and the next are
    exact."""
    cases = [span_inputs(SC.span_case(n, w), cuda_device) + (
        SC.span_case(n, w).leaves,) for n in SC.NAMES for w in (3, 5)]
    wants = {}

    def check(k):
        wlo, whi, vals, qlo, qhi, leaves = cases[k % len(cases)]
        span = (1, 2, 4, 8)[k % 4]
        j = k % len(vals)
        got = G.ss_apply(leaves, wlo, whi, vals[j], qlo, qhi, span)
        key = (k % len(cases), span, j)
        if key not in wants:
            wants[key] = G.ss_apply_plain(leaves, wlo, whi, vals[j], qlo,
                                          qhi, span)
        assert torch.equal(got, wants[key]), k

    for k in range(200):
        check(k)
    assert kernels.COUNTS["short_span.apply"] == 200
    dev = cases[0][0].device
    cover = G._SPAN_COVER[H._scratch_key(dev)]
    cover[-1] = 1
    check(0)
    check(1)                       # stamp 0: resets the cover
    assert bool((cover == -1).all())
    for k in range(2, 6):
        check(k)
    assert_cover_reads_clear(dev)


def test_span_apply_on_two_streams(cuda_device):
    """Calls on two streams at once, each on its own cover, all exact."""
    cases = [SC.span_case("two in a row", 3), SC.span_case("one hot leaf",
                                                            5)]
    ins = [span_inputs(c, cuda_device) for c in cases]
    wants = [[G.ss_apply_plain(c.leaves, i[0], i[1], v, i[3], i[4], 4)
              for v in i[2]] for c, i in zip(cases, ins)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for k, (c, i, st) in enumerate(zip(cases, ins, streams)):
            with torch.cuda.stream(st):
                for v in i[2]:
                    outs[k].append(G.ss_apply(c.leaves, i[0], i[1], v, i[3],
                                              i[4], 4))
    torch.cuda.synchronize()
    for k in range(2):
        for n, got in enumerate(outs[k]):
            assert torch.equal(got, wants[k][n % len(wants[k])]), (k, n)
    for st in streams:
        assert (ins[0][0].device, st.cuda_stream) in G._SPAN_COVER


def capture_span_apply(c, ins, st, warm: bool):
    """(graph, out): two applications of span case `c` in a row (vals 0
    then 1) captured on stream `st`, after an eager call there when
    `warm` (the stream then holds a cover)."""
    wlo, whi, vals, qlo, qhi = ins
    torch.cuda.synchronize()
    if warm:
        with torch.cuda.stream(st):
            G.ss_apply(c.leaves, wlo, whi, vals[1], qlo, qhi, 4)
        st.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=st):
        G.ss_apply(c.leaves, wlo, whi, vals[0], qlo, qhi, 4)
        out = G.ss_apply(c.leaves, wlo, whi, vals[1], qlo, qhi, 4)
    return graph, out


@pytest.mark.parametrize("warm", [True, False])
def test_span_apply_in_a_cuda_graph(cuda_device, warm):
    """Kernel K's stamp lives on the card, so a captured application
    replays exact: the capture makes its own cover inside the graph
    (its fill captured too), whether or not its stream holds one
    (`warm`); a replay leaves the stream's held cover as it was, and
    eager calls on the stream between the replays stay exact."""
    c = SC.span_case("two in a row", 3)
    ins = span_inputs(c, cuda_device)
    wlo, whi, vals, qlo, qhi = ins
    want = [G.ss_apply_plain(c.leaves, wlo, whi, v, qlo, qhi, 4)
            for v in vals]
    st = torch.cuda.Stream()
    graph, out = capture_span_apply(c, ins, st, warm)
    key = (wlo.device, st.cuda_stream)
    for _ in range(3):
        held = G._SPAN_COVER.get(key)
        before = None if held is None else held.clone()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want[1])
        if held is not None:
            assert torch.equal(held, before)
        with torch.cuda.stream(st):
            eager = G.ss_apply(c.leaves, wlo, whi, vals[2], qlo, qhi, 4)
        st.synchronize()
        assert torch.equal(eager, want[2])


def test_span_apply_graph_replays_after_the_cover_grows(cuda_device):
    """After a warm capture, an eager call with more leaves replaces the
    stream's cover and frees the old one; new tensors may take its
    memory. The graph's replays use the cover made inside the capture,
    so they stay exact and leave the new tensors and cover untouched."""
    c = SC.span_case("two in a row", 5)
    ins = span_inputs(c, cuda_device)
    wlo, whi, vals, qlo, qhi = ins
    want = G.ss_apply_plain(c.leaves, wlo, whi, vals[1], qlo, qhi, 4)
    st = torch.cuda.Stream()
    key = (wlo.device, st.cuda_stream)
    G._SPAN_COVER.pop(key, None)   # a pooled stream may hold a larger one
    graph, out = capture_span_apply(c, ins, st, warm=True)
    small = G._SPAN_COVER[key]
    big = 4 * c.leaves
    want_big = G.ss_apply_plain(big, wlo, whi, vals[2], qlo, qhi, 4)
    with torch.cuda.stream(st):
        got_big = G.ss_apply(big, wlo, whi, vals[2], qlo, qhi, 4)
    st.synchronize()
    assert G._SPAN_COVER[key].shape[0] > small.shape[0]
    del small
    fill = [torch.full((c.leaves + 1,), 7, dtype=torch.int64,
                       device=cuda_device) for _ in range(4)]
    torch.cuda.synchronize()
    grown = G._SPAN_COVER[key].clone()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert torch.equal(G._SPAN_COVER[key], grown)
        assert all(bool((f == 7).all()) for f in fill)
    assert torch.equal(got_big, want_big)
    with torch.cuda.stream(st):
        again = G.ss_apply(big, wlo, whi, vals[2], qlo, qhi, 4)
    st.synchronize()
    assert torch.equal(again, want_big)


def wide_rows(rng, p, w):
    """[P, w] rows of packed keys over the bytes {0x00, 0x01, 0x7F, 0x80,
    0xFF} at every length up to 4 (w - 1) bytes (the last word the
    length), as int32 bit patterns; a third of them repeated."""
    alphabet = np.array([0x00, 0x01, 0x7F, 0x80, 0xFF], np.uint8)
    nb = 4 * (w - 1)
    raw = alphabet[rng.integers(0, 5, (p, nb))]
    lens = rng.integers(0, nb + 1, p)
    raw[np.arange(nb)[None, :] >= lens[:, None]] = 0
    rows = np.empty((p, w), np.uint32)
    rows[:, :w - 1] = raw.view(">u4").astype(np.uint32)
    rows[:, w - 1] = lens
    dup = rng.integers(0, p, p // 3)
    rows[dup] = rows[rng.integers(0, p, dup.shape[0])]
    return rows


@pytest.mark.parametrize("p,w,case", [
    (1, 3, "keys"), (1, 1, "keys"), (1000, 1, "keys"), (5_003, 3, "keys"),
    (70_001, 6, "keys"), (3_001, 16, "keys"), (4_097, 3, "sentinel"),
    (2_000, 3, "all sentinel"), (9_999, 6, "ones but the length"),
    (20_000, 2, "random words"), (2_097_152, 3, "sentinel")])
def test_lex_order(cuda_device, p, w, case):
    """Kernel N against the plain sort: the permutation and the sorted
    rows exactly, from one launch."""
    rng = np.random.default_rng(p + w)
    if case == "random words":
        rows = rng.integers(0, 2**32, (p, w), dtype=np.uint64).astype(
            np.uint32)
    elif w == 1:   # one byte word, no length word
        rows = np.ascontiguousarray(wide_rows(rng, p, 2)[:, :1])
    else:
        rows = wide_rows(rng, p, w)
    if case in ("sentinel", "ones but the length"):
        rows[rng.random(p) < 0.25] = 0xFFFFFFFF
    if case == "ones but the length":
        m = rng.random(p) < 0.25
        rows[m, :w - 1] = 0xFFFFFFFF
        rows[m, w - 1] = rng.integers(0, 4 * w, int(m.sum()))
    if case == "all sentinel":
        rows[:] = 0xFFFFFFFF
    x = torch.from_numpy(rows.view(np.int32)).to(cuda_device)
    got = K.lex_sort_perm(x)
    assert kernels.COUNTS["lex_order"] == 1
    want = K.lex_sort_perm_plain(x)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and torch.equal(g, w_)


def test_lex_order_refuses_wide_rows(cuda_device):
    x = torch.zeros((4, kernels.MAX_ROW_WORDS + 1), dtype=torch.int32,
                    device=cuda_device)
    with pytest.raises(ValueError):
        K.lex_sort_perm(x)
    assert kernels.COUNTS["lex_order"] == 0


@pytest.mark.parametrize("p", [1, 1000, 262_144])
def test_sort_ranks(cuda_device, p):
    rng = np.random.default_rng(p)
    ks = int_keys_packed(rng.integers(0, max(2, p // 2), size=p), 8, 3)
    ks[rng.random(p) < 0.05] = 0xFFFFFFFF          # valid all-ones rows
    pts = torch.from_numpy(ks.view(np.int32)).to(cuda_device)
    valid = torch.from_numpy(rng.random(p) < 0.9).to(cuda_device)
    got = K.sort_ranks(pts, valid)
    want = K.sort_ranks_plain(pts, valid)
    for g, w in zip(got, want):
        assert_launched_and_equal("sort_ranks", g, w)
    assert kernels.COUNTS["lex_order"] == 1


@pytest.mark.parametrize("p,w", [(1, 6), (3_000, 6), (65_536, 16)])
def test_sort_ranks_wide_rows(cuda_device, p, w):
    """Kernel L at the read-dedup rows' widths (2W words)."""
    rng = np.random.default_rng(p + w)
    rows = wide_rows(rng, p, w)
    rows[rng.random(p) < 0.2] = 0xFFFFFFFF
    pts = torch.from_numpy(rows.view(np.int32)).to(cuda_device)
    for g, w_ in zip(K.sort_ranks(pts), K.sort_ranks_plain(pts)):
        assert_launched_and_equal("sort_ranks", g, w_)


@pytest.mark.parametrize("floor", [0, 2500])
def test_merge_writes(cuda_device, floor):
    rng = np.random.default_rng(12 + floor)
    keys, n = sorted_keys(rng, 3000, 4000, cuda_device)
    ver = torch.randint(0, 5000, (4000,), device=cuda_device,
                        dtype=torch.int32)
    ver[n:] = H.VERSION_NEG
    hist = H.VersionHistory(keys, ver, 0, torch.zeros(
        (), dtype=torch.bool, device=cuda_device))
    # run bounds: fresh keys and tier keys (a begin or an end equal to a
    # tier key), sorted, distinct, an even count, sentinel tail
    pool = np.unique(np.concatenate([
        rng.integers(0, 1 << 20, size=600),
        np.asarray(rng.choice(keys[:n].cpu().numpy()[:, 1].view(np.uint32),
                              200, replace=False), np.int64)]))
    pool = pool[: len(pool) // 2 * 2]
    runs = np.full((len(pool) + 6, 3), 0xFFFFFFFF, np.uint32)
    runs[: len(pool)] = int_keys_packed(pool, 8, 3)
    runs = torch.from_numpy(runs.view(np.int32)).to(cuda_device)
    for cap_hist in (hist, hist._replace(
            main_keys=keys[:3100].contiguous(),
            main_ver=ver[:3100].contiguous())):       # overflow
        before = kernels.COUNTS["merge_writes"]
        got = H.merge_writes(cap_hist, runs, 6000, floor)
        assert kernels.COUNTS["merge_writes"] == before + 1
        want = H.merge_writes_plain(cap_hist, runs, 6000, floor)
        for part in ("main_keys", "main_ver", "overflow"):
            assert_launched_and_equal("merge_writes", getattr(got, part),
                                      getattr(want, part))
        assert got.oldest == want.oldest


def writes_state(c, dev) -> H.VersionHistory:
    return H.VersionHistory(
        torch.from_numpy(c.main_keys).to(dev),
        torch.from_numpy(c.main_ver).to(dev), c.oldest,
        torch.tensor(c.overflow, device=dev))


@pytest.mark.parametrize("w", [3, 5])
@pytest.mark.parametrize("name", WC.NAMES)
def test_merge_writes_case(cuda_device, name, w):
    """Kernel D's row-keeping mode against its plain version on every
    case of testing/writes_cases (real rows about its tiles, a run begin
    on a tier key at every tile edge, every bound on a tier key, no
    bounds, an empty tier, one run over every key, everything under the
    floor, a capacity under the count, an overflow already latched; past
    700,000 real rows, where it takes 2,048-position tiles): keys,
    versions, floor and overflow exactly, from one launch."""
    c = WC.case(name, w)
    state = writes_state(c, cuda_device)
    runs = torch.from_numpy(c.runs).to(cuda_device)
    got = H.merge_writes(state, runs, c.version, c.floor)
    assert kernels.COUNTS["merge_writes"] == 1
    assert sum(kernels.counts().values()) == 1
    want = H.merge_writes_plain(state, runs, c.version, c.floor)
    for part in ("main_keys", "main_ver", "overflow"):
        g, x = getattr(got, part), getattr(want, part)
        assert g.dtype == x.dtype and g.shape == x.shape, part
        assert torch.equal(g, x), part
    assert got.oldest == want.oldest


def test_merge_writes_shares_the_merge_scratch(cuda_device):
    """merge_writes and merge_maps one after another on one stream's
    scratch and epochs (growing it, and across an epoch wrap): every call
    exact, one launch each, and refused inside a CUDA graph's capture."""
    small = WC.case("live 2049")
    big = WC.case("large")
    maps = MC.case("run 5000")
    margs = [torch.from_numpy(x).to(cuda_device) for x in maps[:4]]
    kernels.reset_counts()
    calls = 0
    for i in range(2):
        if i:   # the next call wraps the epoch
            key = H._scratch_key(margs[0].device)
            H._MERGE_SCRATCH[key][1] = H._EPOCH_MAX
        for c in (small, big, small):
            state = writes_state(c, cuda_device)
            runs = torch.from_numpy(c.runs).to(cuda_device)
            got = H.merge_writes(state, runs, c.version, c.floor)
            want = H.merge_writes_plain(state, runs, c.version, c.floor)
            for part in ("main_keys", "main_ver", "overflow"):
                assert torch.equal(getattr(got, part), getattr(want, part))
            got = H.merge_maps(*margs, floor=maps.floor,
                               capacity=maps.capacity)
            want = H.merge_maps_plain(*margs, floor=maps.floor,
                                      capacity=maps.capacity)
            for g, x in zip(got, want):
                assert torch.equal(g, x)
            calls += 1
    assert kernels.COUNTS["merge_writes"] == calls
    assert kernels.COUNTS["merge_maps"] == calls
    state = writes_state(small, cuda_device)
    runs = torch.from_numpy(small.runs).to(cuda_device)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph):
            H.merge_writes(state, runs, small.version, small.floor)
    assert kernels.COUNTS["merge_writes"] == calls


@pytest.mark.parametrize("m", WC.BUILD_ROWS)
def test_rangemax4_case(cuda_device, m):
    """Kernel M's build (B at radix 4) and query on testing/writes_cases'
    sizes and queries, max and min: exact, one launch a call each."""
    vals, lo, hi = (torch.from_numpy(x).to(cuda_device)
                    for x in WC.build_case(m))
    for op in ("max", "min"):
        kernels.reset_counts()
        tab = R.build4(vals, op=op)
        assert kernels.counts()["rangemax4.build"] == 1
        assert sum(kernels.counts().values()) == 1
        assert torch.equal(tab, R.build4_plain(vals, op=op)), op
        got = R.query4(tab, lo, hi, op=op)
        assert kernels.counts()["rangemax4.query"] == 1
        assert torch.equal(got, R.query4_plain(tab, lo, hi, op=op)), op
        # ends that start one element into their tensors
        got = R.query4(tab, lo[1:], hi[1:], op=op)
        assert torch.equal(got, R.query4_plain(tab, lo[1:], hi[1:], op=op))


@pytest.mark.parametrize("leaves", WC.COVER_LEAVES)
def test_cover4_case(cuda_device, leaves):
    """Kernel M's cover (C at radix 4) on testing/writes_cases' widths
    (odd log2 ones too) and intervals: exact, one launch."""
    lo, hi, val = (torch.from_numpy(x).to(cuda_device)
                   for x in WC.cover_case(leaves))
    got = S.min_cover4(leaves, lo, hi, val)
    assert kernels.counts()["rangemax4.cover"] == 1
    assert sum(kernels.counts().values()) == 1
    assert torch.equal(got, S.min_cover4_plain(leaves, lo, hi, val))


@pytest.mark.parametrize("m", [1, 5, 1000, 131_072, 262_144])
def test_rangemax4(cuda_device, m):
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    vals = torch.randint(-10**9, 10**9, (m,), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    lo = torch.randint(-3, m + 3, (65_536,), generator=gen,
                       device=cuda_device, dtype=torch.int32)
    hi = lo + torch.randint(-3, m + 5, (65_536,), generator=gen,
                            device=cuda_device, dtype=torch.int32)
    for op in ("max", "min"):
        kernels.reset_counts()
        tab = R.build4(vals, op=op)
        assert kernels.COUNTS["rangemax4.build"] == 1
        assert_launched_and_equal("rangemax4.build", tab,
                                  R.build4_plain(vals, op=op))
        assert_launched_and_equal("rangemax4.query",
                                  R.query4(tab, lo, hi, op=op),
                                  R.query4_plain(tab, lo, hi, op=op))
        assert kernels.COUNTS["rangemax4.query"] == 1
    leaves = 1 << max(0, (m - 1).bit_length())
    wlo = lo.clamp(0, leaves)
    whi = wlo + torch.randint(-1, max(leaves // 4, 2), (65_536,),
                              generator=gen, device=cuda_device,
                              dtype=torch.int32)
    wval = torch.randint(0, 65_536, (65_536,), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    kernels.reset_counts()
    assert_launched_and_equal("rangemax4.cover",
                              S.min_cover4(leaves, wlo, whi, wval),
                              S.min_cover4_plain(leaves, wlo, whi, wval))
    assert kernels.COUNTS["rangemax4.cover"] == 1


def test_short_span_streams_match_cpu_plain_path(cuda_device):
    """short_span_limit on the tiered path (batch by batch) and the
    classic path (groups of 4): the card equals the CPU plain path and
    the same config at S = 0, field for field and tier for tier; kernels
    K and L launch, kernel C (min_cover) and G (rangemax2) do not."""
    n = 1024
    for classic in (False, True):
        cfg = KernelConfig(max_key_bytes=8, max_txns=n, max_reads=n,
                           max_writes=n, history_capacity=24 * n,
                           delta_capacity=0 if classic else 12 * n,
                           window_versions=5000, compact_interval=3,
                           short_span_limit=8)
        rng = np.random.default_rng(13)
        batches = [skiplist_style_batch(rng, cfg, n, version=1000 * (i + 1),
                                        keyspace=4000, snapshot_lag=2000)
                   for i in range(8)]
        gpu = make_conflict_set(cfg, "cuda", device=cuda_device)
        cpu = make_conflict_set(cfg, "cuda", device="cpu")
        general = make_conflict_set(cfg.scaled(short_span_limit=0), "cuda",
                                    device=cuda_device)
        launched = dict.fromkeys(kernels.KERNELS, 0)
        for lo in range(0, 8, 4):
            stacked = stack_device_args(batches[lo:lo + 4])
            kernels.reset_counts()
            got = gpu.resolve_group_args(stacked)
            for name, c in kernels.counts().items():
                launched[name] += c
            want = cpu.resolve_group_args(stacked)
            ref = general.resolve_group_args(stacked)
            for f in want._fields:
                assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
                assert torch.equal(getattr(got, f), getattr(ref, f)), f
        for a, b in zip(flat_state(gpu), flat_state(cpu)):
            assert np.array_equal(a, b)
        assert not bool(got.overflow.any())
        for name in ("short_span.range", "short_span.apply", "sort_ranks"):
            assert launched[name] > 0, name
        for name in ("min_cover", "rangemax2.build", "rangemax2.query"):
            assert launched[name] == 0, name


# ---------------------------------------------------------------------------
# the staging pipeline and the Resolver role on the card

def pipeline_config(classic: bool, n: int = 1024):
    return KernelConfig(max_key_bytes=8, max_txns=n, max_reads=n,
                        max_writes=n, history_capacity=24 * n,
                        delta_capacity=0 if classic else 12 * n,
                        window_versions=5000, compact_interval=4)


def pipeline_batches(cfg, n_batches, seed=17, n=1024):
    rng = np.random.default_rng(seed)
    return [skiplist_style_batch(rng, cfg, n, version=1000 * (i + 1),
                                 keyspace=6000, snapshot_lag=2000)
            for i in range(n_batches)]


@pytest.mark.parametrize("classic", [False, True])
def test_pipelined_stream_equals_per_group_dispatch(cuda_device, classic):
    """resolve_stream_pipelined (pinned ring, copy stream, events) and
    resolve_group_stream on the card: every field of every chunk equal
    to the same groups dispatched one by one (`resolve_group_args` on
    numpy args: the pageable path), and the history equal."""
    cfg = pipeline_config(classic)
    batches = pipeline_batches(cfg, 12)
    groups = [stack_device_args(batches[i:i + 4]) for i in range(0, 12, 4)]
    ref = make_conflict_set(cfg, "cuda", device=cuda_device)
    want = [ref.resolve_group_args(g) for g in groups]
    for api in ("stream", "groups"):
        cs = make_conflict_set(cfg, "cuda", device=cuda_device)
        got = (cs.resolve_stream_pipelined(batches, chunk=4, depth=2)
               if api == "stream" else cs.resolve_group_stream(groups))
        for g, w in zip(got, want):
            for f in w._fields:
                assert torch.equal(getattr(g, f), getattr(w, f)), (api, f)
        for a, b in zip(flat_state(cs), flat_state(ref)):
            assert np.array_equal(a, b)
        assert cs.metrics.counters.get("stagedChunks") == 3


def test_staged_source_buffers_are_pinned(cuda_device):
    cfg = pipeline_config(False)
    batches = pipeline_batches(cfg, 7)
    cs = make_conflict_set(cfg, "cuda", device=cuda_device)
    cs.resolve_stream_pipelined(batches[:6], chunk=2, depth=2)
    stager = cs._staging
    assert stager.n_slots == 3 and stager.stream is not None
    assert len(stager.slots) == 3
    assert all(slab.is_pinned() for slab in stager.slots)
    assert stager.stream != torch.cuda.current_stream(cuda_device)
    # a smaller chunk (the stream's last) reuses the slabs it finds
    slabs = [slab.data_ptr() for slab in stager.slots]
    cs.resolve_stream_pipelined(batches[6:], chunk=2, depth=2)
    assert [slab.data_ptr() for slab in stager.slots] == slabs


def test_many_chunks_at_depth_2_stay_exact(cuda_device):
    """48 chunks of one batch through a ring of 3 pinned slots: the
    copies run ahead on their stream while compute frees and the
    caching allocator reuses the staged tensors; every chunk equals the
    same batch resolved alone on the default stream."""
    cfg = pipeline_config(False, n=512)
    batches = pipeline_batches(cfg, 48, seed=23, n=512)
    ref = make_conflict_set(cfg, "cuda", device=cuda_device)
    want = [ref.resolve_packed(b) for b in batches]
    cs = make_conflict_set(cfg, "cuda", device=cuda_device)
    got = cs.resolve_stream_pipelined(batches, chunk=1, depth=2)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        for f in w._fields:
            assert torch.equal(getattr(g, f)[0], getattr(w, f)), (i, f)
    for a, b in zip(flat_state(cs), flat_state(ref)):
        assert np.array_equal(a, b)


def test_overflow_leaves_no_staging_thread(cuda_device):
    import threading

    from foundationdb_tpu_torch import HistoryOverflowError
    from foundationdb_tpu_torch.models.conflict_set import (
        OVERFLOW_CHECK_INTERVAL,
    )
    from foundationdb_tpu_torch.models.types import CommitTransaction
    from foundationdb_tpu_torch.utils.packing import pack_batch

    cfg = KernelConfig(max_key_bytes=8, max_txns=8, max_reads=8,
                       max_writes=8, history_capacity=64, delta_capacity=8,
                       compact_interval=0, window_versions=100_000)
    batches = [pack_batch([CommitTransaction(
        [], [(bytes([(3 * j + i) % 250]), bytes([(3 * j + i) % 250, 1]))],
        read_snapshot=50) for j in range(8)], 100 + i, 0, cfg)
        for i in range(3 * OVERFLOW_CHECK_INTERVAL)]
    cs = make_conflict_set(cfg, "cuda", device=cuda_device)
    with pytest.raises(HistoryOverflowError):
        cs.resolve_stream_pipelined(batches, chunk=1, check_latch=False)
    assert not [t for t in threading.enumerate()
                if t.name == "resolver-staging"]


def test_resolver_role_on_the_card(cuda_device):
    """Resolver(backend="cuda") builds a TorchConflictSet on the card,
    and the knob-routed one does at the min batch; both answer a stream
    as the CPU plain path's Resolver does."""
    from foundationdb_tpu_torch.models.conflict_set import TorchConflictSet
    from foundationdb_tpu_torch.models.types import (
        CommitTransaction,
        ResolveTransactionBatchRequest,
    )
    from foundationdb_tpu_torch.resolver import Resolver
    from foundationdb_tpu_torch.runtime.flow import Scheduler
    from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS

    cfg = pipeline_config(True, n=256)
    rng = np.random.default_rng(4)

    def key(i):  # 7 bytes: a point write's end adds one
        return int(i).to_bytes(7, "big")

    reqs, prev = [ResolveTransactionBatchRequest(-1, 0, -1)], 0
    for b in range(6):
        version = 1000 * (b + 1)
        txns = [CommitTransaction(
            [(key(k), key(k + 2))], [(key(w), key(w) + b"\0")],
            read_snapshot=version - 1500, report_conflicting_keys=True)
            for k, w in rng.integers(0, 300, (256, 2))]
        reqs.append(ResolveTransactionBatchRequest(prev, version, prev, txns,
                                                   proxy_id="p0"))
        prev = version

    def run(res):
        sched = res.sched
        out = []
        for r in reqs:
            t = sched.spawn(res.resolve(r))
            out.append(sched.run_until(t.done))
        return [(o.committed, o.conflicting_key_range_map) for o in out]

    want = run(Resolver(Scheduler(), cfg, backend="cuda", device="cpu"))
    res = Resolver(Scheduler(), cfg, backend="cuda")
    assert isinstance(res.conflict_set, TorchConflictSet)
    assert res.conflict_set.device.type == "cuda"
    assert run(res) == want
    old = SERVER_KNOBS.RESOLVER_CUDA_MIN_BATCH
    SERVER_KNOBS.RESOLVER_CUDA_MIN_BATCH = cfg.max_txns
    try:
        routed = Resolver(Scheduler(), cfg)
        assert run(routed) == want
    finally:
        SERVER_KNOBS.RESOLVER_CUDA_MIN_BATCH = old
    assert isinstance(routed.conflict_set, TorchConflictSet)
    assert routed.conflict_set.device.type == "cuda"
    assert any(v == 0 for c, _ in want for v in c)


def test_prewarm_records_the_compile_stage(cuda_device):
    cfg = pipeline_config(False)
    cs = make_conflict_set(cfg.scaled(fixpoint_latch=True), "cuda",
                           device=cuda_device)
    cs.prewarm_exact(None)
    assert cs.metrics.compile.count == 1
    assert cs.metrics.counters.get("warmCompiles") == 1
    q = cs.metrics.qos()
    assert q["compile_seconds"] > 0.0
    stats = kernels.build_stats()
    assert stats["cache_hits"] + stats["cache_misses"] == len(kernels.SOURCES)


def wire_txns(rng, version: int, n: int = 256):
    def key(i):  # 7 bytes: a point write's end adds one
        return int(i).to_bytes(7, "big")

    from foundationdb_tpu_torch.models.types import CommitTransaction

    return [CommitTransaction(
        [(key(k), key(k + 3))], [(key(w), key(w) + b"\0")],
        read_snapshot=version - 1500, report_conflicting_keys=bool(k % 2))
        for k, w in rng.integers(0, 400, (n, 2))]


def test_resolve_columnar_equals_resolve_on_the_card(cuda_device):
    from foundationdb_tpu_torch.utils import packing

    for classic in (False, True):
        cfg = pipeline_config(classic, n=256)
        a = make_conflict_set(cfg, "cuda", device=cuda_device)
        b = make_conflict_set(cfg, "cuda", device=cuda_device)
        rng = np.random.default_rng(12)
        conflicts = 0
        for i in range(6):
            version = 1000 * (i + 1)
            txns = wire_txns(rng, version)
            got = a.resolve_columnar(packing.pack_columnar(txns), version)
            want = b.resolve(txns, version)
            assert got.verdicts == want.verdicts
            assert got.conflicting_key_ranges == want.conflicting_key_ranges
            conflicts += sum(int(v) == 0 for v in got.verdicts)
        assert conflicts
        assert a.metrics.counters.get("columnarBatches") == 6
        assert b.metrics.counters.get("columnarBatches") == 0


def test_wire_resolver_child_on_the_card(cuda_device, tmp_path):
    """A spawned "cuda" resolver process answers 16 columnar requests as
    an in-process TorchConflictSet on the card does; its status reports
    the 16 columnar batches and its warm-up's compile sample."""
    import asyncio
    import json

    from foundationdb_tpu_torch.cluster import multiprocess as mp
    from foundationdb_tpu_torch.config import KernelConfig
    from foundationdb_tpu_torch.utils import packing
    from foundationdb_tpu_torch.wire import codec

    kernels.build_all()  # the child loads what the parent built
    cfg = KernelConfig(max_key_bytes=16, max_txns=256, max_reads=512,
                       max_writes=512, history_capacity=4096,
                       window_versions=5000)
    bare = make_conflict_set(cfg, "cuda", device=cuda_device)
    rng = np.random.default_rng(13)
    stream = [(wire_txns(rng, 1000 * (i + 1)), 1000 * (i + 1))
              for i in range(16)]
    proc = mp.spawn_role("resolver", str(tmp_path), backend="cuda",
                         env={"RESOLVER_KERNEL": repr(cfg)})

    async def go():
        conn = await mp.connect(proc.address, proc=proc)
        try:
            prev = -1
            for txns, version in stream:
                rep = await conn.call(mp.TOKEN_RESOLVE,
                                      codec.ResolveBatchColumnar(
                                          prev, version, prev,
                                          packing.pack_columnar(txns)))
                want = bare.resolve(txns, version)
                assert rep.committed == want.verdicts
                assert (rep.conflicting_key_range_map
                        == want.conflicting_key_ranges)
                prev = version
            st = json.loads((await conn.call(
                mp.TOKEN_STATUS, mp.StatusRequest(pad=0))).payload)
        finally:
            await conn.close()
        return st

    try:
        st = asyncio.run(go())
    finally:
        proc.stop()
    stages = st["qos"]["kernel_stages"]
    assert st["backend"] == "cuda"
    assert stages["columnarBatches"] == 16
    assert stages["compileSeconds"]["count"] == 1
    assert stages["warmCompiles"] == 1
    assert st["qos"]["resolve_path"]["copies"] == 32
    assert sum(st["kernel_launches"].values()) > 0
