"""Kernel A's query over a table of any depth, held against the JAX package
on the CPU.

The exact fixpoint asks kernel B for a min table of only
`ops/group.FIXPOINT_LEVELS` levels, and kernel A's query reads it exactly:
a span of at most 2^L by two lookups, a longer one by the long path over
the top level's entries. Here the port's plain versions run (the card runs
the kernels on the same constant):

* `build(levels=L)` + `query` against JAX `rangemax.build` (every level)
  + `rangemax.query`, for m in {1, 2, 5, 1023, 4099}, L in {1, 2, 3, 7, 8,
  every level}, max and min, on spans empty, inverted, from a negative
  `lo`, to a `hi` past m, of exactly 2^L and 2^L + 1, over the whole
  array, and random ones;
* `resolve_group` on uniform, zipf and YCSB-E batches and one whose reads
  span thousands of local ranks (the long path), at G = 1 and 8, against
  JAX's `resolve_group`, every output field and the history; also with
  FIXPOINT_LEVELS cut to 1 and 3, so every batch's reads go down the long
  path.

Inputs are seeded numpy arrays fed to both sides; every output is an
integer, so the tolerance is equality.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.config import KernelConfig as JaxConfig
from foundationdb_tpu.ops import group as JG
from foundationdb_tpu.ops import history as JH
from foundationdb_tpu.ops import rangemax as JR
from foundationdb_tpu_torch import interop
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.ops import group as G
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.ops import rangemax as R
from foundationdb_tpu_torch.testing import benchgen
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import packing

from test_torch_group import assert_same_out, assert_same_state

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()


def t(a) -> torch.Tensor:
    return interop.to_torch(np.asarray(a), "cpu")


def spans_for(rng, m: int, levels: int, n: int = 400):
    """lo, hi [n] int32: the edge spans (empty, inverted, a negative lo, a
    hi past m, exactly 2^L and 2^L + 1, the whole array, past both ends)
    at a few starts, then random ones of up to 2m."""
    edge = []
    for start in (0, 1, m // 3, max(m - 1, 0)):
        for length in (0, -1, 1 << levels, (1 << levels) + 1, 2, m):
            edge.append((start, start + length))
    edge += [(-3, 2), (-5, m + 7), (m - 2, m + 3), (0, m), (m, m + 1)]
    lo = rng.integers(-3, m + 3, size=n)
    hi = lo + rng.integers(-3, 2 * m + 3, size=n)
    lo[:len(edge)] = [a for a, _ in edge]
    hi[:len(edge)] = [b for _, b in edge]
    return lo.astype(np.int32), hi.astype(np.int32)


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("levels", [1, 2, 3, 7, 8, None])
@pytest.mark.parametrize("m", [1, 2, 5, 1023, 4099])
def test_query_over_a_cut_table_matches_jax(m, levels, op):
    rng = np.random.default_rng(1000 * m + (levels or 0))
    vals = rng.integers(-(2**31) + 1, 2**31 - 1, size=m).astype(np.int32)
    vals[::5] = JR.INT32_NEG if op == "max" else JR.INT32_POS
    tab_j = JR.build(jnp.asarray(vals), op=op)
    tab_t = R.build(t(vals), op=op, levels=levels)
    depth = R._num_levels(m) if levels is None else min(levels,
                                                        R._num_levels(m))
    assert tab_t.shape == (depth, m)
    assert np.array_equal(tab_t.numpy(), np.asarray(tab_j)[:depth])
    lo, hi = spans_for(rng, m, depth)
    want = JR.query(tab_j, jnp.asarray(lo), jnp.asarray(hi), op=op)
    got = R.query(tab_t, t(lo), t(hi), op=op)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_build_levels_are_clipped_and_checked():
    vals = t(np.arange(10, dtype=np.int32))
    assert R.build(vals, levels=99).shape == (R._num_levels(10), 10)
    assert R.build_plain(vals, op="min", levels=2).shape == (2, 10)
    with pytest.raises(ValueError):
        R.build(vals, levels=0)


# ---------------------------------------------------------------------------
# the group kernel against JAX's, at the fixpoint's depth and below it

def configs(n: int) -> tuple:
    kw = dict(max_key_bytes=8, max_txns=n, max_reads=n, max_writes=n,
              history_capacity=32 * n, window_versions=100_000)
    return KernelConfig(**kw), JaxConfig(**kw)


STEP = 1000


def batches_of(kind: str, n: int = 8) -> tuple:
    """(n batches, txns a batch): 256 txns of bench's uniform and zipf
    point streams and its YCSB-E scans over 2,000 keys (reads up to ~100
    local ranks), or ("long") 1,024 txns reading and writing 1,500 keys
    of 2,000, whose reads span thousands of local ranks: the query's long
    path."""
    rng = np.random.default_rng({"uniform": 1, "zipf": 2, "ycsb_e": 3,
                                 "long": 4}[kind])
    txns = 1024 if kind == "long" else 256
    cfg = configs(txns)[0]
    out = []
    for i in range(n):
        kw = dict(version=(i + 2) * STEP, snapshot_lag=2 * STEP)
        if kind == "ycsb_e":
            out.append(benchgen.ycsb_batch(rng, cfg, txns, "ycsb_e",
                                           keyspace=2000, scan_max=100,
                                           insert_frontier=1000 + txns * i,
                                           **kw))
        else:
            out.append(benchgen.skiplist_style_batch(
                rng, cfg, txns, keyspace=2000,
                range_len=1500 if kind == "long" else 1,
                zipf=1.1 if kind == "zipf" else 0.0, **kw))
    return out, txns


def local_read_spans(b) -> int:
    """The widest live read of a batch in local ranks (the dense ranks
    of its live endpoints), as the fixpoint's query reads it."""
    rv, wv = b.read_valid, b.write_valid
    pts = np.concatenate([b.read_begin[rv], b.read_end[rv],
                          b.write_begin[wv], b.write_end[wv]])
    inv = np.unique(pts, axis=0, return_inverse=True)[1].reshape(-1)
    n = int(rv.sum())
    return int((inv[n:2 * n] - inv[:n]).max())


@pytest.fixture(scope="module")
def jax_group():
    return jax.jit(JG.resolve_group)


def run_jax(jax_group, groups, txns: int):
    js, outs = JH.init(configs(txns)[1]), []
    for grp in groups:
        js, jo = jax_group(js, packing.stack_device_args(grp))
        outs.append(jo)
    return js, outs


def run_port(groups, txns: int):
    ts, outs = H.init(configs(txns)[0], "cpu"), []
    for grp in groups:
        ts, to = G.resolve_group(ts, interop.device_args_to_torch(
            packing.stack_device_args(grp), "cpu"))
        outs.append(to)
    return ts, outs


@pytest.mark.parametrize("gn", [1, 8])
@pytest.mark.parametrize("kind", ["uniform", "zipf", "ycsb_e", "long"])
def test_resolve_group_matches_jax(jax_group, monkeypatch, kind, gn):
    stream, txns = batches_of(kind)
    groups = [stream[i:i + gn] for i in range(0, len(stream), gn)]
    js, jouts = run_jax(jax_group, groups, txns)
    leaves = G._next_pow2(4 * txns)
    if kind == "long":   # the reads really take the long path
        assert max(local_read_spans(b) for b in stream) > 1000
    for levels in (G.FIXPOINT_LEVELS, 3, 1):
        assert levels < R._num_levels(leaves)   # a cut table
        monkeypatch.setattr(G, "FIXPOINT_LEVELS", levels)
        ts, touts = run_port(groups, txns)
        for k, (to, jo) in enumerate(zip(touts, jouts)):
            assert_same_out(to, jo, f"{kind} G={gn} L={levels} group {k}:")
        assert_same_state(ts, js)
