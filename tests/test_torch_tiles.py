"""Kernels B (`rangemax.build`) and C (`segtree.min_cover`) held against
the JAX package on the CPU at sizes past their tiles.

On the card each is one cooperative launch that builds or sweeps the low
levels a tile at a time in shared memory (B: 4,096 rows, C: 2,048 leaves)
and the levels above in passes over the whole table; here the port's
plain versions run, at the sizes and with the interval shapes where that
split shows: a tile less one, one, one more, many tiles; intervals of
every level, full-width ones and ones that straddle every tile boundary.
Inputs are seeded numpy arrays fed to both sides; every output is an
integer, so the tolerance is equality.

The last test drives a tiered stream whose writes include range clears
over thousands of the fixpoint's leaves (the bench streams write only
points, so no stream reaches C's levels above a tile) through
`TorchConflictSet` against JAX's `TpuConflictSet` and the oracle, keys
over the bytes {0x00, 0x01, 0x7F, 0x80, 0xFF}.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.config import KernelConfig as JaxConfig
from foundationdb_tpu.models.conflict_set import make_conflict_set as jax_make
from foundationdb_tpu.ops import rangemax as JR
from foundationdb_tpu.ops import segtree as JS
from foundationdb_tpu_torch import interop, make_conflict_set
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.models.types import (CommitTransaction,
                                                 TransactionResult)
from foundationdb_tpu_torch.ops import rangemax as R
from foundationdb_tpu_torch.ops import segtree as S
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads

from test_torch_lex_order import wide_key, wide_range
from test_torch_tiered import assert_state_equal

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

#: kernel B's and C's tiles on the card (rangemax_build.cu, min_cover.cu)
B_TILE = 4096
C_TILE = 2048


def t(a) -> torch.Tensor:
    return interop.to_torch(np.asarray(a), "cpu")


@pytest.mark.parametrize("m", [B_TILE - 1, B_TILE, B_TILE + 1,
                               2 * B_TILE + 1, 16 * B_TILE + 1])
@pytest.mark.parametrize("op", ["max", "min"])
def test_build_and_query_past_a_tile(op, m):
    rng = np.random.default_rng(m)
    vals = rng.integers(-(2**31) + 1, 2**31 - 1, size=m).astype(np.int32)
    vals[::7] = JR.INT32_NEG if op == "max" else JR.INT32_POS
    tab_j = JR.build(jnp.asarray(vals), op=op)
    tab_t = R.build(t(vals), op=op)
    assert tab_t.shape == (R._num_levels(m), m)
    assert np.array_equal(tab_t.numpy(), np.asarray(tab_j))
    # queries inside a tile, across tile edges, the whole width and empty
    n = 600
    lo = rng.integers(-3, m + 3, size=n).astype(np.int32)
    hi = (lo + rng.integers(-2, m, size=n)).astype(np.int32)
    edge = np.arange(B_TILE, m, B_TILE)[: n // 4]
    lo[: len(edge)], hi[: len(edge)] = edge - 5, edge + 3
    lo[-2:], hi[-2:] = (0, -1), (m, m + 4)
    want = JR.query(tab_j, jnp.asarray(lo), jnp.asarray(hi), op=op)
    got = R.query(tab_t, t(lo), t(hi), op=op)
    assert np.array_equal(got.numpy(), np.asarray(want))


def cover_intervals(rng, leaves: int, n: int):
    """lo, hi, val [n]: an interval at every level k at a random start
    (and at the start of a tile), one straddling every 2,048- and
    4,096-leaf boundary, full-width ones (one from lo < 0 to hi > leaves),
    the rest short or up to the whole width; a fifth of the values
    INT32_POS."""
    log = leaves.bit_length() - 1
    lo = rng.integers(-4, leaves + 4, n)
    length = np.concatenate([rng.integers(-2, 300, n // 2),
                             rng.integers(-2, leaves + 8, n - n // 2)])
    spans = 1 << np.arange(log + 1)
    cut = [(rng.integers(0, leaves - spans + 1), spans),
           ((np.arange(log + 1) * C_TILE) % leaves, spans)]
    edges = np.arange(C_TILE, leaves, C_TILE)
    cut.append((edges - rng.integers(1, 40, len(edges)),
                rng.integers(2, 2 * C_TILE, len(edges))))
    cut.append((np.array([0, -5, -1]), np.array([leaves, leaves + 10,
                                                 leaves + 1])))
    at = 0
    for starts, lens in cut:
        lo[at:at + len(starts)], length[at:at + len(starts)] = starts, lens
        at += len(starts)
    assert at <= n
    val = rng.integers(0, n, n)
    val[::5] = JR.INT32_POS
    return (lo.astype(np.int32), (lo + length).astype(np.int32),
            val.astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("leaves", [1 << 13, 1 << 15])
def test_min_cover_past_a_tile(leaves, seed):
    rng = np.random.default_rng(1000 * seed + leaves)
    lo, hi, val = cover_intervals(rng, leaves, 3000)
    want = JS.min_cover(leaves, jnp.asarray(lo), jnp.asarray(hi),
                        jnp.asarray(val))
    got = S.min_cover(leaves, t(lo), t(hi), t(val))
    assert np.array_equal(got.numpy(), np.asarray(want))
    # every level was written to, and a leaf is covered at each level
    k = np.floor(np.log2(np.maximum(np.clip(hi, 0, leaves)
                                    - np.clip(lo, 0, leaves), 1)))
    assert set(range(leaves.bit_length())) <= set(k.astype(int))


# ---------------------------------------------------------------------------
# a tiered stream with range clears over thousands of leaves

WIDE_KW = dict(max_key_bytes=8, max_txns=2048, max_reads=4096,
               max_writes=4096, history_capacity=32768, delta_capacity=16384,
               window_versions=1000, compact_interval=2)


def clearing_stream(rng, n_batches, n_txns=1280, base=1000, step=100):
    """Batches of txns with one or two reads and writes over the wide
    bytes, and in each batch a few range clears from the empty key to
    0xFF or past most of the keyspace, and a few wide reads."""
    out = []
    for i in range(n_batches):
        version = base + (i + 1) * step
        txns = []
        for j in range(n_txns):
            writes = [wide_range(rng, 8)
                      for _ in range(1 + int(rng.integers(0, 2)))]
            reads = [wide_range(rng, 8)
                     for _ in range(1 + int(rng.integers(0, 2)))]
            if j % 300 == 17:  # a clear of nearly every key
                writes = [(b"", b"\xff")]
            elif j % 300 == 131:  # a clear of a third of the keyspace
                writes = [(b"\x01", b"\x80" + wide_key(rng, 3))]
            if j % 100 == 50:
                reads.append((b"\x00\x7f", b"\xff\x00"))
            txns.append(CommitTransaction(
                read_conflict_ranges=reads, write_conflict_ranges=writes,
                read_snapshot=int(rng.integers(max(0, base - 2 * step),
                                               version)),
                report_conflicting_keys=bool(rng.random() < 0.3)))
        out.append((txns, version))
    return out


def test_range_clears_over_thousands_of_leaves_match_jax():
    tcfg, jcfg = KernelConfig(**WIDE_KW), JaxConfig(**WIDE_KW)
    port = make_conflict_set(tcfg, "cuda", device="cpu")
    jax_cs = jax_make(jcfg, "tpu-force")
    oracle = make_conflict_set(tcfg, "cpu")
    assert port.tiered
    rng = np.random.default_rng(77)
    aborted = committed = 0
    for txns, version in clearing_stream(rng, 4):
        # the clear of nearly every key spans thousands of the batch's
        # distinct endpoints: C's levels above a 2,048-leaf tile
        ends = [k for tx in txns for r in (tx.read_conflict_ranges
                                           + tx.write_conflict_ranges)
                for k in r]
        inside = len({k for k in ends if b"" < k < b"\xff"})
        assert inside > C_TILE
        got = port.resolve(txns, version)
        want = jax_cs.resolve(txns, version)
        ref = oracle.resolve(txns, version)
        assert got.verdicts == want.verdicts == ref.verdicts
        assert (got.conflicting_key_ranges == want.conflicting_key_ranges
                == ref.conflicting_key_ranges)
        committed += got.verdicts.count(TransactionResult.COMMITTED)
        aborted += got.verdicts.count(TransactionResult.CONFLICT)
        assert_state_equal(port.state, jax_cs.state)
    assert committed > 0 and aborted > 0
