"""Kernel K's apply entry (one short-span fixpoint application) against
the JAX package on the CPU.

Inputs are numpy (seeded generators, `testing/span_cases.py`), fed to
both packages; every output is an int32 or a bool, so the tolerance is
equality throughout:

* `ss_apply` (on CPU tensors its plain version, `ss_range_plain` over
  `ss_cover_plain`) against a jnp transcription of the JAX program's
  short-span cover (foundationdb_tpu/ops/group.py:513-519) followed by
  its `direct_range_op` min (:353-363), at S in {1, 2, 4, 8}, on every
  case of span_cases at W = 3 and 5 inside the JAX program's domain, each
  application of a case in a row, and against a numpy transcription of
  the port's contract on those and on `PORT_ONLY` (write positions below
  0, dropped where JAX's scatter would wrap them);
* `resolve_group(short_span_limit=S)` at G = 1 and 8 against JAX
  `resolve_group(short_span_limit=S)` on one stream of keys drawn from
  span_cases' byte alphabet (at S = 2 the group of 8 trips the span
  latch, elsewhere nothing does), every GroupVerdict field and the
  history, and against the port at S = 0 where no span trips the latch;
* the wrapper's argument checks.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import rangemax as JR
from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.ops import group as G
from foundationdb_tpu_torch.testing import span_cases as SC
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import packing

from test_torch_group import assert_same_out, assert_same_state
from test_torch_short_span import TCFG, run_both, run_port

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

SPANS = (1, 2, 4, 8)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def jax_apply(leaves, wlo, whi, val, qlo, qhi, span):
    """foundationdb_tpu/ops/group.py:513-519, then direct_range_op
    (:353-363) with op min, written out."""
    flat = jnp.full((leaves + 1,), JR.INT32_POS, jnp.int32)
    for d in range(span):
        pos = wlo + d
        idx = jnp.where(pos < whi, pos, leaves)
        flat = flat.at[idx].min(val)
    mw = flat[:leaves]
    acc = jnp.full(qlo.shape, JR.INT32_POS, jnp.int32)
    for d in range(span):
        pos = qlo + d
        v = mw[jnp.clip(pos, 0, leaves - 1)]
        acc = jnp.minimum(acc, jnp.where(pos < qhi, v, JR.INT32_POS))
    return acc


def contract_apply(leaves, wlo, whi, val, qlo, qhi, span):
    """The port's contract in numpy: as `jax_apply`, but a write position
    outside [0, leaves) is dropped (JAX's scatter wraps one below 0)."""
    flat = np.full(leaves, SC.INT32_POS, np.int64)
    for d in range(span):
        pos = wlo.astype(np.int64) + d
        keep = (pos < whi) & (pos >= 0) & (pos < leaves)
        np.minimum.at(flat, pos[keep], val[keep])
    acc = np.full(qlo.shape, SC.INT32_POS, np.int64)
    for d in range(span):
        pos = qlo.astype(np.int64) + d
        v = flat[np.clip(pos, 0, leaves - 1)]
        acc = np.minimum(acc, np.where(pos < qhi, v, SC.INT32_POS))
    return acc.astype(np.int32)


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("w", [3, 5])
@pytest.mark.parametrize(
    "name", [n for n in SC.NAMES if n not in SC.PORT_ONLY])
def test_apply_matches_jax(name, w, span):
    c = SC.span_case(name, w)
    assert c.leaves >= 2 * (SC.READS + SC.WRITES)
    for i, val in enumerate(c.vals):
        want = jax_apply(c.leaves, *(jnp.asarray(x) for x in (
            c.wlo, c.whi, val, c.qlo, c.qhi)), span)
        got = G.ss_apply(c.leaves, t(c.wlo), t(c.whi), t(val), t(c.qlo),
                         t(c.qhi), span)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want)), \
            f"{name}, application {i}"
        assert np.array_equal(got.numpy(), contract_apply(
            c.leaves, c.wlo, c.whi, val, c.qlo, c.qhi, span))


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("w", [3, 5])
@pytest.mark.parametrize("name", SC.PORT_ONLY)
def test_apply_drops_write_positions_below_0(name, w, span):
    """Outside JAX's domain the port holds to its own contract: a write
    position below 0 is dropped, where JAX's scatter would wrap it onto
    the cover's end."""
    c = SC.span_case(name, w)
    val = c.vals[0]
    got = G.ss_apply(c.leaves, t(c.wlo), t(c.whi), t(val), t(c.qlo),
                     t(c.qhi), span)
    assert np.array_equal(got.numpy(), contract_apply(
        c.leaves, c.wlo, c.whi, val, c.qlo, c.qhi, span))


def test_cases_reach_their_edges():
    """Each case holds the edge it is named for (at W = 3)."""
    pos = SC.INT32_POS
    c = {n: SC.span_case(n) for n in SC.NAMES}
    e = c["leaf ends"]
    assert (e.wlo == 0).any() and (e.whi >= e.leaves).any()
    assert (e.qhi > e.leaves).any()
    p = c["past the leaves"]
    assert (p.wlo >= p.leaves).any() and (p.whi > p.leaves).any()
    assert (p.qlo < 0).any() and (p.qhi > p.leaves).any()
    b = c["writes below leaf 0"]
    below = (b.wlo < 0) & (b.vals[0] < pos)
    assert (below & (b.whi > 0)).any() and (below & (b.whi <= 0)).any()
    assert ((b.qlo <= 0) & (b.qhi > 0)).any()
    inv = c["inverted and empty"]
    assert (inv.whi < inv.wlo).any() and (inv.whi == inv.wlo).any()
    assert (inv.qhi <= inv.qlo).any()
    assert (c["none committed"].vals[0] == pos).all()
    hot = c["one hot leaf"]
    assert np.bincount(hot.wlo[hot.vals[0] < pos]).max() >= SC.HOT
    z = c["reads onto leaf 0"]
    assert ((z.wlo == 0) & (z.vals[0] < pos)).any()
    assert ((z.qlo < 0) & (z.qhi > z.qlo)).any()
    two = c["two in a row"].vals
    assert len(two) == 3
    assert ((two[0] < pos) & (two[1] == pos)).any()
    # the ranks come from keys: many writes share a rank with a read
    assert np.intersect1d(c["two in a row"].wlo, c["two in a row"].qlo).size


def test_apply_checks_its_arguments():
    a = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        G.ss_apply(16, a, a[:4], a, a, a + 1, 4)
    with pytest.raises(ValueError):
        G.ss_apply(16, a, a + 1, a, a, a[:4], 4)
    with pytest.raises(ValueError):
        G.ss_apply(0, a, a + 1, a, a, a + 1, 4)


# ---------------------------------------------------------------------------
# the group kernel at S on a stream of the alphabet's keys

def alphabet_range(rng):
    """A point range [k, k + b"\\x00") two times in three, else [k,
    k + b"\\xff") over k's extensions below 0xFF, k of 3 bytes or more
    (so the range holds few keys); k at most max_key_bytes - 1 bytes."""
    k = SC.draw_key(rng, 3)[:7]
    if rng.random() < 2 / 3:
        return k, k + b"\x00"
    k = (k + SC.draw_key(rng, 2) + b"\x01\x01\x01")[:7]
    return k, k + b"\xff"


def alphabet_group(rng, gn, base=1000, step=100, n_txns=12):
    return [packing.pack_batch([CommitTransaction(
        read_conflict_ranges=[alphabet_range(rng) for _ in range(
            int(rng.integers(0, 3)))],
        write_conflict_ranges=[alphabet_range(rng) for _ in range(
            1 + int(rng.integers(0, 2)))],
        read_snapshot=int(rng.integers(base - 2 * step,
                                       base + (i + 1) * step)))
        for _ in range(n_txns)], base + (i + 1) * step, 0, TCFG)
        for i in range(gn)]


@pytest.mark.parametrize("ss", [1, 2, 8])
@pytest.mark.parametrize("gn", [1, 8])
def test_alphabet_group_matches_jax(gn, ss):
    rng = np.random.default_rng(100 + 10 * gn + ss)
    pre = [alphabet_group(rng, 2, base=400)]
    batches = alphabet_group(rng, gn)
    (js, jo), (ts, to) = run_both(batches, ss, pre=pre)
    assert_same_out(to, jo, f"G={gn} S={ss}:")
    assert_same_state(ts, js)
    assert int(to.committed_count.sum()) > 0
    if not bool(to.overflow.any()):
        te, teo = run_port(batches, 0, pre=pre)
        for f in G.GroupVerdict._fields:
            assert torch.equal(getattr(to, f), getattr(teo, f)), f
        assert torch.equal(ts.main_ver, te.main_ver)
