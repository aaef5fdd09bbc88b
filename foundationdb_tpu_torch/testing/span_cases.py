"""Kernel K's apply entry: seeded cases about its edges.

`ss_apply` (kernels/csrc/short_span.cu) is one application of the
short-span fixpoint in one launch: each committed write mins its val into
at most S leaves of a cover, then each read takes the min over at most S
leaves of it. The cover outlives the launch: its 64-bit leaves carry the
stamp of the launch that wrote them, and a leaf of an older launch reads
as INT32_POS. So the edges are the cover's ends, the positions it drops
(past `leaves`, and below 0, where the JAX program's scatter would wrap:
PORT_ONLY), the reads' clamp onto leaves 0 and
`leaves - 1`, empty and inverted ranges, writes that write nothing, many
writers on one leaf, and applications in a row over the same ranges,
where the second must not see what the first wrote.

Each case is one batch's local ranks, as the group kernel gives them:
the dense ranks of the batch's live endpoint keys (reads' begins and
ends, then writes'), the keys drawn from ALPHABET at every length up to
the width's max_key_bytes (W = 3 or 5), a read or write a point range
[k, k + b"\\x00") or a range to another drawn key (inverted among them);
`leaves` the fixpoint's next_pow2(2 NR + 2 NW); and one or more val
vectors (the fixpoint's where(committed[txn], txn, INT32_POS) over the
writes' txns), one application each, in a row. Each case then edits the
ranks or vals to reach its edge.

The card lane (tests/test_torch_cuda.py) and the CPU tests
(tests/test_torch_span_apply.py) draw the same cases.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from foundationdb_tpu_torch.utils.packing import pack_keys

#: the byte set the keys are drawn from (tests/test_torch_lex_order.py's)
ALPHABET = (0x00, 0x01, 0x7F, 0x80, 0xFF)
INT32_POS = 2**31 - 1
#: txns, reads and writes of a case's batch
TXNS = 256
READS = 512
WRITES = 512
#: writers on the hot leaf
HOT = 300


class SpanCase(NamedTuple):
    leaves: int
    wlo: np.ndarray    # [WRITES] int32
    whi: np.ndarray    # [WRITES] int32
    vals: tuple        # of [WRITES] int32, one per application in a row
    qlo: np.ndarray    # [READS] int32
    qhi: np.ndarray    # [READS] int32


NAMES = ("leaf ends", "past the leaves", "inverted and empty",
         "none committed", "one hot leaf", "reads onto leaf 0",
         "two in a row", "writes below leaf 0")
#: the cases outside the JAX program's domain: a write position below 0,
#: which its scatter would wrap onto the cover's end and the port drops
#: (no resolver rank is below 0)
PORT_ONLY = ("writes below leaf 0",)


def max_key_bytes(w: int) -> int:
    return 4 * (w - 1)


def draw_key(rng, w: int) -> bytes:
    n = int(rng.integers(0, max_key_bytes(w) + 1))
    return bytes(ALPHABET[i] for i in rng.integers(0, len(ALPHABET), n))


def draw_ranges(rng, n: int, w: int) -> list:
    """n ranges: point ranges [k, k + b"\\x00") two times in three, else
    [k, k2) to another drawn key (inverted where k2 < k)."""
    out = []
    for _ in range(n):
        k = draw_key(rng, w)
        out.append((k, k + b"\x00") if rng.random() < 2 / 3
                   else (k, draw_key(rng, w)))
    return out


def dense_ranks(rows: np.ndarray) -> np.ndarray:
    """Each row's rank among the distinct rows, in key order ([P] int32):
    the rows are packed keys, whose order is their words' as unsigned."""
    _, inv = np.unique(rows, axis=0, return_inverse=True)
    return inv.reshape(-1).astype(np.int32)


def local_ranks(rng, w: int):
    """(leaves, wlo, whi, qlo, qhi): a batch's ranges of drawn keys as
    the group kernel's local ranks."""
    reads, writes = draw_ranges(rng, READS, w), draw_ranges(rng, WRITES, w)
    ends = ([r[0] for r in reads] + [r[1] for r in reads]
            + [x[0] for x in writes] + [x[1] for x in writes])
    # a successor past max_key_bytes packs rounded up, as read ends do
    rank = dense_ranks(pack_keys(ends, max_key_bytes(w), round_up=True))
    nr, nw = READS, WRITES
    leaves = 1 << (2 * nr + 2 * nw - 1).bit_length()
    return (leaves, rank[2 * nr:2 * nr + nw], rank[2 * nr + nw:],
            rank[:nr], rank[nr:2 * nr])


def txn_vals(rng, committed: float = 0.75) -> np.ndarray:
    """The writes' vals: their txn (ascending, as the packer lays the
    writes out), INT32_POS where the txn is not committed."""
    txn = np.sort(rng.integers(0, TXNS, WRITES)).astype(np.int32)
    live = rng.random(TXNS) < committed
    return np.where(live[txn], txn, INT32_POS).astype(np.int32)


def span_case(name: str, w: int = 3) -> SpanCase:
    """The named case (NAMES) at key width w, from a seed of its own."""
    rng = np.random.default_rng([NAMES.index(name), w, 10])
    leaves, wlo, whi, qlo, qhi = local_ranks(rng, w)
    vals = [txn_vals(rng)]
    wlo, whi, qlo, qhi = wlo.copy(), whi.copy(), qlo.copy(), qhi.copy()
    k = 16
    if name == "leaf ends":
        # writes from leaf 0 and up to the last leaf; reads over both
        # ends, some past the last leaf (clamped onto it)
        wlo[:k], whi[:k] = 0, rng.integers(1, 10, k)
        wlo[k:2 * k] = leaves - rng.integers(1, 5, k)
        whi[k:2 * k] = leaves - rng.integers(-2, 1, k)
        qlo[:k], qhi[:k] = 0, rng.integers(1, 6, k)
        qlo[k:2 * k] = leaves - rng.integers(1, 6, k)
        qhi[k:2 * k] = leaves + rng.integers(-1, 4, k)
        vals[0][: 2 * k] = rng.integers(0, TXNS, 2 * k)
    elif name == "past the leaves":
        # writes that start past the cover write nothing, writes across
        # its end write their part inside it; reads past either end
        wlo[:k] = leaves + rng.integers(-2, 5, k)
        whi[:k] = wlo[:k] + rng.integers(1, 9, k)
        qlo[:k] = leaves + rng.integers(-4, 1, k)
        qhi[:k] = qlo[:k] + rng.integers(1, 6, k)
        qlo[k:2 * k] = rng.integers(-6, 0, k)
        qhi[k:2 * k] = qlo[k:2 * k] + rng.integers(1, 8, k)
        vals[0][: 2 * k] = rng.integers(0, TXNS, 2 * k)
    elif name == "inverted and empty":
        inv_w = rng.random(WRITES) < 1 / 3
        whi[inv_w] = wlo[inv_w] - rng.integers(0, 4, int(inv_w.sum()))
        inv_r = rng.random(READS) < 1 / 3
        qhi[inv_r] = qlo[inv_r] - rng.integers(0, 4, int(inv_r.sum()))
    elif name == "none committed":
        vals[0][:] = INT32_POS
    elif name == "one hot leaf":
        # hundreds of writers on one leaf, every one committed, and reads
        # over it and its neighbours
        hot = int(np.median(wlo))
        wlo[:HOT], whi[:HOT] = hot, hot + 1
        vals[0][:HOT] = rng.permutation(TXNS * 2)[:HOT]
        qlo[:k], qhi[:k] = hot - rng.integers(0, 3, k), hot + rng.integers(
            1, 3, k)
    elif name == "reads onto leaf 0":
        # leaf 0 covered by real writes; reads starting below 0 read it
        # for each position below 0 (ss_range_plain's clamp)
        wlo[:4], whi[:4] = 0, 1
        vals[0][:4] = rng.integers(0, TXNS, 4)
        qlo[:k] = rng.integers(-8, 0, k)
        qhi[:k] = rng.integers(-2, 3, k)
    elif name == "writes below leaf 0":
        # writes that end at or before 0 write nothing, writes across 0
        # write their part from leaf 0; reads over leaf 0
        wlo[:k] = rng.integers(-9, 0, k)
        whi[:k] = wlo[:k] + rng.integers(1, 9, k)
        vals[0][:k] = rng.integers(0, TXNS, k)
        qlo[:k], qhi[:k] = rng.integers(-3, 1, k), rng.integers(1, 4, k)
    elif name == "two in a row":
        # the fixpoint's next application over the same ranges: fewer
        # committed, then one that commits some of those again; each
        # must see only its own vals
        nxt = np.where(rng.random(WRITES) < 0.5, INT32_POS, vals[0])
        vals += [nxt.astype(np.int32),
                 np.where(rng.random(WRITES) < 0.3, vals[0], nxt).astype(
                     np.int32)]
    return SpanCase(leaves, wlo.astype(np.int32), whi.astype(np.int32),
                    tuple(v.astype(np.int32) for v in vals),
                    qlo.astype(np.int32), qhi.astype(np.int32))
