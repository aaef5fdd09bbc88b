"""Sparse-table range-max/min: O(M log M) build, O(1) vectorized query.

Port of foundationdb_tpu/ops/rangemax.py (`build`, `query`): the doubling
table `t[k, i] = op(values[i : i + 2**k])`, clamped at the array end,
answers "op over [lo, hi)" with two lookups. The history probe uses the
max form over every level, the intra-batch fixpoint the min form over
only `ops/group.FIXPOINT_LEVELS` levels (`build(levels=L)`): `query`
reads a table of any depth exactly, a span past 2^L by the top level's
entries (its long path).

`build` is kernel B (kernels/csrc/rangemax_build.cu, the whole table in
one launch) and `query` is kernel A's query entry (kernels/csrc/
keysearch.cu) on CUDA tensors; `build_plain` / `query_plain` serve CPU tensors.
`flat_gather_selftest` checks both against numpy brute force before a
conflict set serves its first decision.

`build2` / `query2` (K14, the JAX package's two-level table) answer the
same exact queries over the group kernel's cross-batch map, which is
rebuilt once per batch at up to 2.1M leaves. On the card kernel G
(kernels/csrc/rangemax2.cu) builds the 32-row chunk maxima and a
doubling table over 1024-row superchunk maxima in one launch (its last
block builds the table), and its query entry reads a short range's own
rows, a wider one's partial chunks and superchunks from the values and
the chunk maxima. `build2_plain` / `query2_plain` keep the JAX
layout (the fine levels and the coarse table over the chunk maxima), so
the CPU tests hold them against the JAX functions directly; a structure
is queried on the device that built it.

`build4` / `query4` (K19, the JAX package's radix-4 table: half the
levels, four overlapping spans per query) are kernel M's build (kernel
B's one launch at radix 4, `rm4_build` in kernels/csrc/rangemax_build.cu)
and query (kernels/csrc/rangemax4.cu) on CUDA tensors and `build4_plain` /
`query4_plain` on CPU tensors. Only the reference's experiment scripts
reach them; no resolver path does.
"""

from __future__ import annotations

import numpy as np
import torch

from foundationdb_tpu_torch import kernels
from foundationdb_tpu_torch.device import resolve_device

INT32_NEG = -(2**31) + 1
INT32_POS = 2**31 - 1

_IDENT = {"max": INT32_NEG, "min": INT32_POS}


def _num_levels(m: int) -> int:
    return max(1, (m - 1).bit_length() + 1)


def _op(op: str):
    if op == "max":
        return torch.maximum
    if op == "min":
        return torch.minimum
    raise ValueError(op)


def _depth(m: int, levels) -> int:
    """The levels a table of m values gets: all of them (`_num_levels`)
    for None, else `levels` clipped to that; below 1 raises."""
    full = _num_levels(m)
    if levels is None:
        return full
    if levels < 1:
        raise ValueError(f"rangemax: levels {levels} < 1")
    return min(int(levels), full)


def build_plain(values: torch.Tensor, *, op: str = "max",
                levels: int | None = None) -> torch.Tensor:
    """Plain version of kernel B: values [M] int32 -> table [L, M], L =
    `_depth(M, levels)`."""
    fn = _op(op)
    m = values.shape[0]
    rows = [values]
    for k in range(1, _depth(m, levels)):
        prev = rows[-1]
        half = min(1 << (k - 1), m - 1)
        shifted = torch.cat([prev[half:], prev[-1:].expand(half)])
        rows.append(fn(prev, shifted))
    return torch.stack(rows)


def build(values: torch.Tensor, *, op: str = "max",
          levels: int | None = None) -> torch.Tensor:
    """The doubling table of `values` ([M] int32) -> [L, M] int32: every
    level (L = `_num_levels(M)`) for `levels` None, else the first
    `levels` of them (clipped to that; below 1 raises), a table `query`
    reads exactly all the same."""
    _op(op)
    if values.ndim != 1 or values.shape[0] < 1:
        raise ValueError(f"build: values shape {tuple(values.shape)}")
    m = values.shape[0]
    depth = _depth(m, levels)
    if values.device.type == "cpu":
        return build_plain(values, op=op, levels=depth)
    kernels.check_cuda("rangemax.build", values)
    table = torch.empty((depth, m), dtype=torch.int32, device=values.device)
    kernels.launch("rm_build", "rangemax_build", values, table, m, depth,
                   int(op == "min"))
    return table


def _floor_log2(n: torch.Tensor, max_levels: int) -> torch.Tensor:
    """floor(log2(n)) for n >= 1, clipped to [0, max_levels - 1].

    Exact for every int32 n: float64 holds n exactly, and frexp's
    exponent e (n = mantissa * 2**e, mantissa in [0.5, 1)) is
    floor(log2(n)) + 1.
    """
    k = torch.frexp(n.to(torch.float64)).exponent.to(torch.int64) - 1
    return k.clamp(0, max_levels - 1)


def query_plain(table: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, *,
                op: str = "max") -> torch.Tensor:
    """Plain version of kernel A's query entry: op over [lo, hi) per
    element, clamped to [0, M); the op identity where the range is
    empty. Exact over a table of any depth L: a span of at most 2^L takes
    two lookups at level min(floor(log2(span)), L - 1) (every span, over
    a full table); a longer one the level-(L - 1) entries at lo, lo +
    2^(L-1), ... and one at hi - 2^(L-1) (the long path)."""
    fn = _op(op)
    levels, m = table.shape
    loc = lo.to(torch.int64).clamp(0, m)
    hic = hi.to(torch.int64).clamp(0, m)
    length = torch.clamp(hic - loc, min=1)
    k = _floor_log2(length, levels)
    a = loc.clamp(0, m - 1)
    b = (hic - (torch.ones_like(k) << k)).clamp(0, m - 1)
    flat = table.reshape(-1)
    got = fn(flat[k * m + a], flat[k * m + b])
    long_ = (length > (1 << levels)).nonzero().squeeze(1)
    if long_.numel():
        got[long_] = _long_plain(flat[(levels - 1) * m:levels * m],
                                 loc[long_], hic[long_], levels, op)
    ident = torch.full_like(got, _IDENT[op])
    return torch.where(hic > loc, got, ident)


def _long_plain(top: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                levels: int, op: str) -> torch.Tensor:
    """op over [lo, hi) (spans past 2^levels, clamped) from the table's
    top level `top`: its entries at lo + j 2^(levels-1), the last moved
    back to hi - 2^(levels-1), gathered at once and reduced per query."""
    h = 1 << (levels - 1)
    n = (hi - lo + h - 1) // h
    owner = torch.repeat_interleave(torch.arange(lo.shape[0],
                                                 device=lo.device), n)
    j = torch.arange(owner.shape[0], device=lo.device) - (
        torch.cumsum(n, 0) - n)[owner]
    pos = torch.minimum(lo[owner] + j * h, hi[owner] - h)
    acc = torch.full(lo.shape, _IDENT[op], dtype=top.dtype, device=top.device)
    return acc.scatter_reduce(0, owner, top[pos],
                              reduce="amin" if op == "min" else "amax")


def query(table: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, *,
          op: str = "max") -> torch.Tensor:
    """op over table's base values on [lo, hi) per element -> [Q] int32."""
    _op(op)
    if table.ndim != 2 or lo.shape != hi.shape or lo.ndim != 1:
        raise ValueError("query: table [L, M] and lo, hi [Q] expected")
    if table.device.type == "cpu":
        return query_plain(table, lo, hi, op=op)
    kernels.check_cuda("rangemax.query", table, lo, hi)
    out = torch.empty(lo.shape, dtype=torch.int32, device=table.device)
    kernels.launch("ks_query", "keysearch.query", table, table.shape[0],
                   table.shape[1], lo, hi, lo.shape[0], int(op == "min"), out)
    return out


# ---------------------------------------------------------------------------
# K14: the two-level table

CHUNK_BITS = 5
CHUNK = 1 << CHUNK_BITS
#: rows per superchunk of kernel G's table (kSuper in rangemax2.cu)
SUPER = CHUNK * CHUNK
#: the most superchunks kernel G's one-launch build takes (kMaxSuper in
#: rangemax2.cu: its last block's two level buffers in shared memory)
MAX_SUPER = 16384


def build2_plain(values: torch.Tensor, *, op: str = "max"):
    """Plain version of the two-level build, in the JAX layout:
    (fine [CHUNK_BITS + 1, M2], coarse [Lc, M2 // CHUNK]), M2 the length
    padded up to a CHUNK multiple with the op identity; fine[k][i] = op
    over values[i : i + 2**k] (identity past M2), coarse = build over
    the chunk maxima fine[CHUNK_BITS][::CHUNK]."""
    fn = _op(op)
    ident = _IDENT[op]
    m = values.shape[0]
    m2 = -(-m // CHUNK) * CHUNK
    base = torch.cat([values, torch.full((m2 - m,), ident, dtype=values.dtype,
                                         device=values.device)])
    levels = [base]
    for k in range(1, CHUNK_BITS + 1):
        prev = levels[-1]
        half = 1 << (k - 1)
        shifted = torch.cat([prev[half:], torch.full(
            (half,), ident, dtype=prev.dtype, device=prev.device)])
        levels.append(fn(prev, shifted))
    fine = torch.stack(levels)
    coarse = build_plain(fine[CHUNK_BITS][::CHUNK].contiguous(), op=op)
    return fine, coarse


def query2_plain(tables, lo: torch.Tensor, hi: torch.Tensor, *,
                 op: str = "max") -> torch.Tensor:
    """Plain version of the two-level query against a build2_plain
    structure: spans <= CHUNK from the fine table; wider spans as the
    head chunk-span, the contained chunks (coarse) and the tail
    chunk-span, an overlapping cover, exact for max and min."""
    fine, coarse = tables
    fn = _op(op)
    m2 = fine.shape[1]
    loc = lo.to(torch.int64).clamp(0, m2)
    hic = hi.to(torch.int64).clamp(0, m2)
    length = torch.clamp(hic - loc, min=1)
    ks = _floor_log2(torch.clamp(length, max=CHUNK), CHUNK_BITS + 1)
    a = loc.clamp(0, m2 - 1)
    b = (hic - (torch.ones_like(ks) << ks)).clamp(0, m2 - 1)
    flat = fine.reshape(-1)
    top = CHUNK_BITS * m2
    short = fn(flat[ks * m2 + a], flat[ks * m2 + b])
    head = flat[top + a]
    tail = flat[top + (hic - CHUNK).clamp(0, m2 - 1)]
    c0 = (loc + CHUNK - 1) >> CHUNK_BITS
    c1 = hic >> CHUNK_BITS
    mid = query_plain(coarse, c0, c1, op=op)
    wide = fn(fn(head, tail), mid)
    out = torch.where(length <= CHUNK, short, wide)
    return torch.where(hic > loc, out, torch.full_like(out, _IDENT[op]))


_BUILD2_ARRIVE: dict = {}


def _build2_arrive(dev: torch.device) -> torch.Tensor:
    """Kernel G's build's arrival counter (one zeroed word; each launch's
    last block sets it back to 0) for `dev`'s current stream. Inside a
    CUDA graph's capture a new one is made every call, in the graph's
    memory, so a replay never shares a stream's counter."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros((1,), dtype=torch.int32, device=dev)
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    held = _BUILD2_ARRIVE.get(key)
    if held is None:
        held = _BUILD2_ARRIVE[key] = torch.zeros((1,), dtype=torch.int32,
                                                 device=dev)
    return held


def build2(values: torch.Tensor, *, op: str = "max"):
    """The two-level structure of `values` ([M] int32, M >= 1).

    On the card: (values, chunk maxima [ceil(M / CHUNK)], the doubling
    table [L, ceil(M / SUPER)] over the superchunk maxima), one launch of
    kernel G, for M up to MAX_SUPER * SUPER (16,777,216; past that it
    raises). On the CPU: build2_plain's JAX layout. Pass the result to
    query2 on the same device."""
    _op(op)
    if values.ndim != 1 or values.shape[0] < 1:
        raise ValueError(f"build2: values shape {tuple(values.shape)}")
    if values.device.type == "cpu":
        return build2_plain(values, op=op)
    kernels.check_cuda("rangemax.build2", values)
    m = values.shape[0]
    nc, ns = -(-m // CHUNK), -(-m // SUPER)
    if ns > MAX_SUPER:
        raise ValueError(
            f"build2: {m} values make {ns} superchunks; kernel G's build "
            f"takes at most {MAX_SUPER} ({MAX_SUPER * SUPER} values)")
    if values.data_ptr() % 16:   # kernel G reads whole 16-byte words
        values = values.clone()
    levels = _num_levels(ns)
    chunk = torch.empty((nc,), dtype=torch.int32, device=values.device)
    table = torch.empty((levels, ns), dtype=torch.int32, device=values.device)
    kernels.launch("rm2_build", "rangemax2.build", values, m, chunk, nc,
                   table, ns, levels, _build2_arrive(values.device),
                   int(op == "min"))
    return values, chunk, table


def query2(tables, lo: torch.Tensor, hi: torch.Tensor, *,
           op: str = "max") -> torch.Tensor:
    """Exact op over [lo, hi) per element against a build2 structure ->
    [Q] int32; the op identity where the range is empty."""
    _op(op)
    if lo.shape != hi.shape or lo.ndim != 1:
        raise ValueError("query2: a build2 structure and lo, hi [Q] expected")
    if tables[0].device.type == "cpu":
        return query2_plain(tables, lo, hi, op=op)
    if len(tables) != 3:
        raise ValueError("query2: not a structure build2 made on the card")
    values, chunk, table = tables
    kernels.check_cuda("rangemax.query2", values, chunk, table, lo, hi)
    m = values.shape[0]
    if (values.ndim != 1 or chunk.shape != (-(-m // CHUNK),)
            or table.ndim != 2 or table.shape[1] != -(-m // SUPER)):
        raise ValueError("query2: not a structure build2 made on the card")
    out = torch.empty(lo.shape, dtype=torch.int32, device=values.device)
    kernels.launch("rm2_query", "rangemax2.query", values, m, chunk,
                   chunk.shape[0], table, table.shape[1], lo, hi,
                   lo.shape[0], int(op == "min"), out)
    return out


# ---------------------------------------------------------------------------
# K19: the radix-4 table

def _num_levels4(m: int) -> int:
    """1 + #{k >= 1 : 4^(k-1) < m}: the levels build4 makes."""
    levels = 1
    while (1 << (2 * (levels - 1))) < m:
        levels += 1
    return levels


def build4_plain(values: torch.Tensor, *, op: str = "max") -> torch.Tensor:
    """Plain version of kernel M's build: values [M] -> table [L4, M],
    table[k, i] = op(values[i : i + 4**k]) clamped at the array end."""
    fn = _op(op)
    m = values.shape[0]
    levels = [values]
    for k in range(1, _num_levels4(m)):
        prev = levels[-1]
        s = min(1 << (2 * (k - 1)), m - 1)
        out = prev
        for j in (1, 2, 3):
            sh = min(j * s, m - 1)
            out = fn(out, torch.cat([prev[sh:], prev[-1:].expand(sh)]))
        levels.append(out)
    return torch.stack(levels)


def build4(values: torch.Tensor, *, op: str = "max") -> torch.Tensor:
    """The radix-4 table of `values` ([M] int32, M >= 1) -> [L4, M]."""
    _op(op)
    if values.ndim != 1 or values.shape[0] < 1:
        raise ValueError(f"build4: values shape {tuple(values.shape)}")
    if values.device.type == "cpu":
        return build4_plain(values, op=op)
    kernels.check_cuda("rangemax.build4", values)
    m = values.shape[0]
    table = torch.empty((_num_levels4(m), m), dtype=torch.int32,
                        device=values.device)
    kernels.launch("rm4_build", "rangemax4.build", values, table, m,
                   table.shape[0], int(op == "min"))
    return table


def query4_plain(table: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, *,
                 op: str = "max") -> torch.Tensor:
    """Plain version of kernel M's query: op over [lo, hi) per element by
    four overlapping spans of 4**k, k = floor(log4(length)); the op
    identity where the range is empty."""
    fn = _op(op)
    levels, m = table.shape
    loc = lo.to(torch.int64).clamp(0, m)
    hic = hi.to(torch.int64).clamp(0, m)
    length = torch.clamp(hic - loc, min=1)
    k = torch.clamp(_floor_log2(length, 2 * levels) >> 1, max=levels - 1)
    s = torch.ones_like(k) << (2 * k)
    flat = table.reshape(-1)
    out = None
    for j in range(4):
        idx = torch.minimum(loc + j * s, hic - s).clamp(0, m - 1)
        g = flat[k * m + idx]
        out = g if out is None else fn(out, g)
    ident = torch.full_like(out, _IDENT[op])
    return torch.where(hic > loc, out, ident)


def query4(table: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, *,
           op: str = "max") -> torch.Tensor:
    """op over a build4 table's base values on [lo, hi) -> [Q] int32."""
    _op(op)
    if table.ndim != 2 or lo.shape != hi.shape or lo.ndim != 1:
        raise ValueError("query4: table [L4, M] and lo, hi [Q] expected")
    if table.device.type == "cpu":
        return query4_plain(table, lo, hi, op=op)
    kernels.check_cuda("rangemax.query4", table, lo, hi)
    out = torch.empty(lo.shape, dtype=torch.int32, device=table.device)
    kernels.launch("rm4_query", "rangemax4.query", table, table.shape[0],
                   table.shape[1], lo, hi, lo.shape[0], int(op == "min"), out)
    return out


_SELFTEST_OK: set = set()


def flat_gather_selftest(m: int, *, queries: int = 8192, sample: int = 256,
                         force: bool = False, device=None) -> None:
    """Start-up check of `build` and `query` at m values against numpy
    brute force, once per (device, m) per process (K20, the JAX
    package's flat_gather_selftest, with the same seeded inputs).

    On the card it runs kernel B and kernel A's query entry at the
    history capacity; on the CPU the plain versions. `device` None means
    the card. Raises RuntimeError on a mismatch, so a conflict set never
    serves decisions from a table it cannot read back.
    """
    dev = resolve_device(device)
    key = (str(dev), int(m))
    if key in _SELFTEST_OK and not force:
        return
    rng = np.random.default_rng(0xC0FFEE)
    vals = rng.integers(0, 2**30, size=m).astype(np.int32)
    qlo = rng.integers(0, max(m - 1, 1), size=queries).astype(np.int32)
    qlen = rng.integers(1, max(m // 2, 2), size=queries).astype(np.int32)
    qhi = np.minimum(qlo + qlen, m).astype(np.int32)
    tab = build(torch.from_numpy(vals).to(dev), op="max")
    got = query(tab, torch.from_numpy(qlo).to(dev),
                torch.from_numpy(qhi).to(dev), op="max").cpu().numpy()
    for i in rng.integers(0, queries, size=sample):
        want = int(vals[qlo[i]:qhi[i]].max())
        if got[i] != want:
            raise RuntimeError(
                f"rangemax self-check failed at m={m} on {dev}: query "
                f"[{qlo[i]},{qhi[i]}) got {got[i]} want {want}; refusing "
                "to serve conflict decisions"
            )
    _SELFTEST_OK.add(key)
