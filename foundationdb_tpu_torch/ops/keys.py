"""Packed-key primitives: lexicographic compare, searchsorted, dense ranks.

Port of foundationdb_tpu/ops/keys.py. Keys are [..., W] rows of uint32
words (big-endian byte words, then the length word); the all-ones row is
the +inf sentinel. PyTorch holds the words as int32 bit patterns
(`SENTINEL_WORD == -1`); the plain versions widen them to zero-extended
int64 before comparing, because torch on the CPU lacks uint32 shifts,
`flip` and `searchsorted`, and the CUDA kernels read them as uint32.

`searchsorted` is kernel A's search entry on CUDA tensors
(kernels/csrc/keysearch.cu) and `searchsorted_plain` on CPU tensors.
"""

from __future__ import annotations

import torch

from foundationdb_tpu_torch import kernels

#: the all-ones word as an int32 bit pattern (0xFFFFFFFF)
SENTINEL_WORD = -1


def sentinel_like(n: int, key_words: int, device=None) -> torch.Tensor:
    """[n, W] int32 rows of +inf sentinel keys."""
    return torch.full((n, key_words), SENTINEL_WORD, dtype=torch.int32,
                      device=device)


def widen(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> zero-extended int64 (unsigned order)."""
    return words.to(torch.int64) & 0xFFFFFFFF


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a < b for packed keys; compares the trailing axis W.

    a, b: [..., W] int32 words (broadcastable). Returns [...] bool.
    """
    a, b = widen(a), widen(b)
    w = a.shape[-1]
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    res = torch.zeros(shape, dtype=torch.bool, device=a.device)
    # from the least-significant word up: a more-significant unequal word
    # overrides the verdict of the words after it
    for i in range(w - 1, -1, -1):
        ai, bi = a[..., i], b[..., i]
        res = torch.where(ai < bi, True, torch.where(ai > bi, False, res))
    return res


def lex_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


def searchsorted_plain(keys: torch.Tensor, queries: torch.Tensor, *,
                       side: str) -> torch.Tensor:
    """Plain version of kernel A's search: a vectorized binary search.

    keys: [M, W] sorted ascending (tail padded with sentinel);
    queries: [Q, W]. Returns [Q] int32 numpy.searchsorted indices.
    """
    if side not in ("left", "right"):
        raise ValueError(side)
    m = keys.shape[0]
    q = queries.shape[0]
    lo = torch.zeros((q,), dtype=torch.int64, device=queries.device)
    hi = torch.full((q,), m, dtype=torch.int64, device=queries.device)
    for _ in range(m.bit_length()):
        active = lo < hi
        mid = (lo + hi) >> 1
        mid_keys = keys[mid.clamp(0, m - 1)]
        if side == "left":
            go_right = lex_less(mid_keys, queries)     # keys[mid] < q
        else:
            go_right = ~lex_less(queries, mid_keys)    # keys[mid] <= q
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo.to(torch.int32)


def searchsorted(keys: torch.Tensor, queries: torch.Tensor, *,
                 side: str) -> torch.Tensor:
    """numpy.searchsorted over sorted packed keys: [Q] int32 indices.

    CPU tensors take the plain version; CUDA tensors launch kernel A's
    search entry (one thread per query, binary search in registers).
    """
    if side not in ("left", "right"):
        raise ValueError(side)
    if keys.ndim != 2 or queries.ndim != 2 or keys.shape[1] != queries.shape[1]:
        raise ValueError(f"searchsorted: shapes {tuple(keys.shape)} and "
                         f"{tuple(queries.shape)}")
    if keys.device.type == "cpu" and queries.device.type == "cpu":
        return searchsorted_plain(keys, queries, side=side)
    kernels.check_cuda("searchsorted", keys, queries)
    kernels.check_words("searchsorted", keys.shape[1])
    out = torch.empty((queries.shape[0],), dtype=torch.int32,
                      device=keys.device)
    kernels.launch("ks_search", "keysearch.search", keys, keys.shape[0],
                   keys.shape[1], queries, queries.shape[0],
                   int(side == "right"), out)
    return out


def lex_sort_perm(points: torch.Tensor) -> torch.Tensor:
    """Stable permutation sorting [P, W] packed keys lexicographically:
    one stable sort per word, least-significant word first."""
    wide = widen(points)
    perm = torch.arange(points.shape[0], device=points.device)
    for i in range(points.shape[1] - 1, -1, -1):
        _, idx = torch.sort(wide[perm, i], stable=True)
        perm = perm[idx]
    return perm


def dense_ranks(points: torch.Tensor) -> torch.Tensor:
    """[P] int32 dense rank of each row among the distinct rows of
    `points` ([P, W]): a lexicographic stable sort, a new-key flag, a
    cumsum, and the inverse permutation back to input order."""
    p = points.shape[0]
    perm = lex_sort_perm(points)
    s = points[perm]
    new = torch.ones((p,), dtype=torch.int32, device=points.device)
    if p > 1:
        new[1:] = torch.any(s[1:] != s[:-1], dim=-1).to(torch.int32)
    rank_sorted = torch.cumsum(new, 0, dtype=torch.int32) - 1
    ranks = torch.empty((p,), dtype=torch.int32, device=points.device)
    ranks[perm] = rank_sorted
    return ranks
