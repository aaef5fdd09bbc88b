"""Packed-key primitives: lexicographic compare, searchsorted, dense ranks.

Port of foundationdb_tpu/ops/keys.py. Keys are [..., W] rows of uint32
words (big-endian byte words, then the length word); the all-ones row is
the +inf sentinel. PyTorch holds the words as int32 bit patterns
(`SENTINEL_WORD == -1`); the plain versions widen them to zero-extended
int64 before comparing, because torch on the CPU lacks uint32 shifts,
`flip` and `searchsorted`, and the CUDA kernels read them as uint32.

`searchsorted` is kernel A's search entry on CUDA tensors
(kernels/csrc/keysearch.cu, one launch for a left, a right or both
indices) and `searchsorted_plain` on CPU tensors.
`lex_sort_perm` is kernel N (kernels/csrc/lex_order.cu, a radix sort of
the rows) on CUDA tensors and `lex_sort_perm_plain` (the library's stable
sort, one pass per word) on CPU tensors. `sort_ranks` (K17) is kernel N
for the order and kernel L (kernels/csrc/sort_ranks.cu) for the rest on
CUDA tensors, `sort_ranks_plain` on CPU tensors; `dense_ranks` is its
first output.
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


#: (W, device) -> [W] int64 3^(W-1) .. 3^0, the word weights of _lex_sign
_POW3: dict = {}


def _lex_sign(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[...] int64 whose sign is the order of widened rows a and b.

    Each word's sign s_i in {-1, 0, 1} is weighted by 3^(W-1-i): a word
    outweighs every word after it together ((3^k - 1) / 2 < 3^k), so the
    sum's sign is the first unequal word's (exact for W <= 39)."""
    key = (a.shape[-1], a.device)
    pow3 = _POW3.get(key)
    if pow3 is None:
        pow3 = _POW3[key] = 3 ** torch.arange(
            key[0] - 1, -1, -1, dtype=torch.int64, device=a.device)
    return (torch.sign(a - b) * pow3).sum(-1)


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a < b for packed keys; compares the trailing axis W.

    a, b: [..., W] int32 words (broadcastable). Returns [...] bool.
    """
    return _lex_sign(widen(a), widen(b)) < 0


def lex_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


#: searchsorted's sides: one index a query, or both (left, right)
SIDES = ("left", "right", "both")


def searchsorted_plain(keys: torch.Tensor, queries: torch.Tensor, *,
                       side: str):
    """Plain version of kernel A's search: a vectorized binary search.

    keys: [M, W] sorted ascending (tail padded with sentinel);
    queries: [Q, W]. Returns [Q] int32 numpy.searchsorted indices, or
    for side="both" the pair (left, right).
    """
    if side not in SIDES:
        raise ValueError(side)
    if side == "both":
        return (searchsorted_plain(keys, queries, side="left"),
                searchsorted_plain(keys, queries, side="right"))
    m = keys.shape[0]
    q = queries.shape[0]
    wide_keys, wide_q = widen(keys), widen(queries)
    lo = torch.zeros((q,), dtype=torch.int64, device=queries.device)
    hi = torch.full((q,), m, dtype=torch.int64, device=queries.device)
    for _ in range(m.bit_length()):
        active = lo < hi
        mid = (lo + hi) >> 1
        order = _lex_sign(wide_keys[mid.clamp(0, m - 1)], wide_q)
        # left: keys[mid] < q; right: keys[mid] <= q
        go_right = order < 0 if side == "left" else order <= 0
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo.to(torch.int32)


def searchsorted(keys: torch.Tensor, queries: torch.Tensor, *, side: str):
    """numpy.searchsorted over sorted packed keys: [Q] int32 indices, or
    for side="both" the pair (left, right) of [Q] int32 from one launch.

    CPU tensors take the plain version; CUDA tensors launch kernel A's
    search entry: the tier's fence in shared memory, a bucket search in
    global memory, and for "both" the rows equal to the query from one
    window load after the left index (tier_search.cuh).
    """
    if side not in SIDES:
        raise ValueError(side)
    if keys.ndim != 2 or queries.ndim != 2 or keys.shape[1] != queries.shape[1]:
        raise ValueError(f"searchsorted: shapes {tuple(keys.shape)} and "
                         f"{tuple(queries.shape)}")
    if keys.device.type == "cpu" and queries.device.type == "cpu":
        return searchsorted_plain(keys, queries, side=side)
    kernels.check_cuda("searchsorted", keys, queries)
    kernels.check_words("searchsorted", keys.shape[1])
    q = queries.shape[0]
    out = torch.empty(((2 if side == "both" else 1) * q,), dtype=torch.int32,
                      device=keys.device)
    kernels.launch("ks_search", "keysearch.search", keys, keys.shape[0],
                   keys.shape[1], queries, q, SIDES.index(side), out)
    return (out[:q], out[q:]) if side == "both" else out


def lex_sort_perm_plain(points: torch.Tensor):
    """Plain version of kernel N: one stable sort per word, least
    significant word first. Returns (perm [P] int32, points[perm])."""
    wide = widen(points)
    perm = torch.arange(points.shape[0], device=points.device)
    for i in range(points.shape[1] - 1, -1, -1):
        _, idx = torch.sort(wide[perm, i], stable=True)
        perm = perm[idx]
    return perm.to(torch.int32), points[perm]


def lex_sort_perm(points: torch.Tensor):
    """Stable lexicographic sort of [P, W] packed keys (W <= 16 on the
    card): (perm [P] int32, the sorted rows [P, W]); sorted row i is input
    row perm[i], equal rows in input order.

    CPU tensors take the plain version; CUDA tensors launch kernel N, one
    cooperative launch that allocates nothing (its scratch is allocated
    here) and raises if the card refuses it.
    """
    if points.ndim != 2:
        raise ValueError(f"lex_sort_perm: points [P, W], got "
                         f"{tuple(points.shape)}")
    if points.device.type == "cpu":
        return lex_sort_perm_plain(points)
    dev = kernels.check_cuda("lex_sort_perm", points)
    p, w = points.shape
    kernels.check_words("lex_sort_perm", w, kernels.MAX_ROW_WORDS)
    perm = torch.empty((p,), dtype=torch.int32, device=dev)
    srt = torch.empty_like(points)
    scratch = torch.empty((kernels.size("lo_scratch_words", p, w),),
                          dtype=torch.int32, device=dev)
    kernels.launch("lo_sort", "lex_order", points, p, w, srt, perm, scratch)
    return perm, srt


def sort_ranks_plain(points: torch.Tensor, valid: torch.Tensor = None):
    """Plain version of kernels N and L: see sort_ranks."""
    p, w = points.shape
    dev = points.device
    pts = points if valid is None else torch.where(
        valid[:, None], points, SENTINEL_WORD)
    perm, s = lex_sort_perm_plain(pts)
    new = torch.ones((p,), dtype=torch.bool, device=dev)
    if p > 1:
        new[1:] = torch.any(s[1:] != s[:-1], dim=-1)
    rank_sorted = torch.cumsum(new.to(torch.int32), 0, dtype=torch.int32) - 1
    sorted_valid = ~torch.all(s == SENTINEL_WORD, dim=-1)
    count = (new & sorted_valid).sum(dtype=torch.int32)
    ranks = torch.empty((p,), dtype=torch.int32, device=dev)
    ranks[perm] = rank_sorted
    unique_keys = sentinel_like(p, w, dev)
    unique_keys[rank_sorted[new].to(torch.int64)] = s[new]
    return ranks, unique_keys, count


def sort_ranks(points: torch.Tensor, valid: torch.Tensor = None):
    """Dense-rank all points in one lexicographic sort (K17).

    points: [P, W] packed keys; valid: [P] bool or None (all valid).
    Invalid points are replaced by the sentinel, so they sort last and
    share one trailing rank. Returns (ranks [P] int32 — the dense rank of
    each point among the distinct rows; unique_keys [P, W] — the distinct
    rows in ascending order, sentinel tail; unique_count [] int32 — the
    distinct rows that are not the sentinel), as the JAX sort_ranks.
    CUDA tensors run kernel N (the sort) and kernel L's two entries over
    its sorted rows; W runs to 16 there.
    """
    if points.ndim != 2 or (valid is not None
                            and valid.shape != points.shape[:1]):
        raise ValueError("sort_ranks: points [P, W], valid [P] expected")
    if points.device.type == "cpu":
        return sort_ranks_plain(points, valid)
    kernels.check_cuda("sort_ranks", points)
    if valid is not None:
        kernels.check_cuda("sort_ranks", valid, dtype=torch.bool)
        points = torch.where(valid[:, None], points, SENTINEL_WORD)
    p, w = points.shape
    kernels.check_words("sort_ranks", w, kernels.MAX_ROW_WORDS)
    dev = points.device
    if p == 0:
        return (torch.empty((0,), dtype=torch.int32, device=dev),
                sentinel_like(0, w, dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    perm, srt = lex_sort_perm(points)
    ranks = torch.empty((p,), dtype=torch.int32, device=dev)
    unique_keys = torch.empty_like(points)
    count = torch.empty((), dtype=torch.int32, device=dev)
    sums = torch.empty((kernels.size("sr_tiles", p),), dtype=torch.int32,
                       device=dev)
    kernels.launch("sr_heads", "sort_ranks", srt, p, w, sums)
    kernels.launch("sr_write", "sort_ranks", srt, perm, p, w, sums, ranks,
                   unique_keys, count)
    return ranks, unique_keys, count


def dense_ranks(points: torch.Tensor) -> torch.Tensor:
    """[P] int32 dense rank of each row among the distinct rows of
    `points` ([P, W]): sort_ranks' first output."""
    return sort_ranks(points)[0]
