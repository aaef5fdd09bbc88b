"""Kernel A's probe and kernel H's fold: seeded cases about their edges.

The probe (`ks_probe`, kernels/csrc/keysearch.cu) stages every 2^s-th row
of the tier (the fence, at most FENCE_BYTES) in shared memory and runs
the top levels of each search there, then at most s steps in the fence's
bucket in global memory. It finds the end from the begin: for rb < re
re's fence count comes by a gallop from rb's; where no fence row lies
between them the WINDOW rows after il are read at once, and a read past
them takes the rest of that bucket; across a fence row, re's own bucket;
a read with re <= rb takes the full search. The fold (`sf_fold`,
kernels/csrc/seg_fold.cu) paints each committed write's [wb, we)
directly (a thread up to THREAD_SPAN ranks, a warp up to GRID_SPAN, the
whole grid above it, at most MAX_WIDE of those), unless a committed row
is inverted, more than MAX_WIDE writes are wide or the writes paint more
than 2n ranks: then it counts the difference array as the JAX fold does.

Each probe case is a tier (keys [m, W] int32 bit patterns, sorted, with
a sentinel tail unless named otherwise; versions [m] int32) and READS
read ranges (rb, re [READS, W]) built to reach one of those parts, at
W = 3 or 5; keys are drawn from the bytes ALPHABET at every length from
0 to the width's max_key_bytes. Every case also holds forward reads of
every span, at least one past the JAX program's 4-boundary window (so
its probe takes its full-search branch, the formula the port's plain
version writes: its window branch answers an inverted or empty read
from the segment of its begin). Each fold case is a map (seg_ver [n]
int32), write ranks (wb, we [nw] int32), flags (cw [nw] bool) and a
version; FOLD_PATH names the part of the kernel it takes.

The card lane (tests/test_torch_cuda.py), chip_smoke.py's phase 2 and
the CPU tests (tests/test_torch_probe_fold.py) draw the same cases.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from foundationdb_tpu_torch.utils.packing import pack_keys

#: the byte set the keys are drawn from (ROADMAP queue 3's)
ALPHABET = (0x00, 0x01, 0x7F, 0x80, 0xFF)
#: kFenceBytes and kWindow in keysearch.cu
FENCE_BYTES = 12 * 1024
WINDOW = 4
#: kThreadSpan, kGridSpan and kMaxWide in seg_fold.cu
THREAD_SPAN = 16
GRID_SPAN = 1 << 15
MAX_WIDE = 128
#: rows and live rows of a case's tier, and reads a case holds
TIER = 40_000
LIVE = 30_000
READS = 2_048
NEG = -(2**31) + 1
SENT = 0xFFFFFFFF


class ProbeCase(NamedTuple):
    keys: np.ndarray   # [m, W] int32, sorted, sentinel tail
    ver: np.ndarray    # [m] int32
    rb: np.ndarray     # [READS, W] int32
    re: np.ndarray     # [READS, W] int32


class FoldCase(NamedTuple):
    seg_ver: np.ndarray  # [n] int32
    wb: np.ndarray       # [nw] int32
    we: np.ndarray       # [nw] int32
    cw: np.ndarray       # [nw] bool
    version: int


PROBE_NAMES = ("point reads", "fence rows", "past the window",
               "inverted in a segment", "inverted across segments",
               "tier ends", "dead rows", "empty reads", "full tier",
               "duplicate keys", "small tier")
#: each fold case and the part of sf_fold it takes
FOLD_PATH = {
    "points n=1": "count",
    "points n=4096": "paint",
    "mixed n=20000": "paint",
    "inverted overlapping": "count",
    "inverted uncommitted": "paint",
    "whole space": "paint",
    "rank n": "paint",
    "empty and uncommitted": "paint",
    "widths": "paint",
    "wide list full": "count",
    "wide list at its most": "paint",
    "over budget": "count",
    "negative ranks": "paint",
    "bench shape": "paint",
}
FOLD_NAMES = tuple(FOLD_PATH)
#: the fold cases the JAX fold is held to (its scatter wraps a negative
#: index where the port clamps it to 0; the paths' ranks are never < 0)
FOLD_JAX = tuple(n for n in FOLD_NAMES if n != "negative ranks")


def max_key_bytes(w: int) -> int:
    return 4 * (w - 1)


def fence_shift(m: int, w: int) -> int:
    """keysearch.cu's fence_shift: the least s with ceil(m / 2^s) rows of
    W words within FENCE_BYTES."""
    s = 0
    while -(-m // (1 << s)) * w * 4 > FENCE_BYTES:
        s += 1
    return s


def draw_keys(rng, n: int, w: int) -> list:
    """n distinct keys of ALPHABET bytes at every length 0 ..
    max_key_bytes(w), sorted (the packed order is the bytes' order)."""
    most = max_key_bytes(w)
    out = set()
    while len(out) < n:
        lens = rng.integers(0, most + 1, n)
        for ln in lens:
            out.add(bytes(ALPHABET[i] for i in
                          rng.integers(0, len(ALPHABET), int(ln))))
            if len(out) == n:
                break
    return sorted(out)


def succ(k: bytes) -> bytes:
    """The key right after k in FDB order."""
    return k + b"\x00"


def packed(keys: list, w: int) -> np.ndarray:
    """[len(keys), w] uint32; a key one byte past max_key_bytes (a
    successor) packs rounded up, as the packer packs read ends."""
    return pack_keys(keys, max_key_bytes(w), round_up=True)


def tier(rng, ks: list, m: int, w: int):
    """(keys [m, w] int32 with a sentinel tail, versions [m] int32: random
    over the live rows, every seventh NEG; NEG on the tail)."""
    keys = np.full((m, w), SENT, np.uint32)
    keys[: len(ks)] = packed(ks, w)
    ver = np.full((m,), NEG, np.int32)
    v = rng.integers(1_000, 6_000, len(ks)).astype(np.int32)
    v[::7] = NEG
    ver[: len(ks)] = v
    return keys.view(np.int32), ver


def filler(rng, ks: list, n: int) -> list:
    """n forward reads of every span over the tier's keys: point reads,
    reads of 1 .. 3,000 rows, one over the whole tier (past the JAX
    window, so its probe takes its full search)."""
    out = [(b"", b"\xff" * 40)]
    big = len(ks) - 1
    while len(out) < n:
        i = int(rng.integers(0, big))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            out.append((ks[i], succ(ks[i])))
        else:
            j = min(big, i + int(rng.integers(1, 3_000 if kind == 1 else 8)))
            out.append((ks[i], ks[j]) if kind == 1 else
                       (succ(ks[i]), succ(ks[j])))
    return out


def reads_of(rng, ks: list, pairs: list, w: int, dead: int = 0):
    """(rb, re) [READS, w] int32 of `pairs` (bytes, or None for the
    all-ones row), topped up with filler reads, `dead` all-ones rows
    spread among them."""
    pairs = pairs[: READS - dead - 8]
    pairs += filler(rng, ks, READS - dead - len(pairs))
    most = max_key_bytes(w)
    rb = np.full((READS, w), SENT, np.uint32)
    re = np.full((READS, w), SENT, np.uint32)
    slots = np.sort(rng.permutation(READS)[: READS - dead])
    for col, arr in ((0, rb), (1, re)):
        keys = [p[col] for p in pairs]
        real = [i for i, k in enumerate(keys) if k is not None]
        # keys past max_key_bytes + 1 (the whole-tier read's end) pack
        # rounded up like any read end
        arr[slots[real]] = pack_keys([keys[i][: most + 1] for i in real],
                                     most, round_up=True)
    return rb.view(np.int32), re.view(np.int32)


def probe_case(name: str, w: int = 3) -> ProbeCase:
    """The named probe case (PROBE_NAMES) at key width w, from a seed of
    its own."""
    rng = np.random.default_rng([PROBE_NAMES.index(name), w, 9])
    m, live = TIER, LIVE
    if name == "full tier":
        live = m
    if name == "small tier":
        m, live = 500, 350
    ks = draw_keys(rng, live + 1, w)[1:]   # never b"": reads precede row 0
    if name == "duplicate keys":
        dup = sorted(ks[: live // 2] + ks[: live // 2: 3])
        ks = sorted(dup + ks[live // 2:])[:live]
    keys, ver = tier(rng, ks, m, w)
    s = fence_shift(m, w)
    n = len(ks)
    pairs, dead = [], 0
    idx = rng.integers(1, n - 2, 400)
    if name == "point reads":
        new = draw_keys(rng, 600, w)
        pairs = [(ks[i], succ(ks[i])) for i in idx] + \
            [(k, succ(k)) for k in new]
    elif name == "fence rows":
        for f in range(0, n, 1 << s):
            lo, hi = max(f - 1, 0), min(f + 1, n - 1)
            far = min(f + 3 * (1 << s) + 5, n - 1)
            pairs += [(ks[f], succ(ks[f])), (ks[lo], ks[f]),
                      (ks[f], ks[hi]), (succ(ks[lo]), ks[f]),
                      (ks[max(f - (1 << s) - 3, 0)], ks[f]),
                      (ks[f], ks[far]), (succ(ks[lo]), succ(ks[f]))]
        rng.shuffle(pairs)
    elif name == "past the window":
        for span in (3, 4, 5, 6, 8, 9, 100, 255, 256, 257, 1_000,
                     3 << s, (3 << s) + 1, n - 3):
            for i in rng.integers(0, n - span - 1, 20):
                pairs += [(ks[i], ks[i + span]),
                          (succ(ks[i]), ks[i + span]),
                          (ks[i], succ(ks[i + span]))]
    elif name == "inverted in a segment":
        for i in rng.integers(1, n - 2, 1_000):
            a = succ(ks[i])
            b = succ(a)
            if len(b) <= max_key_bytes(w) and b < ks[i + 1]:
                pairs += [(b, a), (a, ks[i]), (b, ks[i])]
            pairs.append((succ(ks[i]), ks[i]))
    elif name == "inverted across segments":
        for i in idx:
            d = int(rng.integers(1, 12))
            pairs += [(ks[i + min(d, n - 1 - i)], ks[i]),
                      (succ(ks[min(i + d, n - 1)]), succ(ks[i]))]
        for i in rng.integers(0, n - 5_000, 50):
            pairs.append((ks[i + 4_000], ks[i]))
    elif name == "tier ends":
        first, last = ks[0], ks[-1]
        top = b"\xff" * max_key_bytes(w)
        pairs = [(b"", b"\x00"), (b"", first), (b"", succ(first)),
                 (first, succ(first)), (first, ks[1]), (ks[-2], last),
                 (last, succ(last)), (succ(last), top), (last, None),
                 (succ(last), None), (top, None), (None, None),
                 (b"", None), (first, None), (None, first), (None, b"")]
        pairs *= 40
    elif name == "dead rows":
        pairs = [(ks[i], succ(ks[i])) for i in idx]
        dead = READS // 3
    elif name == "empty reads":
        pairs = [(ks[i], ks[i]) for i in idx] + \
            [(succ(ks[i]), succ(ks[i])) for i in idx]
    elif name == "full tier":
        pairs = [(ks[i], succ(ks[i])) for i in idx] + [
            (ks[-1], None), (succ(ks[-1]), None), (None, None),
            (ks[-5], ks[-1]), (ks[-5], succ(ks[-1]))] * 20
    elif name == "duplicate keys":
        pairs = [(ks[i], succ(ks[i])) for i in idx] + \
            [(ks[i], ks[i + 1]) for i in idx] + \
            [(ks[i + 1], ks[i]) for i in idx]
    elif name == "small tier":
        pairs = [(ks[i], succ(ks[i])) for i in rng.integers(0, n, 300)] + \
            [(ks[i], ks[min(i + 40, n - 1)]) for i in rng.integers(0, n, 300)]
    else:
        raise ValueError(f"unknown probe case {name!r}")
    rb, re = reads_of(rng, ks, pairs, w, dead)
    return ProbeCase(keys, ver, rb, re)


def writes(rng, n: int, nw: int, lo: int, hi: int, commit: float = 0.7):
    """nw writes over [0, n): begins uniform, widths in [lo, hi) (negative
    widths inverted), a `commit` share committed."""
    wb = rng.integers(0, n, nw)
    we = np.clip(wb + rng.integers(lo, hi, nw), 0, n)
    return wb, we, rng.random(nw) < commit


def fold_case(name: str) -> FoldCase:
    """The named fold case (FOLD_NAMES), from a seed of its own."""
    rng = np.random.default_rng([FOLD_NAMES.index(name), 17])
    n, parts = 20_000, []
    if name == "points n=1":
        n = 1   # more committed ranks than 2n: the count
        wb = rng.integers(0, 2, 100)
        parts.append((wb, np.maximum(wb, rng.integers(0, 2, 100)),
                      rng.random(100) < 0.9))
    elif name == "points n=4096":
        n = 4_096
        parts.append(writes(rng, n, 3_000, 0, 4))
    elif name == "mixed n=20000":    # thread and warp widths
        parts.append(writes(rng, n, 3_000, 0, 25))
    elif name == "inverted overlapping":
        parts.append(writes(rng, n, 3_000, 0, 300))
        wb, we, _ = writes(rng, n, 40, 50, 2_000)
        parts.append((we, wb, np.ones(40, bool)))     # inverted, committed
        parts.append((np.array([n - 1, n, 5_000]), np.array([0, 10, 4_000]),
                      np.ones(3, bool)))
    elif name == "inverted uncommitted":
        parts.append(writes(rng, n, 3_000, 0, 20))
        wb, we, _ = writes(rng, n, 40, 50, 2_000)
        parts.append((we, wb, np.zeros(40, bool)))
    elif name == "whole space":
        n = 100_000
        parts.append(writes(rng, n, 3_000, 1, 3))
        parts.append((np.array([0]), np.array([n]), np.ones(1, bool)))
    elif name == "rank n":
        parts.append(writes(rng, n, 1_000, 1, 20))
        parts.append((np.array([n - 1, n, n, n - 300, n + 5, 7]),
                      np.array([n, n, n + 9, n + 3, n + 2, n + 50]),
                      np.ones(6, bool)))
    elif name == "empty and uncommitted":
        b = rng.integers(0, n + 1, 500)
        parts.append((b, b, np.ones(500, bool)))         # empty rows
        parts.append(writes(rng, n, 500, 1, 10, commit=1.0))
        parts.append((np.zeros(20, int), np.full(20, n), np.zeros(20, bool)))
    elif name == "widths":
        n = 200_000
        widths = np.array([1, 15, 16, 17, 31, 32, 33, 1_000, GRID_SPAN - 1,
                           GRID_SPAN, GRID_SPAN + 1])
        b = rng.integers(0, n - GRID_SPAN - 2, widths.shape[0])
        parts.append((b, b + widths, np.ones(widths.shape[0], bool)))
        parts.append(writes(rng, n, 3_000, 1, 3))
    elif name.startswith("wide list"):
        k = MAX_WIDE + (1 if name.endswith("full") else 0)
        n = k * (GRID_SPAN + 1) // 2 + 10     # within the 2n budget
        b = rng.integers(0, n - GRID_SPAN - 2, k)
        parts.append((b, b + GRID_SPAN + 1, np.ones(k, bool)))
    elif name == "over budget":
        n = 4_096
        parts.append(writes(rng, n, 600, 17, 40))
        parts.append(writes(rng, n, 100, 200, 400, commit=1.0))
    elif name == "negative ranks":
        parts.append(writes(rng, n, 2_000, 1, 40))
        parts.append((np.array([-5, -1, -300]), np.array([3, 0, -2]),
                      np.ones(3, bool)))
    elif name == "bench shape":
        n, nw = 8 * 262_144, 65_536
        parts.append(writes(rng, n, nw, 1, 2, commit=0.97))
    else:
        raise ValueError(f"unknown fold case {name!r}")
    wb = np.concatenate([p[0] for p in parts]).astype(np.int32)
    we = np.concatenate([p[1] for p in parts]).astype(np.int32)
    cw = np.concatenate([p[2] for p in parts]).astype(bool)
    order = rng.permutation(wb.shape[0])
    seg = rng.integers(-5, 50, n).astype(np.int32)
    seg[rng.random(n) < 0.5] = NEG
    return FoldCase(seg, wb[order], we[order], cw[order], 77)


def fold_path(c: FoldCase) -> str:
    """The part of sf_fold the case takes: "paint" or "count"."""
    n = c.seg_ver.shape[0]
    b = np.clip(c.wb.astype(np.int64), 0, n)[c.cw]
    e = np.clip(c.we.astype(np.int64), 0, n)[c.cw]
    span = np.maximum(e - b, 0)
    direct = (not (b > e).any() and int((span > GRID_SPAN).sum()) <= MAX_WIDE
              and int(span.sum()) <= 2 * n)
    return "paint" if direct else "count"
