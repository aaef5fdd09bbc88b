"""Device-resident MVCC write history: one tier of the conflict set state.

Port of foundationdb_tpu/ops/history.py. A tier is a piecewise-constant
map keyspace -> last-commit version, held as sorted boundary keys with
per-segment versions (the reference's version-annotated skip list,
fdbserver/SkipList.cpp, as flat arrays): `main_keys[i]` starts a segment
of version `main_ver[i]`, NEG before the first boundary, sentinel rows
at the tail.

* `query_reads_vmax` — the max version over the segments a read range
  intersects (the CheckMax contract, SkipList.cpp:695-759): kernel A's
  fused probe entry on CUDA tensors.
* `merge_maps` — the pointwise max of two maps with GC and canonical
  compaction (mergeWriteConflictRanges + removeBefore, SkipList.cpp:
  430-441, 576-608, and the delta -> main fold): kernel D's one-launch
  `mm_merge` entry on CUDA tensors.
* `merge_writes` — K16: overwrite the union of sorted run intervals
  with a version, GC and compact, row for row as the JAX program keeps
  its rows: kernel D's row-keeping mode (`mm_merge_writes`, one launch
  on `mm_merge`'s merge path and scratch) on CUDA tensors.

The CPU tensors take the plain versions beside them. `oldest` is a host
int (every floor comes from host-packed batch arguments); `overflow` is
a 0-d bool tensor on the state's device, latched by merges and read by
the host only where it already synchronises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from foundationdb_tpu_torch import kernels
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.ops import keys as K
from foundationdb_tpu_torch.ops import rangemax

VERSION_NEG = -(2**31) + 1


class VersionHistory(NamedTuple):
    main_keys: torch.Tensor   # [M, W] int32 words, sorted, sentinel tail
    main_ver: torch.Tensor    # [M] int32 — version of [key_i, key_{i+1})
    oldest: int               # MVCC floor offset the tier was GC'd at
    overflow: torch.Tensor    # [] bool — some merge exceeded capacity


def empty(capacity: int, key_words: int, device, oldest: int = VERSION_NEG
          ) -> VersionHistory:
    return VersionHistory(
        main_keys=K.sentinel_like(capacity, key_words, device),
        main_ver=torch.full((capacity,), VERSION_NEG, dtype=torch.int32,
                            device=device),
        oldest=oldest,
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


def init(config: KernelConfig, device) -> VersionHistory:
    return empty(config.history_capacity, config.key_words, device)


def boundary_count(state: VersionHistory) -> torch.Tensor:
    """[] int64 live (non-sentinel) rows of one tier."""
    live = ~torch.all(state.main_keys == K.SENTINEL_WORD, dim=-1)
    return live.sum()


# ---------------------------------------------------------------------------
# K4: the history probe

def query_reads_vmax_plain(keys: torch.Tensor, table: torch.Tensor,
                           rb: torch.Tensor, re: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel A's probe entry."""
    il = K.searchsorted_plain(keys, rb, side="right") - 1
    ir = K.searchsorted_plain(keys, re, side="left") - 1
    return rangemax.query_plain(table, torch.clamp(il, min=0), ir + 1,
                                op="max")


def query_reads_vmax(state: VersionHistory, rb: torch.Tensor,
                     re: torch.Tensor, table: torch.Tensor = None
                     ) -> torch.Tensor:
    """[Q] int32: max version over history segments intersecting
    [rb, re) per read range (before the snapshot compare).

    il = search_right(rb) - 1, ir = search_left(re) - 1, then a max
    query over [max(il, 0), ir + 1). `table` is the prebuilt range-max
    table of `state.main_ver` (built here when None).
    """
    keys = state.main_keys
    if table is None:
        table = rangemax.build(state.main_ver, op="max")
    if rb.shape != re.shape or rb.ndim != 2 or rb.shape[1] != keys.shape[1]:
        raise ValueError("query_reads_vmax: rb, re must be [Q, W]")
    if keys.device.type == "cpu":
        return query_reads_vmax_plain(keys, table, rb, re)
    kernels.check_cuda("query_reads_vmax", keys, table, rb, re)
    kernels.check_words("query_reads_vmax", keys.shape[1])
    out = torch.empty((rb.shape[0],), dtype=torch.int32, device=keys.device)
    kernels.launch("ks_probe", "keysearch.probe", keys, keys.shape[0],
                   keys.shape[1], table, table.shape[0], rb, re, rb.shape[0],
                   out)
    return out


# ---------------------------------------------------------------------------
# K7(j) / K9: the map merge

def merge_maps_plain(a_keys, a_val, b_keys, b_val, *, floor: int,
                     capacity: int):
    """Plain version of kernel D: (keys [cap, W], ver [cap], count []).

    Mark: per input row (A rows, then B rows) its merge position, value
    in force and keep flag; then an exclusive scan of the keep flags in
    merge order gives each kept row its output slot.
    """
    na, nb = a_keys.shape[0], b_keys.shape[0]
    dev = a_val.device
    rows = torch.cat([a_keys, b_keys])
    own_a = torch.arange(na + nb, device=dev) < na
    idx = torch.cat([torch.arange(na, device=dev), torch.arange(nb, device=dev)])
    a_l = K.searchsorted_plain(a_keys, rows, side="left").to(torch.int64)
    a_r = K.searchsorted_plain(a_keys, rows, side="right").to(torch.int64)
    b_l = K.searchsorted_plain(b_keys, rows, side="left").to(torch.int64)
    b_r = K.searchsorted_plain(b_keys, rows, side="right").to(torch.int64)
    pos = idx + torch.where(own_a, b_l, a_r)

    def val_before(vals, n):  # value of row n-1, NEG for n == 0
        padded = torch.cat([
            torch.full((1,), VERSION_NEG, dtype=torch.int32, device=dev), vals
        ])
        return padded[n]

    def gc(v):
        return torch.where(v < floor, torch.full_like(v, VERSION_NEG), v)

    at = gc(torch.maximum(val_before(a_val, a_r), val_before(b_val, b_r)))
    before = gc(torch.maximum(val_before(a_val, a_l), val_before(b_val, b_l)))
    real = rows[:, -1] != K.SENTINEL_WORD
    first = torch.where(own_a, idx == a_l, (idx == b_l) & (a_l == a_r))
    keep = real & first & (at != before)
    keep_at = torch.zeros((na + nb,), dtype=torch.int32, device=dev)
    keep_at[pos] = keep.to(torch.int32)

    dest = torch.cumsum(keep_at, 0, dtype=torch.int32) - keep_at
    d = dest[pos].to(torch.int64)
    take = keep & (d < capacity)
    out_keys = K.sentinel_like(capacity, a_keys.shape[1], dev)
    out_val = torch.full((capacity,), VERSION_NEG, dtype=torch.int32,
                         device=dev)
    out_keys[d[take]] = rows[take]
    out_val[d[take]] = at[take]
    return out_keys, out_val, keep_at.sum()


def merge_maps(a_keys: torch.Tensor, a_val: torch.Tensor,
               b_keys: torch.Tensor, b_val: torch.Tensor, *, floor: int,
               capacity: int):
    """The pointwise max of two sorted piecewise-constant maps.

    a/b keys: [Na, W] / [Nb, W] sorted (duplicate keys allowed: the last
    row of a key is in force; sentinel tail), values [Na] / [Nb] int32.
    Values under `floor` become NEG; the result keeps only the first row
    of each key whose value differs from the previous key's value, in
    key order, compacted into [capacity] rows (sentinel/NEG tail).

    Returns (keys [capacity, W], ver [capacity], count [] int) where
    count is the number of rows the canonical map needs: count >
    capacity means rows were dropped and the caller must latch overflow.
    CUDA tensors take one launch of kernel D (`mm_merge`), which writes
    all three outputs; nothing else runs on the card.
    """
    w = a_keys.shape[1]
    if b_keys.shape[1] != w or a_val.shape[0] != a_keys.shape[0] \
            or b_val.shape[0] != b_keys.shape[0]:
        raise ValueError("merge_maps: mismatched shapes")
    if a_keys.device.type == "cpu":
        return merge_maps_plain(a_keys, a_val, b_keys, b_val, floor=floor,
                                capacity=capacity)
    kernels.check_cuda("merge_maps", a_keys, a_val, b_keys, b_val)
    kernels.check_words("merge_maps", w)
    dev = a_keys.device
    _no_capture("merge_maps")
    na, nb = a_keys.shape[0], b_keys.shape[0]
    out_keys = torch.empty((capacity, w), dtype=torch.int32, device=dev)
    out_val = torch.empty((capacity,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    scratch, epoch = _merge_scratch(
        dev, kernels.size("mm_scratch_words", na, nb))
    kernels.launch("mm_merge", "merge_maps", a_keys, a_val, na, b_keys, b_val,
                   nb, w, floor, capacity, out_keys, out_val, count, scratch,
                   epoch)
    return out_keys, out_val, count


def _no_capture(name: str) -> None:
    if torch.cuda.is_current_stream_capturing():
        # a graph would replay the epoch it was captured with, and take the
        # status words of its last replay for this one's
        raise RuntimeError(f"{name}: kernel D takes its scratch's epoch "
                           "from the host and cannot be captured in a "
                           "CUDA graph")


#: the largest epoch kernel D takes (a C int); past it the scratch is
#: zeroed and the epochs start again at 1
_EPOCH_MAX = 2**31 - 1
#: kernel D's scratch per (CUDA device, stream): [int64 words, the last
#: epoch]. Its status words count only in their own call's epoch, so one
#: zeroed array serves every call on its stream without a clear between
#: them; calls on two streams at once would share the ticket and the
#: status words, so each stream has its own
_MERGE_SCRATCH: dict = {}


def _scratch_key(dev: torch.device) -> tuple:
    """The key of the scratch a call on `dev`'s current stream uses."""
    return dev, torch.cuda.current_stream(dev).cuda_stream


def _merge_scratch(dev: torch.device, words: int):
    """(kernel D's scratch of at least `words` int64 words, the epoch of
    this call) for `dev`'s current stream."""
    key = _scratch_key(dev)
    held = _MERGE_SCRATCH.get(key)
    if held is None or held[0].shape[0] < words:
        held = _MERGE_SCRATCH[key] = [
            torch.zeros((words,), dtype=torch.int64, device=dev), 0]
    held[1] += 1
    if held[1] > _EPOCH_MAX:
        held[0].zero_()
        held[1] = 1
    return held[0], held[1]


# ---------------------------------------------------------------------------
# K16: the run-interval merge

def merge_writes_plain(state: VersionHistory, run_bounds: torch.Tensor,
                       version: int, new_oldest: int) -> VersionHistory:
    """Plain version of merge_writes, written as the JAX program: one
    stable sort of the tier's rows and the run bounds (tier rows first at
    equal keys), the tier value carried to every row, raised to the
    version inside a run (the parity of the bounds so far), GC at the
    floor, and a row kept where its value differs from the previous
    row's."""
    m, w = state.main_keys.shape
    mf = run_bounds.shape[0]
    dev = state.main_ver.device
    rows = torch.cat([state.main_keys, run_bounds])
    # stable: tier rows before bounds
    perm, skeys = K.lex_sort_perm_plain(rows)
    is_main = perm < m
    s_val = torch.cat([state.main_ver, torch.full(
        (mf,), VERSION_NEG, dtype=torch.int32, device=dev)])[perm]
    iota = torch.arange(m + mf, device=dev)
    last = torch.cummax(torch.where(is_main, iota, -1), 0).values
    carry = torch.where(last >= 0, s_val[last.clamp(min=0)], VERSION_NEG)
    run_ord = torch.cumsum((~is_main).to(torch.int32), 0)  # 1-based at runs
    delta = torch.where(~is_main, 1 - 2 * ((run_ord - 1) & 1), 0)
    covered = torch.cumsum(delta, 0) > 0
    new_val = torch.where(covered, torch.clamp(carry, min=version), carry)
    new_val = torch.where(new_val < new_oldest, VERSION_NEG,
                          new_val).to(torch.int32)
    prev = torch.cat([torch.full((1,), VERSION_NEG, dtype=torch.int32,
                                 device=dev), new_val[:-1]])
    keep = (skeys[:, -1] != K.SENTINEL_WORD) & (new_val != prev)
    pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    count = keep.sum()
    take = keep & (pos < m)
    out_keys = K.sentinel_like(m, w, dev)
    out_val = torch.full((m,), VERSION_NEG, dtype=torch.int32, device=dev)
    out_keys[pos[take]] = skeys[take]
    out_val[pos[take]] = new_val[take]
    return VersionHistory(main_keys=out_keys, main_ver=out_val,
                          oldest=max(state.oldest, int(new_oldest)),
                          overflow=state.overflow | (count > m))


def merge_writes(state: VersionHistory, run_bounds: torch.Tensor,
                 version: int, new_oldest: int) -> VersionHistory:
    """Overwrite the union of run intervals with `version`, raise the GC
    floor, and compact (K16, foundationdb_tpu/ops/history.py:114).

    run_bounds: [Mf, W] sorted disjoint interval bounds b0, e0, b1, e1,
    ... with a sentinel tail; version, new_oldest: host ints. The new
    value at k is max(old(k), version) inside a run and old(k) outside,
    NEG under the floor; the rows kept are the JAX program's, row for
    row (a run begin equal to a tier key keeps both rows, the later one
    in force). Rows past the tier's capacity latch `overflow`. CUDA
    tensors run kernel D's `mm_merge_writes`: one launch, which also
    writes the new overflow flag on the card.
    """
    m, w = state.main_keys.shape
    if run_bounds.ndim != 2 or run_bounds.shape[1] != w:
        raise ValueError("merge_writes: run_bounds must be [Mf, W]")
    if state.main_keys.device.type == "cpu":
        return merge_writes_plain(state, run_bounds, version, new_oldest)
    kernels.check_cuda("merge_writes", state.main_keys, state.main_ver,
                       run_bounds)
    kernels.check_words("merge_writes", w)
    if state.overflow.dtype != torch.bool or state.overflow.shape != ():
        raise ValueError("merge_writes: overflow must be a 0-d bool tensor")
    if state.overflow.device != state.main_keys.device:
        raise ValueError("merge_writes: overflow on another device")
    _no_capture("merge_writes")
    dev = state.main_keys.device
    nb = run_bounds.shape[0]
    out_keys = torch.empty((m, w), dtype=torch.int32, device=dev)
    out_val = torch.empty((m,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    scratch, epoch = _merge_scratch(
        dev, kernels.size("mm_scratch_words", m, nb))
    kernels.launch("mm_merge_writes", "merge_writes", state.main_keys,
                   state.main_ver, m, run_bounds, nb, w, int(version),
                   int(new_oldest), m, out_keys, out_val, count,
                   state.overflow, overflow, scratch, epoch)
    return VersionHistory(main_keys=out_keys, main_ver=out_val,
                          oldest=max(state.oldest, int(new_oldest)),
                          overflow=overflow)
