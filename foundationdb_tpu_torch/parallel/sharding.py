"""Multi-resolver sharding on one card: the resolver axis as the leading
axis of the card's own tensors.

Port of foundationdb_tpu/parallel/sharding.py (K18). The reference
scales conflict detection by partitioning the keyspace across resolver
processes: a commit proxy clips each transaction's conflict ranges to
every resolver's key range (ResolutionRequestBuilder, fdbserver/
CommitProxyServer.actor.cpp:105-261), each resolver keeps its own
history, and the verdicts combine with min() (determineCommittedTransactions,
:1551-1567). Each resolver is independent: a transaction that passes
on one shard has its writes merged there even if another shard aborts
it (a phantom commit), so the combine comes after every shard's merge.

The JAX package made the shards a device-mesh axis. On one H100 there
is no mesh: S shards are S tiered (or classic) states on the card, and
a group runs

* kernel I (`clip_batch`, kernels/csrc/shard_clip.cu): one launch clips
  every batch of the group to all S partitions, [S, G, ...] leaves;
* each shard's existing kernels on its clipped copy (ops/delta.
  resolve_group_tiered with the trip left to the caller, or the classic
  ops/group.resolve_group);
* kernel J (`combine`, kernels/csrc/shard_combine.cu): one launch
  combines the S results as the JAX pmin / psum / pmax round does, and
  counts the decisions from the combined verdict.

A latch trip on any shard refuses the group on every shard:
`resolve_group_sharded` reads kernel J's trip-any once per group and
keeps all S input states or none. CPU tensors take the plain versions
(`clip_batch_plain`, `combine_plain`). Decisions are bit-identical to
the JAX sharded kernels and to testing/oracle.MultiResolverOracle.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from foundationdb_tpu_torch import interop, kernels
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.device import resolve_device
from foundationdb_tpu_torch.ops import delta as D
from foundationdb_tpu_torch.ops import group as G
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.ops import keys as K
from foundationdb_tpu_torch.ops.conflict import COMMITTED, CONFLICT, TOO_OLD
from foundationdb_tpu_torch.ops.rangemax import INT32_POS
from foundationdb_tpu_torch.utils import packing

#: the argument leaves clip_batch rewrites, each given a leading [S] axis
CLIPPED = ("read_begin", "read_end", "read_valid", "write_begin",
           "write_end", "write_valid", "has_reads")


class ShardedVerdict(NamedTuple):
    verdict: torch.Tensor             # [B] int32, min-combined
    hist_conflict_read: torch.Tensor  # [NR] bool, OR across shards
    intra_first_range: torch.Tensor   # [B] int32, min non-negative, else -1
    overflow: torch.Tensor            # [] bool, any shard overflowed


class GroupShardedVerdict(NamedTuple):
    verdict: torch.Tensor             # [G, B]
    hist_conflict_read: torch.Tensor  # [G, NR]
    intra_first_range: torch.Tensor   # [G, B]
    overflow: torch.Tensor            # [G] bool


class Combined(NamedTuple):
    """Kernel J's outputs: the group's combined results."""

    verdict: torch.Tensor             # [G, B] int32
    hist_conflict_read: torch.Tensor  # [G, NR] bool
    intra_first_range: torch.Tensor   # [G, B] int32
    committed_count: torch.Tensor     # [G] int32, from the combined verdict
    conflict_count: torch.Tensor      # [G] int32
    too_old_count: torch.Tensor       # [G] int32
    overflow: torch.Tensor            # [G] bool, any shard
    trip: torch.Tensor                # [] bool, any shard's latch


def lex_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rowwise max of packed keys ([..., W] int32 words, broadcast)."""
    return torch.where(K.lex_less(a, b)[..., None], b, a)


def lex_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(K.lex_less(a, b)[..., None], a, b)


# ---------------------------------------------------------------------------
# kernel I: the clip

def clip_batch_plain(g: dict, part_lo: torch.Tensor,
                     part_hi: torch.Tensor) -> dict:
    """Plain version of kernel I: {name: [S, G, ...]} for CLIPPED."""
    lo = part_lo[:, None, None, :]
    hi = part_hi[:, None, None, :]
    rb = lex_max(g["read_begin"][None], lo)
    re = lex_min(g["read_end"][None], hi)
    rv = g["read_valid"][None] & K.lex_less(rb, re)
    wb = lex_max(g["write_begin"][None], lo)
    we = lex_min(g["write_end"][None], hi)
    wv = g["write_valid"][None] & K.lex_less(wb, we)
    s = part_lo.shape[0]
    gn, b = g["txn_valid"].shape
    txn = g["read_txn"].to(torch.int64)[None].expand(s, -1, -1)
    # dead reads (and any txn id out of range) go to the trash slot b
    take = rv & (txn >= 0) & (txn < b)
    hits = torch.zeros((s, gn, b + 1), dtype=torch.int32, device=rb.device)
    hits.scatter_reduce_(2, torch.where(take, txn, b), take.to(torch.int32),
                         reduce="amax")
    return dict(read_begin=rb, read_end=re, read_valid=rv, write_begin=wb,
                write_end=we, write_valid=wv, has_reads=hits[..., :b] > 0)


def clip_batch(g: dict, part_lo: torch.Tensor,
               part_hi: torch.Tensor) -> dict:
    """Every read and write range of a stacked group clipped to each
    shard's partition [lo, hi): {name: [S, G, ...]} for CLIPPED.

    `g` holds the group's torch leaves ([G, ...], interop.
    device_args_to_torch); part_lo / part_hi are [S, W] packed keys
    (make_partition). A range becomes [max(b, lo), min(e, hi)) in key
    order and stays valid only if it was and is non-empty; rows keep
    their index; has_reads is recomputed from the surviving reads, so a
    txn whose reads all lie on other shards is a blind write on this
    one. CUDA tensors run kernel I (one launch for all S shards).
    """
    rb = g["read_begin"]
    if rb.device.type == "cpu":
        return clip_batch_plain(g, part_lo, part_hi)
    keys = ("read_begin", "read_end", "write_begin", "write_end")
    dev = kernels.check_cuda("clip_batch", part_lo, part_hi,
                             *(g[k] for k in keys), g["read_txn"])
    kernels.check_cuda("clip_batch", g["read_valid"], g["write_valid"],
                       dtype=torch.bool)
    s, w = part_lo.shape
    gn, nr, rw = rb.shape
    nw = g["write_begin"].shape[1]
    b = g["txn_valid"].shape[1]
    if rw != w or part_hi.shape != part_lo.shape:
        raise ValueError("clip_batch: keys and partition of other widths")
    kernels.check_words("clip_batch", w)
    out = {k: torch.empty((s, *g[k].shape), dtype=g[k].dtype, device=dev)
           for k in CLIPPED[:-1]}
    out["has_reads"] = torch.empty((s, gn, b), dtype=torch.bool, device=dev)
    kernels.launch("sc_clip", "shard_clip", part_lo, part_hi, s, w,
                   rb, g["read_end"], g["read_valid"], g["read_txn"], gn, nr,
                   g["write_begin"], g["write_end"], g["write_valid"], nw, b,
                   *(out[k] for k in CLIPPED))
    return out


def shard_args(g: dict, clipped: dict, s: int) -> dict:
    """Shard s's group: `g` with its clipped leaves (contiguous views)."""
    return {**g, **{k: v[s] for k, v in clipped.items()}}


# ---------------------------------------------------------------------------
# kernel J: the combine

def combine_plain(verdict, first, hist, overflow, trip,
                  txn_valid) -> Combined:
    """Plain version of kernel J (the JAX pmin / psum / pmax round)."""
    v = verdict.amin(dim=0)
    f = torch.where(first < 0, INT32_POS, first).amin(dim=0)
    f = torch.where(f == INT32_POS, -1, f)

    def count(code):
        return ((v == code) & txn_valid).sum(dim=1, dtype=torch.int32)

    return Combined(verdict=v, hist_conflict_read=hist.any(dim=0),
                    intra_first_range=f, committed_count=count(COMMITTED),
                    conflict_count=count(CONFLICT),
                    too_old_count=count(TOO_OLD),
                    overflow=overflow.any(dim=0), trip=trip.any())


def combine(verdict, first, hist, overflow, trip, txn_valid) -> Combined:
    """The S shards' results of a group, combined.

    verdict, first: [S, G, B] int32 (intra_first_range); hist: [S, G, NR]
    bool; overflow: [S, G] bool; trip: [S] bool; txn_valid: [G, B] bool.
    The verdict is the min over shards, hits the OR, the first index the
    min over the non-negative values (else -1), overflow and trip any
    shard's, and the three counts come from the combined verdict and
    txn_valid. CUDA tensors run kernel J (one launch)."""
    if verdict.device.type == "cpu":
        return combine_plain(verdict, first, hist, overflow, trip, txn_valid)
    dev = kernels.check_cuda("combine", verdict, first)
    kernels.check_cuda("combine", hist, overflow, trip, txn_valid,
                       dtype=torch.bool)
    s, gn, b = verdict.shape
    nr = hist.shape[2]
    if (first.shape != verdict.shape or hist.shape[:2] != (s, gn)
            or overflow.shape != (s, gn) or trip.shape != (s,)
            or txn_valid.shape != (gn, b)):
        raise ValueError("combine: shapes disagree")
    out_v = torch.empty((gn, b), dtype=torch.int32, device=dev)
    out_f = torch.empty((gn, b), dtype=torch.int32, device=dev)
    out_h = torch.empty((gn, nr), dtype=torch.bool, device=dev)
    out_o = torch.empty((gn,), dtype=torch.bool, device=dev)
    trip_any = torch.empty((), dtype=torch.bool, device=dev)
    counts = torch.empty((3, gn), dtype=torch.int32, device=dev)
    kernels.launch("sc_combine", "shard_combine", verdict, first, hist,
                   overflow, trip, txn_valid, s, gn, b, nr, out_v, out_f,
                   out_h, out_o, trip_any, counts)
    return Combined(verdict=out_v, hist_conflict_read=out_h,
                    intra_first_range=out_f, committed_count=counts[0],
                    conflict_count=counts[1], too_old_count=counts[2],
                    overflow=out_o, trip=trip_any)


def combine_outs(outs, trip, txn_valid) -> Combined:
    """Kernel J over S per-shard GroupVerdicts (stacked on the shard
    axis first) and their [S] trip flags."""
    def stack(f):
        return torch.stack([getattr(o, f) for o in outs])

    return combine(stack("verdict"), stack("intra_first_range"),
                   stack("hist_conflict_read"), stack("overflow"), trip,
                   txn_valid)


def combine_probe(n_shards: int, b: int, nr: int, device):
    """The combine alone (the port of collective_probe_jit): a callable
    that runs kernel J once on verdict-shaped zeros of one batch, made
    once. The conflict set times a call, fenced, on the overflow-check
    sync: the per-group cost of the cross-shard round."""
    def z(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    args = (z(n_shards, 1, b, dtype=torch.int32),
            z(n_shards, 1, b, dtype=torch.int32),
            z(n_shards, 1, nr, dtype=torch.bool),
            z(n_shards, 1, dtype=torch.bool), z(n_shards, dtype=torch.bool),
            z(1, b, dtype=torch.bool))
    return lambda: combine(*args)


# ---------------------------------------------------------------------------
# partitions and state

def make_partition(boundaries: Sequence[bytes], config: KernelConfig
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Interior split keys -> per-shard (lo, hi) packed keys, [S, W]
    uint32 each: shard 0 starts at b"", the last ends at the +inf
    sentinel, so the shards tile the keyspace (the keyResolvers map's
    contract)."""
    n_shards = len(boundaries) + 1
    w = config.key_words
    lo = np.zeros((n_shards, w), np.uint32)
    hi = np.zeros((n_shards, w), np.uint32)
    packed = [packing.pack_key(b, config.max_key_bytes) for b in boundaries]
    sentinel = np.full((w,), 0xFFFFFFFF, np.uint32)
    for s in range(n_shards):
        lo[s] = (packed[s - 1] if s > 0
                 else packing.pack_key(b"", config.max_key_bytes))
        hi[s] = packed[s] if s < n_shards - 1 else sentinel
    return lo, hi


def default_boundaries(n_shards: int) -> list[bytes]:
    """Even first-byte partition: the n_shards - 1 interior split keys.
    Balance depends on the workload (callers with a key sample pass
    their own); correctness never does."""
    if not 1 <= n_shards <= 256:
        raise ValueError(f"n_shards must be in [1, 256], got {n_shards}")
    return [bytes([(256 * (i + 1)) // n_shards]) for i in range(n_shards - 1)]


def check_boundaries(boundaries: Sequence[bytes], n_shards: int) -> None:
    if len(boundaries) != n_shards - 1:
        raise ValueError(
            f"{n_shards} shards need {n_shards - 1} interior boundaries, "
            f"got {len(boundaries)}")
    if list(boundaries) != sorted(set(boundaries)):
        raise ValueError("shard boundaries must be strictly ascending")


def partition_tensors(boundaries: Sequence[bytes], config: KernelConfig,
                      device) -> tuple[torch.Tensor, torch.Tensor]:
    """make_partition's (lo, hi) as [S, W] int32 tensors on `device`."""
    lo, hi = make_partition(boundaries, config)
    return interop.to_torch(lo, device), interop.to_torch(hi, device)


def init_sharded_tiered(config: KernelConfig, boundaries: Sequence[bytes],
                        device):
    """(S empty tiered states, part_lo, part_hi) for S = config.n_shards
    shards over `boundaries` on `device`."""
    check_boundaries(boundaries, config.n_shards)
    lo, hi = partition_tensors(boundaries, config, device)
    states = tuple(D.init(config, device) for _ in range(config.n_shards))
    return states, lo, hi


# ---------------------------------------------------------------------------
# resolving a group on every shard

def resolve_group_sharded(states, g: dict, part_lo, part_hi, *,
                          short_span_limit: int = 0,
                          fixpoint_unroll: int = 3,
                          fixpoint_latch: bool = False,
                          dedup_reads: int = 0, range_sweep: bool = False,
                          stats: G.FixpointStats = None):
    """One stacked group through S tiered shards: (states', GroupVerdict).

    Kernel I clips the group once for every shard; each shard runs the
    tiered group loop on its copy against its own tiers (one main-tier
    table, its own sweep ranks and dedup latch, its own span latch under
    `short_span_limit`); kernel J combines. With
    the fixpoint latch or dedup armed, a trip on any shard is read once
    (one sync) and every shard keeps its input state; `unconverged` is
    that trip, broadcast over G, and the caller re-runs the group
    exactly."""
    gn = g["txn_valid"].shape[0]
    clipped = clip_batch(g, part_lo, part_hi)
    news, outs, trips = [], [], []
    for s, state in enumerate(states):
        new, out, trip = D.resolve_group_tiered(
            state, shard_args(g, clipped, s),
            short_span_limit=short_span_limit,
            fixpoint_unroll=fixpoint_unroll, fixpoint_latch=fixpoint_latch,
            dedup_reads=dedup_reads, range_sweep=range_sweep, stats=stats,
            defer_trip=True)
        news.append(new)
        outs.append(out)
        trips.append(trip)
    comb = combine_outs(outs, torch.stack(trips), g["txn_valid"])
    if (fixpoint_latch or dedup_reads) and bool(comb.trip):
        news = states
    return tuple(news), G.GroupVerdict(
        verdict=comb.verdict, hist_conflict_read=comb.hist_conflict_read,
        intra_first_range=comb.intra_first_range,
        committed_count=comb.committed_count,
        conflict_count=comb.conflict_count,
        too_old_count=comb.too_old_count, overflow=comb.overflow,
        unconverged=comb.trip.repeat(gn))


def compact_sharded(states) -> tuple:
    """Every shard's delta folded into its main (ops/delta.compact, kernel
    D per shard; no cross-shard dependency)."""
    return tuple(D.compact(s) for s in states)


# ---------------------------------------------------------------------------
# the classic sharded conflict set

class ShardedConflictSet:
    """S classic (single-tier) resolvers over a keyspace partition.

    The JAX package's ShardedConflictSet, one mesh device per shard; here
    S VersionHistory tiers on one device. `resolve` runs a batch through
    every shard (kernel I, the G = 1 classic kernel per shard, kernel
    J); `resolve_group_args` a stacked group through the classic group
    kernel per shard (the cross-batch phase at G > 1). Same per-shard
    history semantics and min() combine as S reference resolvers."""

    def __init__(self, config: KernelConfig, boundaries: Sequence[bytes],
                 base_version: int = 0, *, device=None):
        n_shards = len(boundaries) + 1
        check_boundaries(boundaries, n_shards)
        self.config = config
        self.n_shards = n_shards
        self.base_version = base_version
        self.device = resolve_device(device)
        self.part_lo, self.part_hi = partition_tensors(boundaries, config,
                                                       self.device)
        self.state = tuple(H.init(config, self.device)
                           for _ in range(n_shards))

    def _run(self, g: dict):
        clipped = clip_batch(g, self.part_lo, self.part_hi)
        news, outs = [], []
        for s, state in enumerate(self.state):
            new, out = G.resolve_group(
                state, shard_args(g, clipped, s),
                fixpoint_unroll=self.config.fixpoint_unroll)
            news.append(new)
            outs.append(out)
        no_trip = torch.zeros((self.n_shards,), dtype=torch.bool,
                              device=self.device)
        comb = combine_outs(outs, no_trip, g["txn_valid"])
        self.state = tuple(news)
        return comb

    def resolve(self, transactions, version: int) -> ShardedVerdict:
        """One batch across all shards: the combined verdicts. Refuses
        (HistoryOverflowError) to hand out verdicts computed against a
        truncated shard history."""
        batch = packing.pack_batch(transactions, version, self.base_version,
                                   self.config)
        stacked = {k: np.asarray(v)[None]
                   for k, v in batch.device_args().items()}
        comb = self._run(interop.device_args_to_torch(stacked, self.device))
        out = ShardedVerdict(comb.verdict[0], comb.hist_conflict_read[0],
                             comb.intra_first_range[0], comb.overflow[0])
        if bool(out.overflow):
            self._raise_overflow()
        return out

    def resolve_group_args(self, stacked_args: dict) -> GroupShardedVerdict:
        """A G-batch stacked device_args tree across all shards (versions
        strictly ascending: the sequencer contract of the group kernel)."""
        g = interop.device_args_to_torch(stacked_args, self.device)
        versions = np.asarray(g["version"]).astype(np.int64).reshape(-1)
        if np.any(np.diff(versions) <= 0):
            raise ValueError("group versions must ascend strictly, got "
                             f"{versions.tolist()}")
        comb = self._run(g)
        return GroupShardedVerdict(comb.verdict, comb.hist_conflict_read,
                                   comb.intra_first_range, comb.overflow)

    def resolve_group(self, batches, versions) -> GroupShardedVerdict:
        """Pack and resolve a list of transaction batches as one group."""
        packed = [packing.pack_batch(txns, v, self.base_version, self.config)
                  for txns, v in zip(batches, versions)]
        out = self.resolve_group_args(packing.stack_device_args(packed))
        if bool(out.overflow.any()):
            self._raise_overflow()
        return out

    def _raise_overflow(self) -> None:
        from foundationdb_tpu_torch.models.conflict_set import (
            HistoryOverflowError,
        )

        raise HistoryOverflowError(
            f"a shard's history_capacity={self.config.history_capacity} "
            "overflowed; increase it (or lower the MVCC window / write rate)")

    def check_overflow(self) -> None:
        """Device sync: raise if any shard's history merge overflowed."""
        if bool(torch.stack([s.overflow for s in self.state]).any()):
            self._raise_overflow()
