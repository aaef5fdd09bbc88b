"""Static kernel configuration (the port's own copy of foundationdb_tpu.config).

Every capacity the conflict kernel works with is fixed per instance; the
host packer pads variable-size batches up to these caps. Mirrors the role
the reference's knobs play for the resolver
(fdbclient/ServerKnobs.cpp:36-44 — MVCC window knobs). The field set and
the validation are identical to the JAX package's KernelConfig, so one
set of arguments configures both, and the port serves every knob: the
classic single-tier path (delta_capacity 0, the default), the tiered
path with the latch, dedup, sweep and spill knobs, the sharded path
(n_shards > 1) and the short-span ops (short_span_limit > 0).
"""

from __future__ import annotations

import dataclasses
import math


def _ceil_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Compile-time shapes for the conflict-resolution kernel.

    Attributes:
      max_key_bytes: maximum conflict-range key length the packed
        representation can hold exactly. Keys are encoded as big-endian
        uint32 words plus a final length word, which preserves FDB's key
        ordering contract exactly (byte-lexicographic, shorter-before-longer
        — fdbserver/SkipList.cpp:123-139).
      max_txns: txn capacity per batch (B).
      max_reads: total read-conflict-range capacity per batch (flattened).
      max_writes: total write-conflict-range capacity per batch (flattened).
      history_capacity: boundary capacity of the "main" version map. Must
        hold the live MVCC window's write boundaries (~2*max_writes per
        batch x window/version-step batches); overflow raises, never
        silently drops.
      window_versions: MVCC window: newOldestVersion = version - window
        (reference: MAX_WRITE_TRANSACTION_LIFE_VERSIONS = 5e6,
        fdbclient/ServerKnobs.cpp:43, used at fdbserver/Resolver.actor.cpp:331).
    """

    max_key_bytes: int = 24
    max_txns: int = 1024
    max_reads: int = 4096
    max_writes: int = 4096
    history_capacity: int = 1 << 15
    window_versions: int = 5_000_000
    #: 0 = the general range structures. A positive S runs the group
    #: kernel's range ops as direct S-wide reads and writes (kernel K),
    #: exact under a loud latch: a live range spanning more than S tier
    #: segments, ranks or blocks sets overflow (ops/group.resolve_group).
    short_span_limit: int = 0
    #: Fixpoint applications run before the port's host loop starts
    #: checking convergence (ops/group.resolve_group). Exactness never
    #: depends on it: deeper conflict chains continue in the loop.
    fixpoint_unroll: int = 3
    #: The fixpoint without its residual loop: exactly fixpoint_unroll
    #: applications, a batch that has not converged by then trips the
    #: unconverged latch (state unchanged) and the conflict set re-runs
    #: the group on the exact configuration.
    fixpoint_latch: bool = False
    #: > 0 selects the delta-tiered history (ops/delta.py): each batch's
    #: writes land in a delta tier of this boundary capacity, queried
    #: beside the main tier and folded into it by compaction. Must hold
    #: the boundaries written between compactions (<= 2 * max_writes per
    #: batch, window-trimmed); overflow raises, never truncates. 0 selects
    #: the classic single-tier kernel (ops/conflict.resolve_batch, and
    #: the group kernel at G > 1).
    delta_capacity: int = 0
    #: > 0: only this many distinct (begin, end) read ranges per batch
    #: probe the main tier (the hot-key profile); a batch with more trips
    #: the unconverged latch and the group re-runs exactly.
    dedup_reads: int = 0
    #: The endpoint sweep probe of the main tier: every read of a group
    #: gets its main ranks in one launch, then one table query per read
    #: (the range-scan profile). Not a latch source.
    range_sweep: bool = False
    #: Compact before a dispatch whose worst-case boundary count could
    #: overflow the delta tier, instead of raising.
    delta_spill: bool = False
    #: Host folds delta into main after at least this many batches have
    #: resolved since the last compaction (a group of G counts G). 0 =
    #: only explicit compaction.
    compact_interval: int = 8
    #: > 1 selects the sharded kernel: history partitioned by key range
    #: over n_shards resolvers (the JAX package's mesh axis; in the port
    #: the leading axis of one card's tensors, parallel/sharding.py).
    n_shards: int = 0
    #: Mesh axis name of the JAX sharded kernel (kept for the same config).
    shard_axis: str = "resolver"

    def __post_init__(self):
        if self.max_key_bytes % 4 != 0:
            raise ValueError("max_key_bytes must be a multiple of 4")
        # history_capacity may be any size (nothing in the kernel needs it
        # to be a power of two); the batch caps must be pow2 for the rank
        # space / cover structures.
        for name in ("max_txns", "max_reads", "max_writes"):
            v = getattr(self, name)
            if v & (v - 1):
                raise ValueError(f"{name} must be a power of two, got {v}")
        if self.dedup_reads > self.max_reads:
            raise ValueError("dedup_reads cannot exceed max_reads")
        if self.dedup_reads and not self.delta_capacity:
            raise ValueError("dedup_reads requires the tiered path "
                             "(delta_capacity > 0)")
        if self.range_sweep and not self.delta_capacity:
            raise ValueError("range_sweep requires the tiered path "
                             "(delta_capacity > 0)")
        if self.range_sweep and self.dedup_reads:
            raise ValueError(
                "range_sweep and dedup_reads compile the same main-tier "
                "probe differently (sweep ranks vs dedup'd binary "
                "searches) — configure one per contention profile"
            )
        if self.delta_spill and not self.delta_capacity:
            raise ValueError("delta_spill requires the tiered path "
                             "(delta_capacity > 0)")
        if self.n_shards < 0:
            raise ValueError("n_shards must be >= 0")
        if self.n_shards > 1 and not self.delta_capacity:
            raise ValueError("the mesh-sharded kernel is tiered-only: "
                             "n_shards > 1 requires delta_capacity > 0 "
                             "(the classic sharded path is "
                             "parallel.sharding.ShardedConflictSet)")

    # ---- derived shapes -------------------------------------------------

    @property
    def key_words(self) -> int:
        """uint32 words per packed key: byte words + 1 length word."""
        return self.max_key_bytes // 4 + 1

    @property
    def num_points(self) -> int:
        """Rank-space capacity: every read/write range contributes 2 points."""
        return 2 * (self.max_reads + self.max_writes)

    @property
    def segtree_size(self) -> int:
        """Leaf count of the intra-batch segment tree (pow2 >= num_points)."""
        return _ceil_pow2(self.num_points)

    @property
    def segtree_levels(self) -> int:
        return int(math.log2(self.segtree_size))

    @property
    def history_log(self) -> int:
        return int(math.log2(self.history_capacity)) + 1

    def scaled(self, **overrides) -> "KernelConfig":
        return dataclasses.replace(self, **overrides)


#: A deliberately tiny config for CPU-hosted unit tests.
TEST_CONFIG = KernelConfig(
    max_key_bytes=8,
    max_txns=64,
    max_reads=256,
    max_writes=256,
    history_capacity=1 << 10,
    window_versions=1000,
)
