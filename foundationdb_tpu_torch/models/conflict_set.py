"""TorchConflictSet: the host-facing conflict-detection object of the port.

Port of foundationdb_tpu.models.conflict_set.TpuConflictSet on one
device: persistent MVCC write history on a device plus a
batch-at-a-time detect API (the reference's ConflictSet +
ConflictBatch, fdbserver/include/fdbserver/ConflictSet.h:30-75).

* With `delta_capacity > 0` (tiered) the state is an ops.delta.
  TieredState on `device` (the card unless the caller asks for the
  CPU); every batch runs the tiered kernel (ops/delta.py) and the host
  folds delta into main every `config.compact_interval` batches.
* With `delta_capacity == 0` (classic, the config's default) the state
  is one ops.history.VersionHistory tier: a batch runs
  ops/conflict.resolve_batch (K15), a stacked group the group kernel at
  G > 1 with its cross-batch phase (ops/group.py, K14), and
  `resolve_args_scan` K batches in order.
* Versions are int32 offsets of `base_version`; `_maybe_rebase` shifts
  every stored offset (NEG stays NEG) when the chain drifts too far.
* Capacity overflow is latched on the device and surfaced in every
  verdict: `resolve()` refuses to externalize decisions computed
  against a truncated history, and the kernel-only paths check every
  OVERFLOW_CHECK_INTERVAL batches. Overflow raises, never truncates.
* The hot-key and range-scan profiles: `fixpoint_latch` and
  `dedup_reads` may refuse a group (`unconverged`, state unchanged);
  the dispatch then re-runs the same arguments on the exact
  configuration, so no latched verdict is ever handed out (on the
  classic path, `resolve_group_args` with the fixpoint latch).
  `range_sweep` swaps the main-tier probe for the endpoint sweep, and
  `delta_spill` compacts before a dispatch whose worst-case boundary
  count could overflow the delta tier.
* With `n_shards > 1` (tiered) the state is S shards' TieredStates over
  a keyspace partition (`shard_boundaries`, the n_shards - 1 interior
  split keys; default parallel.sharding.default_boundaries): every
  group is clipped to all shards by kernel I, each shard runs the
  tiered kernel on its copy, and kernel J combines the verdicts
  (parallel/sharding.py, K18). Compaction, rebase and the latch are
  per shard, all shards together; a trip on any shard refuses the
  group on all of them.
* On the card the constructor runs the rangemax self-check (K20) at
  history capacity before the first decision.

The profile router (`profile_batch`, `profile_transactions`,
`backend_for_profile`, `fallback_free`, `route_stream`) is the JAX
package's host-side classifier, copied: it answers "cuda" where the JAX
one answers "tpu".

The backend names, against the JAX package's `make_conflict_set`:

| JAX backend | port backend | builds |
|---|---|---|
| "tpu-force" | "cuda" (the port's default) | TorchConflictSet, never gated |
| "tpu" (and None, knob "tpu") | None, knob RESOLVER_BACKEND "cuda" | CpuConflictSet under SERVER_KNOBS.RESOLVER_CUDA_MIN_BATCH (the JAX RESOLVER_TPU_MIN_BATCH), else TorchConflictSet |
| "cpu" (and None, knob "cpu") | "cpu" (and None, knob "cpu") | CpuConflictSet |

Explicit "cuda" means the card whatever the batch size: gating it would
turn every caller that asks for the card at a small batch into an
oracle run. The Resolver role's routed construction (backend None with
the knob's "cuda") takes the gated path.

The staging pipeline (`resolve_stream_pipelined`, `resolve_group_stream`)
stacks and stages chunks on a thread of its own through
`interop.Stager` (pinned buffers, a copy stream, an event a chunk) while
the calling thread dispatches compute; `stage_ledger` fences each stage
to measure it.

The columnar path (`pack_columnar_batch`, `resolve_columnar_packed`,
`resolve_columnar`) takes a batch as the wire's flat columns
(utils/packing.ColumnarBatch) and dispatches it exactly as resolve()
does; only its pack and its report's begin keys differ. CpuConflictSet
has none of it, as in JAX: the wire ResolverRole tells a set that
dispatches kernels from the host oracle by that method.

`short_span_limit` S > 0 runs the group kernel's range ops as kernel K's
direct S-wide reads and writes (ops/group.py, K13) where the JAX
TpuConflictSet passes the knob: the tiered and sharded dispatch and
classic `resolve_group_args`; classic `resolve()` / `resolve_packed` go
through resolve_batch, which takes no span limit in either package. A
range wider than S trips the span latch, which is overflow: it raises
HistoryOverflowError at the same check as in JAX, never truncates and
never falls back to the general path.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from foundationdb_tpu_torch import interop, kernels
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.device import resolve_device
from foundationdb_tpu_torch.models.types import (
    CommitTransaction,
    TransactionResult,
)
from foundationdb_tpu_torch.ops import conflict as C
from foundationdb_tpu_torch.ops import delta as D
from foundationdb_tpu_torch.ops import group as G
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.ops import rangemax
from foundationdb_tpu_torch.parallel import sharding as SH
from foundationdb_tpu_torch.utils import packing
from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS
from foundationdb_tpu_torch.utils.metrics import CounterCollection, LatencySample
from foundationdb_tpu_torch.utils.probes import code_probe, declare
from foundationdb_tpu_torch.utils.trace import SEV_WARN, TraceEvent

# the soak's range_heavy spec expects both (testing/specs/range_heavy.toml)
declare("resolver.range_sweep", "resolver.delta_spill")

# Rebase when offsets pass 2**30 (the window is ~5e6; huge margin).
REBASE_THRESHOLD = 1 << 30

#: Overflow is checked host-side every this many batches on the
#: kernel-only paths (each check is a device sync).
OVERFLOW_CHECK_INTERVAL = 32


class KernelStageMetrics:
    """Per-stage telemetry of the resolve paths.

    pack / transfer / kernel / fence are host wall-clock seconds
    (`LatencySample`s, so quantiles): "kernel" covers the dispatch of
    the tiered or classic kernel (asynchronous on the card except the
    fixpoint loop's and the latch's syncs), "fence" the reply assembly
    that waits for the verdicts; the staging pipeline samples pack and
    transfer (the stacking and the enqueue of the pinned copy) on its
    staging thread. "compile" holds `prewarm_exact`'s seconds (building
    and loading the kernel libraries). Occupancy (the worst shard's,
    when sharded) and device memory are sampled on the overflow-check
    syncs, and so is `collective` on a sharded set: the fenced seconds
    of one cross-shard combine (kernel J alone). `fixpoint` counts the
    fixpoint's depth (the port's own entry of `as_dict`).
    """

    COUNTERS = ("resolveBatches", "groupDispatches",
                # batches packed from columnar wire frames
                # (pack_columnar_batch)
                "columnarBatches",
                # chunks the staging pipeline staged
                "stagedChunks",
                "compactions",
                # pressure-driven compactions (delta_spill), counted in
                # compactions too
                "spills",
                # overflow-check syncs where the live delta count
                # tightened the host-side spill bound
                "spillBoundAnchors",
                # groups dispatched through the endpoint sweep probe
                "sweepGroups",
                "latchTrips", "exactFallbacks", "rebases",
                "overflowRaised",
                # prewarm_exact calls that built and loaded the kernels
                "warmCompiles")

    def __init__(self):
        self.counters = CounterCollection("ResolverKernelMetrics",
                                          list(self.COUNTERS))
        self.compile = LatencySample("compileSeconds")
        self.pack = LatencySample("packSeconds")
        self.transfer = LatencySample("transferSeconds")
        self.kernel = LatencySample("kernelSeconds")
        self.fence = LatencySample("fenceSeconds")
        self.delta_occupancy = LatencySample("deltaLiveBoundaries")
        self.main_occupancy = LatencySample("mainLiveBoundaries")
        self.collective = LatencySample("collectiveSeconds")
        self.shard_count = 1
        self.fixpoint = G.FixpointStats()
        self.device_bytes_in_use = 0
        self.device_peak_bytes = 0

    def add(self, name: str, n: int = 1) -> None:
        self.counters.add(name, n)

    def sample_device_memory(self, device: torch.device) -> None:
        """Allocator gauges of the device holding the state (the CUDA
        caching allocator's counters; the CPU reports nothing)."""
        if device.type != "cuda":
            return
        stats = torch.cuda.memory_stats(device)
        self.device_bytes_in_use = stats.get("allocated_bytes.all.current", 0)
        self.device_peak_bytes = max(
            self.device_peak_bytes, stats.get("allocated_bytes.all.peak", 0)
        )

    def as_dict(self) -> dict:
        out: dict = self.counters.as_dict()
        for s in (self.compile, self.pack, self.transfer, self.kernel,
                  self.fence, self.delta_occupancy, self.main_occupancy,
                  self.collective):
            out[s.name] = s.as_dict()
        out["shardCount"] = self.shard_count
        out["fixpoint"] = dataclasses.asdict(self.fixpoint)
        out["deviceBytesInUse"] = self.device_bytes_in_use
        out["devicePeakBytes"] = self.device_peak_bytes
        return out

    def qos(self) -> dict:
        """The compressed view the Resolver's saturation() reads: per
        batch stage seconds, per-stage p99s, the kernel libraries' build
        cache (`kernels.build_stats()`, process-wide), device memory,
        tier fill and the fallback, spill and sweep counts; the keys of
        the JAX package's `KernelStageMetrics.qos()`."""
        batches = self.counters.get("resolveBatches")
        stage_total = (
            self.pack.total + self.transfer.total + self.kernel.total
            + self.fence.total
        )
        cc = kernels.build_stats()
        d_occ = self.delta_occupancy.max or 0.0
        m_occ = self.main_occupancy.max or 0.0
        return {
            "batches": batches,
            "kernel_seconds_per_batch": (
                stage_total / batches if batches else 0.0
            ),
            "kernel_p99_seconds": self.kernel.quantile(0.99),
            "stage_p99_seconds": {
                "pack": self.pack.quantile(0.99),
                "transfer": self.transfer.quantile(0.99),
                "kernel": self.kernel.quantile(0.99),
                "fence": self.fence.quantile(0.99),
            },
            "compile_seconds": self.compile.total,
            "compile_cache_hits": cc["cache_hits"],
            "compile_cache_misses": cc["cache_misses"],
            "last_compile_seconds": cc["last_compile_seconds"],
            "device_bytes_in_use": self.device_bytes_in_use,
            "device_peak_bytes": self.device_peak_bytes,
            "delta_occupancy": d_occ,
            "main_occupancy": m_occ,
            "compactions": self.counters.get("compactions"),
            "spills": self.counters.get("spills"),
            "sweep_groups": self.counters.get("sweepGroups"),
            "fallbacks": (
                self.counters.get("latchTrips")
                + self.counters.get("exactFallbacks")
            ),
            # a sharded set samples its worst shard's counts into the
            # occupancy samples above: one value, two names
            "shards": self.shard_count,
            "worst_shard_delta_occupancy": d_occ,
            "worst_shard_main_occupancy": m_occ,
            "collective_time_share": (
                min(
                    1.0,
                    (self.collective.total / self.collective.count)
                    / (stage_total / batches),
                )
                if self.collective.count and batches and stage_total
                else 0.0
            ),
        }


class HistoryOverflowError(RuntimeError):
    """A history tier exceeded its static capacity: a configuration
    error (capacity too small for write rate x window), never a silent
    wrong answer."""


@dataclasses.dataclass
class BatchResult:
    verdicts: list[TransactionResult]
    conflicting_key_ranges: dict[int, list[int]]


def _rebase(h: H.VersionHistory, delta: int) -> H.VersionHistory:
    """Shift a tier's version offsets down by delta; NEG stays NEG."""
    neg = H.VERSION_NEG
    v = h.main_ver
    shifted = torch.clamp(v.to(torch.int64) - delta, min=neg + 1)
    oldest = h.oldest if h.oldest == neg else max(h.oldest - delta, neg + 1)
    return h._replace(
        main_ver=torch.where(v == neg, v, shifted.to(torch.int32)),
        oldest=oldest,
    )


def _rebase_tiered(state: D.TieredState, delta: int) -> D.TieredState:
    return D.TieredState(main=_rebase(state.main, delta),
                         delta=_rebase(state.delta, delta))


class TorchConflictSet:
    """Batch MVCC conflict detection with device-resident history."""

    def __init__(self, config: KernelConfig, base_version: int = 0, *,
                 device=None, shard_boundaries=None):
        self.config = config
        self.base_version = base_version
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the card's table build and query held against numpy before
            # the first decision (the CPU lanes call it directly)
            rangemax.flat_gather_selftest(config.history_capacity,
                                          device=self.device)
        self.tiered = config.delta_capacity > 0
        # the config pins n_shards > 1 to the tiered path
        self.sharded = config.n_shards > 1
        self.metrics = KernelStageMetrics()
        if self.sharded:
            self.shard_boundaries = (
                list(shard_boundaries) if shard_boundaries is not None
                else SH.default_boundaries(config.n_shards))
            self.state, self.part_lo, self.part_hi = SH.init_sharded_tiered(
                config, self.shard_boundaries, self.device)
            self.metrics.shard_count = config.n_shards
            self._probe = None
        elif shard_boundaries is not None:
            raise ValueError("shard_boundaries needs config.n_shards > 1")
        else:
            self.state = (D.init(config, self.device) if self.tiered
                          else H.init(config, self.device))
        self._batches_since_check = 0
        self._batches_since_compact = 0
        #: conservative live-boundary bound of the delta tier since the
        #: last compaction (2 * max_writes per dispatched batch): the
        #: delta_spill pressure signal, host arithmetic only, so a spill
        #: decision never costs a device sync
        self._spill_bound_rows = 0
        #: the staging pipeline's pinned ring (interop.Stager), made at
        #: its first stream
        self._staging = None

    # -- state carried across from the JAX package ----------------------

    def load_state(self, state, base_version: int,
                   batches_since_compact: int = 0,
                   spill_bound_rows: int = 0) -> None:
        """Take over a JAX `TpuConflictSet`'s history (same config)
        mid-stream.

        `state` is, as numpy, the JAX state's leaves: a classic
        `VersionHistory`'s four (`[np.asarray(x) for x in jax_cs.state]`),
        or a tiered (main leaves, delta leaves) pair; sharded, the same
        pair with a leading [S] axis on every leaf (the JAX stacked
        sharded state). The counters are the JAX set's (`base_version`,
        `_batches_since_compact`, `_spill_bound_rows`), so versions
        rebase, the delta tier compacts and spills at the same points
        after the move."""
        if self.sharded:
            self.state = interop.sharded_tiered_state_from_numpy(
                *state, self.device)
        elif self.tiered:
            self.state = interop.tiered_state_from_numpy(*state, self.device)
        else:
            self.state = interop.history_from_numpy(*state, self.device)
        self.base_version = int(base_version)
        self._batches_since_compact = int(batches_since_compact)
        self._spill_bound_rows = int(spill_bound_rows)

    def store_state(self):
        """(state as numpy, base_version): the state in the leaf order
        load_state takes (and the JAX package's history leaves have)."""
        if self.sharded:
            state = interop.sharded_tiered_state_to_numpy(self.state)
        elif self.tiered:
            state = interop.tiered_state_to_numpy(self.state)
        else:
            state = interop.history_to_numpy(self.state)
        return state, self.base_version

    # -- ConflictBatch-equivalent API -----------------------------------

    def resolve(self, transactions: list[CommitTransaction],
                version: int) -> BatchResult:
        """Detect conflicts for one batch committing at `version`:
        per-txn verdicts and the conflicting-key-range report, with the
        committed writes merged into history at `version`."""
        self._maybe_rebase(version)
        t0 = time.perf_counter()
        batch = packing.pack_batch(
            transactions, version, self.base_version, self.config
        )
        self.metrics.pack.sample(time.perf_counter() - t0)
        return self._dispatch_and_assemble(
            batch,
            report=[t.report_conflicting_keys for t in transactions],
            begin_key_of_row=lambda r: transactions[
                int(batch.read_txn[r])
            ].read_conflict_ranges[int(batch.read_index[r])][0],
        )

    # -- the columnar path (the wire resolver's hop from frame to kernel) --

    def pack_columnar_batch(self, cols: packing.ColumnarBatch,
                            version: int) -> packing.PackedBatch:
        """Rebase, then scatter a columnar wire batch straight into the
        kernel's arrays (packing.pack_batch_columnar, byte-identical to
        pack_batch on the same transactions). Split from
        resolve_columnar so the wire ResolverRole can bracket exactly
        this stage with its ColumnarDecode mark."""
        self._maybe_rebase(version)
        t0 = time.perf_counter()
        batch = packing.pack_batch_columnar(
            cols, version, self.base_version, self.config
        )
        self.metrics.pack.sample(time.perf_counter() - t0)
        self.metrics.add("columnarBatches")
        return batch

    def resolve_columnar_packed(self, cols: packing.ColumnarBatch,
                                batch: packing.PackedBatch) -> BatchResult:
        """Dispatch and reply assembly for a pack_columnar_batch result.
        The conflicting-key report's begin keys are sliced out of the
        blob lazily: only for the rows the kernel flagged."""
        return self._dispatch_and_assemble(
            batch,
            report=[bool(int(f) & packing.COLUMNAR_FLAG_REPORT)
                    for f in cols.flags],
            begin_key_of_row=lambda r: packing.columnar_key(cols, r),
        )

    def resolve_columnar(self, cols: packing.ColumnarBatch,
                         version: int) -> BatchResult:
        """The columnar twin of resolve(): flat wire columns in, a
        BatchResult out, no per-transaction objects."""
        batch = self.pack_columnar_batch(cols, version)
        return self.resolve_columnar_packed(cols, batch)

    def _dispatch_and_assemble(self, batch: packing.PackedBatch, report,
                               begin_key_of_row) -> BatchResult:
        """The shared tail of resolve() and resolve_columnar(): dispatch
        the packed batch (tiered or classic) and assemble the reply."""
        self.metrics.add("resolveBatches")
        if self.tiered:
            out = self.resolve_args(batch.device_args())
        else:
            # the reply assembly below reads the overflow flag itself
            out = self._resolve_classic(batch.device_args())
        t2 = time.perf_counter()
        result = self._assemble_result(batch, out, report, begin_key_of_row)
        self.metrics.fence.sample(time.perf_counter() - t2)
        return result

    def _maybe_rebase(self, version: int) -> None:
        if version - self.base_version > REBASE_THRESHOLD:
            delta = version - self.base_version - (1 << 20)
            if self.sharded:
                self.state = tuple(_rebase_tiered(s, delta)
                                   for s in self.state)
            elif self.tiered:
                self.state = _rebase_tiered(self.state, delta)
            else:
                self.state = _rebase(self.state, delta)
            self.base_version += delta
            self.metrics.add("rebases")

    def _raise_overflow(self) -> None:
        self._batches_since_check = 0
        self.metrics.add("overflowRaised")
        cap = f"history_capacity={self.config.history_capacity}"
        if self.tiered:
            cap += f" / delta_capacity={self.config.delta_capacity}"
        raise HistoryOverflowError(
            f"{cap} exceeded; increase it (or lower the MVCC window / "
            "write rate, or compact the delta tier more often)"
        )

    def resolve_packed(self, batch: packing.PackedBatch) -> C.BatchVerdict:
        """Kernel-only path for a pre-packed batch (the caller owns
        version rebasing)."""
        return self.resolve_args(batch.device_args())

    def resolve_args(self, args: dict,
                     check_latch: bool = True) -> C.BatchVerdict:
        """One batch's device_args (numpy, or already converted by
        interop.device_args_to_torch) through the tiered kernel, or on
        the classic path through resolve_batch (exact: the classic
        single batch has no latch, as in the JAX package)."""
        if not self.tiered:
            out = self._resolve_classic(args)
            self.metrics.add("resolveBatches")
            self._maybe_check_overflow()
            return out
        stacked = {k: v[None] if isinstance(v, torch.Tensor)
                   else np.asarray(v)[None] for k, v in args.items()}
        outs = self._dispatch_tiered(stacked, check_latch=check_latch)
        return C.BatchVerdict(*(getattr(outs, f)[0]
                                for f in C.BatchVerdict._fields))

    def _resolve_classic(self, args: dict) -> C.BatchVerdict:
        t0 = time.perf_counter()
        self.state, out = C.resolve_batch(
            self.state, args, fixpoint_unroll=self.config.fixpoint_unroll,
            stats=self.metrics.fixpoint)
        self.metrics.kernel.sample(time.perf_counter() - t0)
        return out

    def resolve_args_scan(self, stacked_args: dict):
        """K batches stacked on a leading axis, resolved in order in one
        dispatch: batch i + 1 sees batch i's merged writes.

        Classic: K resolve_batch calls (the JAX package's _resolve_scan),
        a BatchVerdict with [K]-leading leaves. Tiered: the tiered group
        kernel, a GroupVerdict, as in the JAX package."""
        if self.tiered:
            return self._dispatch_tiered(stacked_args)
        g = interop.device_args_to_torch(stacked_args, self.device)
        kb = int(np.asarray(g["version"]).shape[0])
        t0 = time.perf_counter()
        outs = []
        for i in range(kb):
            self.state, out = C.resolve_batch(
                self.state, {k: v[i] for k, v in g.items()},
                fixpoint_unroll=self.config.fixpoint_unroll,
                stats=self.metrics.fixpoint)
            outs.append(out)
        self.metrics.kernel.sample(time.perf_counter() - t0)
        self.metrics.add("groupDispatches")
        self._batches_since_check += kb - 1
        self._maybe_check_overflow()
        return C.BatchVerdict(*(torch.stack([getattr(o, f) for o in outs])
                                for f in C.BatchVerdict._fields))

    def resolve_group_args(self, stacked_args: dict,
                           check_latch: bool = True) -> G.GroupVerdict:
        """G stacked batches (versions ascending) in one dispatch.

        Tiered: one main-table build, then the per-batch loop. Classic:
        the group kernel (ops/group.resolve_group; G <= MAX_GROUP,
        versions strictly ascending or ValueError), one merge per group.

        With the fixpoint latch (or, tiered, read dedup) a group may come
        back refused (`unconverged`, state unchanged); by default this
        re-runs it on the exact configuration, same arguments and same
        input state, so the caller never sees a latched verdict.
        `check_latch=False` hands back the refused group as it is (the
        caller falls back itself)."""
        if self.tiered:
            return self._dispatch_tiered(stacked_args,
                                         check_latch=check_latch)
        return self._dispatch_classic(stacked_args, check_latch=check_latch)

    # -- the staging pipeline -------------------------------------------

    def resolve_group_stream(self, host_groups: list,
                             check_latch: bool = True) -> list:
        """Resolve a stream of pre-stacked groups (numpy device_args
        with a leading [G] axis) through the staging pipeline; the
        GroupVerdicts in order."""
        return self._pipelined([[g] for g in host_groups], stack=False,
                               check_latch=check_latch)

    def resolve_stream_pipelined(self, batches: list, *, chunk: int = 8,
                                 depth: int = 2,
                                 check_latch: bool = False) -> list:
        """Resolve a stream of PackedBatches through a pack -> transfer ->
        compute pipeline: a staging thread stacks `chunk` batches at a
        time straight into a pinned slab (interop.Stager; versions must
        ascend in a chunk, as packing.stack_device_args requires) and
        copies it onto the device on a copy stream, at most `depth`
        staged chunks ahead of this thread, which only dispatches
        compute. The GroupVerdicts in chunk order; with check_latch
        False (the default, as in the JAX package) a refused chunk comes
        back `unconverged` for the caller to fall back."""
        groups = [batches[lo:lo + chunk]
                  for lo in range(0, len(batches), chunk)]
        return self._pipelined(groups, stack=True, depth=depth,
                               check_latch=check_latch)

    def _stager(self, depth: int) -> interop.Stager:
        """The pinned ring of this set's staging pipeline (kept while
        the depth stays the same, so its buffers are reused)."""
        stager = self._staging
        if stager is None or stager.n_slots != max(1, depth) + 1:
            stager = self._staging = interop.Stager(self.device, depth)
        return stager

    def _pipelined(self, items: list, *, stack: bool, depth: int = 2,
                   check_latch: bool = True) -> list:
        """The staging thread `resolver-staging` packs each item (with
        `stack`, a list of PackedBatches stacked into the slab; else a
        one-element list of a stacked group) and enqueues its copy
        (interop.Stager: the pack and transfer stages); this thread
        waits on each chunk's copy event and runs `resolve_group_args`.
        A sharded set stages once: its shard axis is a tensor axis of
        the group kernel.

        A failure on either side surfaces here: the staging thread hands
        its exception through the queue, and on a failure of this thread
        (HistoryOverflowError from the overflow check, say) the abort
        flag bounds every put of the staging thread, the queue is
        drained and the thread joined before the error propagates."""
        if not items:
            return []
        stager = self._stager(depth)
        q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        done = object()
        abort = threading.Event()

        def _put(obj) -> bool:
            while not abort.is_set():
                try:
                    q.put(obj, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def _stage():
            try:
                for item in items:
                    t0 = time.perf_counter()
                    ticket = stager.fill(
                        packing.group_args(item) if stack else item, stack)
                    t1 = time.perf_counter()
                    staged = stager.send(ticket)
                    # the enqueue of the copy: the copy itself overlaps
                    # compute (stage_ledger fences it)
                    self.metrics.pack.sample(t1 - t0)
                    self.metrics.transfer.sample(time.perf_counter() - t1)
                    self.metrics.add("stagedChunks")
                    if not _put(staged):
                        return
            except BaseException as e:  # surfaced on the consumer thread
                _put(e)
                return
            _put(done)

        t = threading.Thread(target=_stage, name="resolver-staging",
                             daemon=True)
        t.start()
        outs = []
        try:
            while True:
                staged = q.get()
                if staged is done:
                    break
                if isinstance(staged, BaseException):
                    raise staged
                args = stager.receive(*staged)
                outs.append(
                    self.resolve_group_args(args, check_latch=check_latch))
        finally:
            abort.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join()
        return outs

    def _run_classic(self, g: dict, latch: bool):
        return G.resolve_group(
            self.state, g, short_span_limit=self.config.short_span_limit,
            fixpoint_unroll=self.config.fixpoint_unroll,
            fixpoint_latch=latch, stats=self.metrics.fixpoint,
        )

    def _dispatch_classic(self, stacked_args: dict,
                          check_latch: bool = True) -> G.GroupVerdict:
        """One stacked group on the classic group kernel, honouring the
        latch contract as _dispatch_tiered does; the overflow check
        every OVERFLOW_CHECK_INTERVAL batches follows (a group of G
        counts G)."""
        g = interop.device_args_to_torch(stacked_args, self.device)
        versions = np.asarray(g["version"]).astype(np.int64).reshape(-1)
        if np.any(np.diff(versions) <= 0):
            raise ValueError(
                f"group versions must ascend strictly, got {versions.tolist()}"
                " (the cross-batch fold paints each batch's version over "
                "the earlier ones)")
        latch = self.config.fixpoint_latch
        t0 = time.perf_counter()
        state2, outs = self._run_classic(g, latch)
        self.metrics.add("groupDispatches")
        if latch and check_latch and bool(outs.unconverged.any()):
            self.metrics.add("latchTrips")
            self.metrics.add("exactFallbacks")
            state2, outs = self._run_classic(g, False)
        self.metrics.kernel.sample(time.perf_counter() - t0)
        self.state = state2
        self._batches_since_check += len(versions) - 1
        self._maybe_check_overflow()
        return outs

    def _run_tiered(self, g: dict, latch: bool, dedup: int):
        kw = dict(short_span_limit=self.config.short_span_limit,
                  fixpoint_unroll=self.config.fixpoint_unroll,
                  fixpoint_latch=latch, dedup_reads=dedup,
                  range_sweep=self.config.range_sweep,
                  stats=self.metrics.fixpoint)
        if self.sharded:
            return SH.resolve_group_sharded(self.state, g, self.part_lo,
                                            self.part_hi, **kw)
        return D.resolve_group_tiered(self.state, g, **kw)

    def _dispatch_tiered(self, stacked_args: dict,
                         check_latch: bool = True) -> G.GroupVerdict:
        """Run one stacked group on the tiered kernel, honouring the
        latch contract: a group the fixpoint latch or the dedup latch
        refused is re-run, same arguments and same input state, on the
        exact configuration (latch off, dedup 0; the sweep stays, it is
        not a latch source). Sharded, the trip is any shard's and the
        re-run takes every shard's input state. Delta spill compacts
        first when the group could overflow the delta tier (sharded: the
        one host bound of all shards); the overflow check every
        OVERFLOW_CHECK_INTERVAL batches and auto-compaction every
        config.compact_interval batches follow."""
        cfg = self.config
        g = interop.device_args_to_torch(stacked_args, self.device)
        kb = int(g["version"].shape[0])
        if cfg.delta_spill:
            # each batch adds at most 2 * max_writes boundary rows: fold
            # delta into main before a group that could pass capacity;
            # only a single group whose own bound exceeds it still
            # reaches the overflow raise
            add = 2 * cfg.max_writes * kb
            if self._spill_bound_rows + add > cfg.delta_capacity:
                self.compact_history()
                self.metrics.add("spills")
                code_probe(True, "resolver.delta_spill")
            self._spill_bound_rows += add
        if cfg.range_sweep:
            self.metrics.add("sweepGroups")
            code_probe(True, "resolver.range_sweep")
        latched = bool(cfg.fixpoint_latch or cfg.dedup_reads)
        t0 = time.perf_counter()
        state2, outs = self._run_tiered(g, cfg.fixpoint_latch,
                                        cfg.dedup_reads)
        self.metrics.add("groupDispatches")
        if latched and check_latch and bool(outs.unconverged.any()):
            self.metrics.add("latchTrips")
            self.metrics.add("exactFallbacks")
            state2, outs = self._run_tiered(g, False, 0)
        self.metrics.kernel.sample(time.perf_counter() - t0)
        self.state = state2
        self._batches_since_check += kb - 1
        self._maybe_check_overflow()
        # auto-compaction counts batches (a group of G counts G)
        self._batches_since_compact += kb
        interval = cfg.compact_interval
        if interval and self._batches_since_compact >= interval:
            self.compact_history()
        return outs

    def prewarm_exact(self, stacked_args: dict) -> None:
        """Make the exact fallback ready before a latch can trip.

        The JAX package compiles its exact program here by running it
        once and discarding the result. The port has nothing to compile:
        on the card this builds (where missing) and loads every kernel
        library (the sharded path's kernels I and J and the short-span
        kernel K among them: the exact fallback keeps the config's
        short_span_limit, as JAX's does), so a fallback costs no nvcc and
        no dlopen. It runs no resolve and
        leaves the state untouched; on the CPU it does nothing.
        `stacked_args` is accepted for the JAX signature. The classic
        path's fallback is served the same way. On the card its seconds
        go to the `compile` stage and it counts one `warmCompiles`."""
        del stacked_args
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            kernels.load_all()
            self.metrics.compile.sample(time.perf_counter() - t0)
            self.metrics.add("warmCompiles")

    def compact_history(self) -> None:
        """Fold the delta tier into main (ops/delta.compact; every shard,
        when sharded); nothing on the classic path, which has one tier."""
        if not self.tiered:
            return
        self._batches_since_compact = 0
        self._spill_bound_rows = 0
        self.metrics.add("compactions")
        self.state = (SH.compact_sharded(self.state) if self.sharded
                      else D.compact(self.state))

    def _re_anchor_spill_bound(self, d_live: float) -> None:
        """Tighten the spill bound to the delta tier's real occupancy,
        read on the sync the overflow check already paid: every
        dispatched batch has completed there, so the live count is
        exact. min(bound, live) stays conservative; spill timing moves
        compaction points only, never decisions. Sharded, `d_live` is
        the worst shard's count."""
        bound = int(d_live)
        if bound < self._spill_bound_rows:
            self._spill_bound_rows = bound
            self.metrics.add("spillBoundAnchors")

    def _maybe_check_overflow(self) -> None:
        self._batches_since_check += 1
        if self._batches_since_check >= OVERFLOW_CHECK_INTERVAL:
            self.check_overflow()

    def check_overflow(self) -> None:
        """Device sync: raise if a merge ever exceeded a tier's capacity
        (a latched delta overflow survives compaction in main's flag).
        Samples tier occupancy and device memory, and (tiered)
        re-anchors the spill bound, on the same sync. Sharded: overflow
        in any shard, the worst shard's occupancy and re-anchor, and one
        `collective` sample."""
        self._batches_since_check = 0
        if not self.tiered:
            tripped = bool(self.state.overflow)
            self.metrics.main_occupancy.sample(
                float(H.boundary_count(self.state)))
            self.metrics.sample_device_memory(self.device)
            if tripped:
                self._raise_overflow()
            return
        shards = self.state if self.sharded else (self.state,)
        tripped = bool(torch.stack([t.overflow for s in shards
                                    for t in s]).any())
        m_cnt, d_cnt = D.boundary_counts_per_shard(shards)
        d_live = float(d_cnt.max())
        self.metrics.main_occupancy.sample(float(m_cnt.max()))
        self.metrics.delta_occupancy.sample(d_live)
        self._re_anchor_spill_bound(d_live)
        if self.sharded:
            self._sample_collective()
        self.metrics.sample_device_memory(self.device)
        if tripped:
            self._raise_overflow()

    def _sample_collective(self) -> None:
        """Time one fenced cross-shard combine (kernel J alone, on
        verdict-shaped zeros of one batch) on the sync the overflow check
        already paid: the `collective` stage."""
        cfg = self.config
        if self._probe is None:
            self._probe = SH.combine_probe(cfg.n_shards, cfg.max_txns,
                                           cfg.max_reads, self.device)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        self._probe()
        if cuda:
            torch.cuda.synchronize(self.device)
        self.metrics.collective.sample(time.perf_counter() - t0)

    # -- reply assembly --------------------------------------------------

    def _assemble_result(self, batch, out: C.BatchVerdict, report,
                         begin_key_of_row) -> BatchResult:
        """Verdicts plus the conflicting-key report: history hits in
        begin-key order (SkipList.cpp:83,942), else the first
        intra-batch hit in range order (:880-899)."""
        n = batch.n_txns
        verdict = out.verdict[:n].cpu().numpy()
        # the sync the verdict read just paid also proves the history
        # they were computed against did not truncate
        if bool(out.overflow):
            self._raise_overflow()
        hist_read = out.hist_conflict_read[:batch.n_reads].cpu().numpy()
        intra_first = out.intra_first_range[:n].cpu().numpy()
        verdicts = [TransactionResult(int(v)) for v in verdict]

        hist_hits_by_txn: dict[int, list[tuple[bytes, int]]] = {}
        for r in np.flatnonzero(hist_read):
            t = int(batch.read_txn[r])
            hist_hits_by_txn.setdefault(t, []).append(
                (begin_key_of_row(int(r)), int(batch.read_index[r]))
            )
        conflicting: dict[int, list[int]] = {}
        for t in range(n):
            if not report[t] or verdicts[t] != TransactionResult.CONFLICT:
                continue
            if t in hist_hits_by_txn:
                hits = sorted(hist_hits_by_txn[t])  # begin-key order
                conflicting[t] = [i for _, i in hits]
            elif intra_first[t] >= 0:
                conflicting[t] = [int(intra_first[t])]
        return BatchResult(verdicts=verdicts,
                           conflicting_key_ranges=conflicting)


class CpuConflictSet:
    """The CPU backend: the same ConflictBatch interface served by the
    exact host-side semantic model (testing.oracle.ConflictOracle)."""

    def __init__(self, config: KernelConfig, base_version: int = 0):
        from foundationdb_tpu_torch.testing.oracle import (
            ConflictOracle,
            OracleTxn,
        )

        self.config = config
        self._oracle_txn = OracleTxn
        self._oracle = ConflictOracle(window=config.window_versions)
        self.metrics = KernelStageMetrics()

    def resolve(self, transactions: list[CommitTransaction],
                version: int) -> BatchResult:
        self.metrics.add("resolveBatches")
        res = self._oracle.resolve(
            [
                self._oracle_txn(
                    t.read_conflict_ranges,
                    t.write_conflict_ranges,
                    t.read_snapshot,
                    t.report_conflicting_keys,
                )
                for t in transactions
            ],
            version,
        )
        verdicts = [TransactionResult(v) for v in res.verdicts]
        conflicting = {
            t: idxs
            for t, idxs in res.conflicting_ranges.items()
            if transactions[t].report_conflicting_keys
            and verdicts[t] == TransactionResult.CONFLICT
        }
        return BatchResult(verdicts=verdicts,
                           conflicting_key_ranges=conflicting)

    def check_overflow(self) -> None:
        pass  # unbounded host memory


def make_conflict_set(config: KernelConfig, backend: str = "cuda",
                      device=None, shard_boundaries=None):
    """The port's conflict-set factory and the resolver_backend knob gate.

    backend "cuda": TorchConflictSet on `device` (None = the card; a
    missing card raises unless device="cpu" is passed, which runs the
    plain PyTorch versions on the CPU), sharded over `shard_boundaries`
    when config.n_shards > 1. backend "cpu": the host oracle (one
    resolver's semantics; testing/oracle.MultiResolverOracle models the
    sharded deployment). backend None: the knob
    SERVER_KNOBS.RESOLVER_BACKEND, gated: its "cuda" serves configs whose
    max_txns is under SERVER_KNOBS.RESOLVER_CUDA_MIN_BATCH on the CPU
    backend, with a ResolverBackendAutoRouted warning.
    """
    if backend is None:
        backend = SERVER_KNOBS.RESOLVER_BACKEND
        if backend == "cuda":
            return _gated_conflict_set(config, device, shard_boundaries)
    if backend == "cuda":
        return TorchConflictSet(config, device=device,
                                shard_boundaries=shard_boundaries)
    if backend == "cpu":
        return CpuConflictSet(config)
    raise ValueError(f"unknown backend {backend!r}")


def _gated_conflict_set(config: KernelConfig, device=None,
                        shard_boundaries=None):
    """The knob's "cuda" (the JAX package's gated "tpu"): the CPU backend
    under the min batch, else the card. The gate reads the config's
    static batch capacity, the largest batch this instance could take."""
    if config.max_txns < SERVER_KNOBS.RESOLVER_CUDA_MIN_BATCH:
        TraceEvent(
            "ResolverBackendAutoRouted", severity=SEV_WARN
        ).detail("Requested", "cuda").detail("Chosen", "cpu").detail(
            "MaxTxns", config.max_txns
        ).detail(
            "MinBatch", SERVER_KNOBS.RESOLVER_CUDA_MIN_BATCH
        ).log()
        return CpuConflictSet(config)
    return TorchConflictSet(config, device=device,
                            shard_boundaries=shard_boundaries)


def stage_ledger(config: KernelConfig, batches, *, fuse: int,
                 kernel_s: float, pipelined_s: float = 0.0,
                 occupancy_delta_capacity: int = None,
                 device=None) -> dict:
    """The per-stage ledger: pack / transfer / kernel / fence ms per
    fused group and the merge-row accounting, from the same
    `KernelStageMetrics` the resolve paths fill (the JAX package's
    `stage_ledger`, its keys; values unrounded), on `device` (None =
    the card).

    * pack: stacking every group on the host (the staging thread's
      work), through the pack stage.
    * transfer: each stacked group staged (interop.Stager: pinned slot,
      copy stream) and fenced, one sync a group: the copy the pipeline
      overlaps with compute.
    * kernel: `kernel_s`, the caller's measurement of the stream with
      its arguments already on the device.
    * fence: a pass of the same groups with a sync after each group,
      minus `kernel_s`.
    * merge rows: what one group's history merge touches; tiered, the
      delta tier's end-of-stream occupancy comes from a second pass with
      compaction and spill off (delta sized by
      `occupancy_delta_capacity`, else the history capacity).
    """
    n_batches = len(batches)
    groups = [batches[g: g + fuse] for g in range(0, n_batches, fuse)]
    n_groups = len(groups)
    tiered = config.delta_capacity > 0

    cs = TorchConflictSet(config, device=device)
    cuda = cs.device.type == "cuda"
    host_groups = []
    for grp in groups:
        t0 = time.perf_counter()
        host_groups.append(packing.stack_device_args(grp))
        cs.metrics.pack.sample(time.perf_counter() - t0)
    stager = interop.Stager(cs.device, depth=1)
    if cuda:  # the pinned slabs are allocated before the timed copies
        stager.reserve(max(interop.slab_layout([hg], False)[2]
                           for hg in host_groups))
    staged = []
    for hg in host_groups:
        t0 = time.perf_counter()
        args, event = stager.stage(hg)
        # a sync a group is the measurement here: the copy's true cost
        if event is not None:
            event.synchronize()
        cs.metrics.transfer.sample(time.perf_counter() - t0)
        staged.append(stager.receive(args, event))
    pack_s = cs.metrics.pack.total
    transfer_s = cs.metrics.transfer.total

    t0 = time.perf_counter()
    for dg in staged:
        out = cs.resolve_group_args(dg, check_latch=False)
        out.verdict.cpu()  # a fence a group
    fenced_s = time.perf_counter() - t0

    nrw = config.max_reads + config.max_writes
    ledger = {
        "pack_ms_per_group": pack_s / n_groups * 1e3,
        "transfer_ms_per_group": transfer_s / n_groups * 1e3,
        "kernel_ms_per_group": kernel_s / n_groups * 1e3,
        "fence_ms_per_group": max(0.0, fenced_s - kernel_s) / n_groups * 1e3,
        "pipelined_ms_per_group": pipelined_s / n_groups * 1e3,
        "merge_rows_classic_per_group": (
            config.history_capacity + 2 * fuse * nrw
        ),
    }
    if tiered:
        occ_cap = occupancy_delta_capacity or config.history_capacity
        cs_occ = TorchConflictSet(
            dataclasses.replace(config, compact_interval=0,
                                delta_capacity=occ_cap, delta_spill=False),
            device=cs.device)
        for dg in staged:
            cs_occ.resolve_group_args(dg, check_latch=False)
        m_cnt, d_cnt = D.boundary_counts(cs_occ.state)
        d_live, m_live = int(d_cnt), int(m_cnt)
        cs_occ.metrics.delta_occupancy.sample(float(d_live))
        cs_occ.metrics.main_occupancy.sample(float(m_live))
        ledger["merge_rows_tiered_per_batch_cap"] = (
            config.delta_capacity + 2 * nrw
        )
        ledger["merge_rows_tiered_per_batch_live"] = d_live + 2 * nrw
        ledger["delta_live_boundaries"] = d_live
        ledger["main_live_boundaries"] = m_live
    if cuda:
        torch.cuda.synchronize(cs.device)
    return ledger


# ---------------------------------------------------------------------------
# Contention-profile routing: a host-side classifier of a batch's
# contention regime (hot keys, wide scans, neither) and the backend
# that serves it, copied from the JAX package. Both profiles stay on
# the card once the config carries the structure each needs: read
# dedup for hot_key, the endpoint sweep for range_heavy.


def _fold_key64(data, jj=None):
    """Fold each key row of a [N, ncol] big-endian word array into one
    int64 anchored at the first varying word: the one classifier core
    that `profile_batch` (packed words) and `profile_transactions` (raw
    key bytes packed to words) both run, so the two agree on every
    keyspace.

    Keyspaces with a common prefix keep leading words constant, so the
    span window anchors at the first word that varies. The successor
    word joins the low slot only when it varies in the sample: a
    constant successor (the zero padding past short keys, say) would
    scale every span by 2^32. Duplicate detection does not use this
    fold: _classify compares full key rows.

    jj: optional (j, use_succ) from a previous call, so range end keys
    fold through the same window as their begin keys.
    Returns (vals [N] int64, (j, use_succ)).
    """
    ncol = data.shape[1]
    if jj is None:
        j = 0
        while j < ncol - 1 and len(np.unique(data[:, j])) == 1:
            j += 1
        use_succ = j + 1 < ncol and len(np.unique(data[:, j + 1])) > 1
        jj = (j, use_succ)
    j, use_succ = jj
    if use_succ:
        hi, lo = data[:, j], data[:, j + 1]
    else:
        # the varying word is effectively the last one: it must occupy
        # the low slot or every span scales by 2^32
        hi, lo = np.zeros(len(data), np.int64), data[:, j]
    return (hi << 32) | lo, jj


def _keys_to_words(keys, width: int):
    """Raw key bytes -> [N, width] int64 big-endian uint32 words, zero-
    padded: the word layout utils/packing gives a PackedBatch's key
    tensors (minus the length word), so _fold_key64 sees the same
    representation from both classifiers."""
    out = np.zeros((len(keys), width), np.int64)
    for i, k in enumerate(keys):
        padded = k.ljust(width * 4, b"\0")[: width * 4]
        out[i] = np.frombuffer(padded, dtype=">u4").astype(np.int64)
    return out


#: classification thresholds shared by both classifiers: a duplicate
#: write-key rate above DUP_HOT is hot-key contention, and a mean read
#: span above SPAN_RANGE keyspace units is range-heavy (point reads span
#: 1-2 units, scans tens to hundreds).
PROFILE_DUP_HOT = 0.25
PROFILE_SPAN_RANGE = 32


def _classify(wrows, rbvals, revals) -> str:
    """Shared threshold logic: `wrows` is the [N, ncol] write-key word
    array (duplicates by exact row uniqueness), while spans use the
    folded int64 window."""
    if len(wrows):
        dup = 1.0 - len(np.unique(wrows, axis=0)) / len(wrows)
        if dup > PROFILE_DUP_HOT:
            return "hot_key"
    if len(rbvals):
        span = float(np.mean(np.minimum(
            np.maximum(revals - rbvals, 0), 1 << 20
        )))
        if span > PROFILE_SPAN_RANGE:
            return "range_heavy"
    return "uniform"


def profile_batch(batch, sample: int = 2048) -> str:
    """Classify a PackedBatch's contention regime: "uniform" |
    "hot_key" | "range_heavy". Host-side, O(sample)."""
    nw = max(1, batch.n_writes)
    nr = max(1, batch.n_reads)

    def words(arr, n):
        a = arr[: min(n, sample)].astype(np.int64)
        return a[:, :-1] if a.shape[1] > 1 else a  # drop the length word

    rb, jj = _fold_key64(words(batch.read_begin, nr))
    re, _ = _fold_key64(words(batch.read_end, nr), jj)
    return _classify(words(batch.write_begin, nw), rb, re)


def profile_transactions(txns, sample: int = 512) -> str:
    """profile_batch for raw CommitTransaction lists (the resolver's
    input). Host-side, O(sample). Packs the sampled keys into the word
    representation a PackedBatch carries and runs the same _fold_key64
    core, so routing on raw transactions and on the packed batch agree."""
    writes = [
        r[0] for t in txns[:sample] for r in t.write_conflict_ranges
    ][:sample]
    reads = [
        r for t in txns[:sample] for r in t.read_conflict_ranges
    ][:sample]
    if len(writes) < 16 and not reads:
        return "uniform"
    width = max(
        [1] + [-(-len(k) // 4) for k in writes]
        + [-(-len(b) // 4) for b, _ in reads]
        + [-(-len(e) // 4) for _, e in reads]
    )
    # a sample of under 16 writes gives a duplicate rate too noisy to use
    wrows = _keys_to_words(writes if len(writes) >= 16 else [], width)
    if reads:
        rbvals, jj = _fold_key64(
            _keys_to_words([b for b, _ in reads], width)
        )
        revals, _ = _fold_key64(
            _keys_to_words([e for _, e in reads], width), jj
        )
    else:
        rbvals = revals = _keys_to_words([], width)[:, 0]
    return _classify(wrows, rbvals, revals)


def backend_for_profile(profile: str, config=None) -> str:
    """The backend that serves a contention profile: "cuda" (this
    package's conflict set on the card) or "cpu" (the host oracle).

    * uniform always stays on the card;
    * hot_key stays on the card with the tiered kernel plus read dedup
      (`dedup_reads > 0`): the dedup probe's searches scale with the
      distinct ranges, the delta tier with the distinct boundaries;
    * range_heavy stays on the card with the tiered kernel plus the
      endpoint sweep (`range_sweep`): one rank launch per group and one
      table query per read, whatever the scan width.
    """
    if profile == "uniform":
        return "cuda"
    if (
        profile == "hot_key"
        and config is not None
        and getattr(config, "delta_capacity", 0) > 0
        and getattr(config, "dedup_reads", 0) > 0
    ):
        return "cuda"
    if (
        profile == "range_heavy"
        and config is not None
        and getattr(config, "delta_capacity", 0) > 0
        and getattr(config, "range_sweep", False)
    ):
        return "cuda"
    return "cpu"


def fallback_free(config) -> bool:
    """True when this config leaves the router nothing to route away:
    its profile resolves on the card (the dedup probe for hot_key, the
    endpoint sweep for range_heavy) and delta pressure spills and
    compacts instead of raising.

    dedup_reads and range_sweep are per-profile probe choices and
    exclusive on one instance: a deployment covers every profile by
    routing per stream and configuring the probe for the profile it
    routed."""
    return bool(
        config is not None
        and getattr(config, "delta_capacity", 0) > 0
        and getattr(config, "delta_spill", False)
        and (
            getattr(config, "dedup_reads", 0) > 0
            or getattr(config, "range_sweep", False)
        )
    )


def route_stream(batches, config, sample_batches: int = 2) -> str:
    """The backend for a stream, from its leading batches' profiles and
    the batch-capacity gate (SERVER_KNOBS.RESOLVER_CUDA_MIN_BATCH):
    "cuda" when every sampled profile is served on the card by this
    config (backend_for_profile), else "cpu"."""
    if config.max_txns < SERVER_KNOBS.RESOLVER_CUDA_MIN_BATCH:
        return "cpu"
    profiles = [profile_batch(b) for b in batches[:sample_batches]]
    chosen = {backend_for_profile(p, config) for p in profiles}
    if chosen == {"cuda"}:
        return "cuda"
    return "cpu"
