"""TorchConflictSet: the host-facing conflict-detection object of the port.

Port of the tiered, exact surface of foundationdb_tpu.models.
conflict_set.TpuConflictSet: persistent two-tier MVCC write history on a
device plus a batch-at-a-time detect API (the reference's ConflictSet +
ConflictBatch, fdbserver/include/fdbserver/ConflictSet.h:30-75).

* State is an ops.delta.TieredState on `device` (the card unless the
  caller asks for the CPU); every batch runs the tiered kernel
  (ops/delta.py) and the host folds delta into main every
  `config.compact_interval` batches.
* Versions are int32 offsets of `base_version`; `_maybe_rebase` shifts
  every stored offset (NEG stays NEG) when the chain drifts too far.
* Capacity overflow is latched on the device and surfaced in every
  verdict: `resolve()` refuses to externalize decisions computed
  against a truncated history, and the kernel-only paths check every
  OVERFLOW_CHECK_INTERVAL batches. Overflow raises, never truncates.

The port serves the exact tiered configuration only: a config with a
variant knob set (short-span ops, fixpoint latch, read dedup, range
sweep, delta spill, sharding) or without a delta tier is refused.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from foundationdb_tpu_torch import interop
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
from foundationdb_tpu_torch.utils import packing

# Rebase when offsets pass 2**30 (the window is ~5e6; huge margin).
REBASE_THRESHOLD = 1 << 30

#: Overflow is checked host-side every this many batches on the
#: kernel-only paths (each check is a device sync).
OVERFLOW_CHECK_INTERVAL = 32

#: config knobs selecting kernel variants the port does not serve yet
_VARIANT_KNOBS = ("short_span_limit", "fixpoint_latch", "dedup_reads",
                  "range_sweep", "delta_spill")


class Stage:
    """Count, total and max of one sampled quantity (seconds or rows)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def sample(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.max = max(self.max, v)

    def as_dict(self) -> dict:
        return {"count": self.count, "total": self.total, "max": self.max}


class KernelStageMetrics:
    """Per-stage telemetry of the resolve paths.

    pack / kernel / fence are host wall-clock seconds: "kernel" covers
    the dispatch of the tiered kernel (asynchronous on the card except
    the fixpoint loop's syncs), "fence" the reply assembly that waits
    for the verdicts. Occupancy and device memory are sampled on the
    overflow-check syncs; `fixpoint` counts the fixpoint's depth.
    """

    COUNTERS = ("resolveBatches", "groupDispatches", "compactions",
                "rebases", "overflowRaised")

    def __init__(self):
        self.counters = {name: 0 for name in self.COUNTERS}
        self.pack = Stage("packSeconds")
        self.kernel = Stage("kernelSeconds")
        self.fence = Stage("fenceSeconds")
        self.delta_occupancy = Stage("deltaLiveBoundaries")
        self.main_occupancy = Stage("mainLiveBoundaries")
        self.fixpoint = G.FixpointStats()
        self.device_bytes_in_use = 0
        self.device_peak_bytes = 0

    def add(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

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
        out: dict = dict(self.counters)
        for s in (self.pack, self.kernel, self.fence, self.delta_occupancy,
                  self.main_occupancy):
            out[s.name] = s.as_dict()
        out["fixpoint"] = dataclasses.asdict(self.fixpoint)
        out["deviceBytesInUse"] = self.device_bytes_in_use
        out["devicePeakBytes"] = self.device_peak_bytes
        return out


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


def _check_config(config: KernelConfig) -> None:
    if config.delta_capacity <= 0:
        raise ValueError(
            "the port serves the tiered path only (delta_capacity > 0); "
            "the classic single-tier kernel is not ported yet"
        )
    if config.n_shards > 1:
        raise ValueError("the sharded kernel is not ported yet")
    for knob in _VARIANT_KNOBS:
        if getattr(config, knob):
            raise ValueError(
                f"{knob} selects a kernel variant the port does not serve "
                "yet; the port runs the exact tiered kernel"
            )


class TorchConflictSet:
    """Batch MVCC conflict detection with device-resident tiered history."""

    def __init__(self, config: KernelConfig, base_version: int = 0, *,
                 device=None):
        _check_config(config)
        self.config = config
        self.base_version = base_version
        self.device = resolve_device(device)
        self.state = D.init(config, self.device)
        self.metrics = KernelStageMetrics()
        self._batches_since_check = 0
        self._batches_since_compact = 0

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
        self.metrics.add("resolveBatches")
        out = self.resolve_args(batch.device_args())
        t2 = time.perf_counter()
        result = self._assemble_result(
            batch, out,
            report=[t.report_conflicting_keys for t in transactions],
            begin_key_of_row=lambda r: transactions[
                int(batch.read_txn[r])
            ].read_conflict_ranges[int(batch.read_index[r])][0],
        )
        self.metrics.fence.sample(time.perf_counter() - t2)
        return result

    def _maybe_rebase(self, version: int) -> None:
        if version - self.base_version > REBASE_THRESHOLD:
            delta = version - self.base_version - (1 << 20)
            self.state = _rebase_tiered(self.state, delta)
            self.base_version += delta
            self.metrics.add("rebases")

    def _raise_overflow(self) -> None:
        self._batches_since_check = 0
        self.metrics.add("overflowRaised")
        raise HistoryOverflowError(
            f"history_capacity={self.config.history_capacity} / "
            f"delta_capacity={self.config.delta_capacity} exceeded; "
            "increase it (or lower the MVCC window / write rate, or "
            "compact the delta tier more often)"
        )

    def resolve_packed(self, batch: packing.PackedBatch) -> C.BatchVerdict:
        """Kernel-only path for a pre-packed batch (the caller owns
        version rebasing)."""
        return self.resolve_args(batch.device_args())

    def resolve_args(self, args: dict) -> C.BatchVerdict:
        """One batch's device_args (numpy, or already converted by
        interop.device_args_to_torch) through the tiered kernel."""
        stacked = {k: v[None] if isinstance(v, torch.Tensor)
                   else np.asarray(v)[None] for k, v in args.items()}
        outs = self._dispatch_tiered(stacked)
        return C.BatchVerdict(*(getattr(outs, f)[0]
                                for f in C.BatchVerdict._fields))

    def resolve_group_args(self, stacked_args: dict) -> G.GroupVerdict:
        """G stacked batches (versions ascending) in one dispatch: one
        main-table build, then the per-batch loop."""
        return self._dispatch_tiered(stacked_args)

    def _dispatch_tiered(self, stacked_args: dict) -> G.GroupVerdict:
        """Run one stacked group on the tiered kernel; the overflow check
        every OVERFLOW_CHECK_INTERVAL batches and auto-compaction every
        config.compact_interval batches."""
        g = interop.device_args_to_torch(stacked_args, self.device)
        kb = int(g["version"].shape[0])
        t0 = time.perf_counter()
        self.state, outs = D.resolve_group_tiered(
            self.state, g, fixpoint_unroll=self.config.fixpoint_unroll,
            stats=self.metrics.fixpoint,
        )
        self.metrics.kernel.sample(time.perf_counter() - t0)
        self.metrics.add("groupDispatches")
        self._batches_since_check += kb
        if self._batches_since_check >= OVERFLOW_CHECK_INTERVAL:
            self.check_overflow()
        self._batches_since_compact += kb
        interval = self.config.compact_interval
        if interval and self._batches_since_compact >= interval:
            self.compact_history()
        return outs

    def compact_history(self) -> None:
        """Fold the delta tier into main (ops/delta.compact)."""
        self._batches_since_compact = 0
        self.metrics.add("compactions")
        self.state = D.compact(self.state)

    def check_overflow(self) -> None:
        """Device sync: raise if a merge ever exceeded a tier's capacity
        (a latched delta overflow survives compaction in main's flag).
        Samples tier occupancy and device memory on the same sync."""
        self._batches_since_check = 0
        tripped = bool(self.state.main.overflow) or bool(
            self.state.delta.overflow)
        m_cnt, d_cnt = D.boundary_counts(self.state)
        self.metrics.main_occupancy.sample(float(m_cnt))
        self.metrics.delta_occupancy.sample(float(d_cnt))
        self.metrics.sample_device_memory(self.device)
        if tripped:
            self._raise_overflow()

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
                      device=None):
    """The port's conflict-set factory.

    backend "cuda": TorchConflictSet on `device` (None = the card; a
    missing card raises unless device="cpu" is passed, which runs the
    plain PyTorch versions on the CPU). backend "cpu": the host oracle.
    """
    if backend == "cuda":
        return TorchConflictSet(config, device=device)
    if backend == "cpu":
        return CpuConflictSet(config)
    raise ValueError(f"unknown backend {backend!r}")
