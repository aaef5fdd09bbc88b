"""Counters, a decaying rate, gauges, latency samples and bands: the
Stats.h / DDSketch analog (the port's own copy of
foundationdb_tpu.utils.metrics).

* `Counter` / `CounterCollection` ~ fdbrpc/include/fdbrpc/Stats.h:77-113.
* `Smoother` ~ the reference's exponential time-decay Smoother, on an
  injected clock (a simulation passes its virtual clock);
  `TimerSmoother` is the same on the wall clock, for role processes.
* `LatencySample` ~ DDSketch (fdbrpc/include/fdbrpc/DDSketch.h): a
  log-bucketed histogram with relative error eps (gamma = (1 + eps) /
  (1 - eps)), for p50 / p95 / p99.
* `Gauge`, `MetricHistory` and `sparkline`: a current-value sensor, a
  bounded (time, value) ring and its one-line rendering.
* `LatencyBands` ~ fdbrpc/Stats.h LatencyBands, with the commit, GRV and
  read band thresholds the simulated cluster's roles record.
"""

from __future__ import annotations

import math
import time as _time
from typing import Callable, Optional

from foundationdb_tpu_torch.utils.probes import code_probe, declare

declare("metrics.latency_band_overflow")


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def add(self, n: int = 1) -> None:
        self.value += n


class CounterCollection:
    """A named group of counters."""

    def __init__(self, name: str, counters: list[str] = ()):  # type: ignore[assignment]
        self.name = name
        self._counters: dict[str, Counter] = {}
        for c in counters:
            self._counters[c] = Counter(c)

    def __getitem__(self, name: str) -> Counter:
        if name not in self._counters:
            self._counters[name] = Counter(name)
        return self._counters[name]

    def add(self, name: str, n: int = 1) -> None:
        self[name].add(n)

    def get(self, name: str) -> int:
        return self[name].value

    def as_dict(self) -> dict[str, int]:
        return {k: c.value for k, c in self._counters.items()}


class Smoother:
    """Exponential time-decay smoother (fdbrpc/Stats.h Smoother).

    Tracks a total whose smoothed estimate decays toward the true total
    with e-folding time `folding_time`; `smooth_rate()` is the decayed
    estimate of d(total)/dt. The clock is injected, so a simulation's
    virtual clock keeps the values deterministic per seed. Updates at a
    clock that has not moved are absorbed exactly.
    """

    __slots__ = ("folding_time", "clock", "time", "total", "estimate")

    def __init__(self, folding_time: float,
                 clock: Optional[Callable[[], float]] = None):
        if folding_time <= 0:
            raise ValueError(f"folding_time must be > 0, got {folding_time}")
        self.folding_time = folding_time
        self.clock = clock or (lambda: 0.0)
        self.reset(0.0)

    def reset(self, value: float) -> None:
        self.time = self.clock()
        self.total = value
        self.estimate = value

    def _update(self) -> None:
        t = self.clock()
        elapsed = t - self.time
        if elapsed > 0:
            self.time = t
            self.estimate += (self.total - self.estimate) * (
                1.0 - math.exp(-elapsed / self.folding_time)
            )

    def set_total(self, total: float) -> None:
        self.add_delta(total - self.total)

    def add_delta(self, delta: float) -> None:
        self._update()
        self.total += delta

    def smooth_total(self) -> float:
        self._update()
        return self.estimate

    def smooth_rate(self) -> float:
        """Decayed d(total)/dt."""
        self._update()
        return (self.total - self.estimate) / self.folding_time


class TimerSmoother(Smoother):
    """Smoother on the wall clock (the reference's TimerSmoother reads
    timer() where Smoother reads now()): for a role served as an OS
    process, where there is no virtual clock. Never inside a
    simulation, whose traced output must stay deterministic."""

    def __init__(self, folding_time: float):
        super().__init__(folding_time, clock=_time.monotonic)


class Gauge:
    """A named current-value sensor: set() directly, or bind a supplier
    callable so readers always see the live value (the status JSON's
    pull model — the reference's StorageQueueInfo fields are exactly
    this shape, sampled at status time)."""

    __slots__ = ("name", "_value", "_supplier")

    def __init__(self, name: str, supplier: Optional[Callable[[], float]] = None):
        self.name = name
        self._value = 0.0
        self._supplier = supplier

    def set(self, value: float) -> None:
        self._value = value

    def get(self) -> float:
        if self._supplier is not None:
            return self._supplier()
        return self._value


class MetricHistory:
    """Bounded ring buffer of (time, value) samples: sparkline-grade
    time series for fdbtop's per-role history columns. Fixed capacity,
    O(1) append, oldest-first iteration; memory is bounded however long
    the process lives (the TraceLog rolling discipline for gauges)."""

    __slots__ = ("capacity", "_buf", "_next", "_full")

    def __init__(self, capacity: int = 60):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self.capacity = capacity
        self._buf: list = [None] * capacity
        self._next = 0
        self._full = False

    def append(self, t: float, value: float) -> None:
        self._buf[self._next] = (t, value)
        self._next = (self._next + 1) % self.capacity
        if self._next == 0:
            self._full = True

    def __len__(self) -> int:
        return self.capacity if self._full else self._next

    def samples(self) -> list[tuple[float, float]]:
        """Oldest-first (time, value) pairs."""
        if not self._full:
            return [s for s in self._buf[: self._next]]
        return [
            s for s in self._buf[self._next:] + self._buf[: self._next]
        ]

    def values(self) -> list[float]:
        return [v for _t, v in self.samples()]

    def last(self) -> Optional[float]:
        n = len(self)
        if n == 0:
            return None
        return self._buf[(self._next - 1) % self.capacity][1]


def sparkline(values: list[float], width: int = 24) -> str:
    """Render a value series as a unicode sparkline (fdbtop's history
    column). Scales to the series' own min/max; empty series -> ''."""
    if not values:
        return ""
    ticks = "▁▂▃▄▅▆▇█"
    vals = values[-width:]
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return ticks[0] * len(vals)
    return "".join(
        ticks[min(len(ticks) - 1, int((v - lo) / span * len(ticks)))]
        for v in vals
    )


class LatencySample:
    """Log-bucketed quantile sketch (DDSketch-style, relative error eps)."""

    def __init__(self, name: str, eps: float = 0.01):
        self.name = name
        self.eps = eps
        self._gamma = (1 + eps) / (1 - eps)
        self._log_gamma = math.log(self._gamma)
        self._buckets: dict[int, int] = {}
        self._zero = 0
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def sample(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        if value <= 0:
            self._zero += 1
            return
        idx = math.ceil(math.log(value) / self._log_gamma)
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        if rank < self._zero:
            return 0.0
        acc = self._zero
        for idx in sorted(self._buckets):
            acc += self._buckets[idx]
            if acc > rank:
                # midpoint of bucket (gamma^(idx-1), gamma^idx]
                return 2.0 * self._gamma**idx / (1 + self._gamma)
        return self.max or 0.0

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def as_dict(self) -> dict[str, float]:
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "max": self.max or 0.0,
        }


COMMIT_LATENCY_BANDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 1.0)
GRV_LATENCY_BANDS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.1, 1.0)
READ_LATENCY_BANDS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.1, 1.0)


class LatencyBands:
    """Fixed-threshold latency histogram (fdbrpc/Stats.h LatencyBands).

    Each sample lands in the first band whose upper threshold covers it;
    samples above every threshold land in the `inf` overflow bucket —
    the band the reference's status schema renders as the catch-all
    (and the one worth a CODE_PROBE: an overflow hit means the
    operation blew past every budget the bands encode).
    """

    def __init__(self, name: str, bands=COMMIT_LATENCY_BANDS):
        self.name = name
        self.bands = tuple(sorted(bands))
        self.counts = [0] * (len(self.bands) + 1)  # +1: overflow bucket
        self.total = 0

    def add(self, latency: float) -> None:
        self.total += 1
        for i, ub in enumerate(self.bands):
            if latency <= ub:
                self.counts[i] += 1
                return
        code_probe(True, "metrics.latency_band_overflow")
        self.counts[-1] += 1

    def as_dict(self) -> dict[str, int]:
        """Band upper-bound -> count, the status-schema shape
        (`latency_statistics` buckets in Schemas.cpp)."""
        out: dict[str, int] = {"total": self.total}
        for ub, c in zip(self.bands, self.counts):
            out[f"{ub:g}"] = c
        out["inf"] = self.counts[-1]
        return out
