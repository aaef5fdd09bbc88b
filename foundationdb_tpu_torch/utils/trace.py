"""Structured trace logging: TraceEvent and the commit-path micro-events
(the port's own copy of foundationdb_tpu.utils.trace).

Behavioral mirror of `flow/Trace.cpp`:

* `TraceEvent(type).detail(k, v).log()` builds one structured event
  with a severity and a (virtual) time; `TraceLog` keeps it in memory
  and, given a path, as JSON lines, rolling at `max_events`.
* `TraceBatch` (`g_traceBatch`, flow/Trace.h:576): low-overhead
  commit-path micro-events with Location strings
  ("Resolver.resolveBatch.Before", ...; utils/commit_debug.py).
* `trace_counters` (fdbrpc/Stats.h:93): a periodic counter snapshot.

The process-wide sinks (`g_trace`, `g_trace_batch`) are swapped per run
with `install()`, which returns the previous pair.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional

from foundationdb_tpu_torch.utils.probes import code_probe, declare

declare("metrics.counters_flushed")

SEV_DEBUG = 5
SEV_INFO = 10
SEV_WARN = 20
SEV_WARN_ALWAYS = 30
SEV_ERROR = 40


class TraceEvent:
    def __init__(self, event_type: str, *, severity: int = SEV_INFO,
                 logger: "TraceLog" = None):
        self.type = event_type
        self.severity = severity
        self.fields: dict[str, Any] = {}
        self._logger = logger or g_trace

    def detail(self, key: str, value) -> "TraceEvent":
        self.fields[key] = value
        return self

    def log(self) -> None:
        self._logger.emit(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.log()
        return False


class TraceLog:
    """In-memory + optional JSONL-file sink with severity filtering.

    Both sinks roll at `max_events`: the in-memory list drops its oldest
    half, and the file sink rotates `path` -> `path + ".1"` (one
    generation kept).
    """

    def __init__(self, *, min_severity: int = SEV_INFO,
                 clock: Optional[Callable[[], float]] = None,
                 path: Optional[str] = None, max_events: int = 100_000):
        self.min_severity = min_severity
        self.clock = clock or (lambda: 0.0)
        self.events: list[dict] = []
        self.max_events = max_events
        self.path = path
        self.rolls = 0
        self._fh = open(path, "a") if path else None
        self._file_events = 0

    def emit(self, ev: TraceEvent) -> None:
        if ev.severity < self.min_severity:
            return
        # an explicit "Time" detail wins over the sink clock: batched
        # micro-events carry their own capture time
        rec = {"Type": ev.type, "Severity": ev.severity,
               "Time": round(self.clock(), 6), **ev.fields}
        self.events.append(rec)
        if len(self.events) > self.max_events:
            del self.events[: self.max_events // 2]
        if self._fh:
            self._fh.write(json.dumps(_jsonable(rec)) + "\n")
            self._fh.flush()
            self._file_events += 1
            if self._file_events >= self.max_events:
                self._roll_file()

    def _roll_file(self) -> None:
        """Rotate the file sink: current -> .1 (previous .1 dropped)."""
        self.rolls += 1
        self._file_events = 0
        self._fh.close()
        os.replace(self.path, self.path + ".1")
        self._fh = open(self.path, "a")

    def find(self, event_type: str) -> list[dict]:
        return [e for e in self.events if e["Type"] == event_type]

    def flush(self) -> None:
        if self._fh:
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def _jsonable(rec):
    return {
        k: (v.decode("latin-1") if isinstance(v, bytes) else v)
        for k, v in rec.items()
    }


class TraceBatch:
    """g_traceBatch: (name, id, location) micro-events on the hot path.

    With a `logger`, every event lands in that TraceLog as a record
    (Type=name, ID, Location, Time); without one, in `events` until
    `dump()` drains them.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 *, logger: Optional[TraceLog] = None, enabled: bool = True):
        self.clock = clock or (lambda: 0.0)
        self.events: list[tuple[float, str, str, str]] = []
        self.enabled = enabled
        self.logger = logger

    def _record(self, name: str, ident: str, location: str) -> None:
        t = self.clock()
        if self.logger is not None:
            TraceEvent(name, severity=SEV_DEBUG, logger=self.logger) \
                .detail("ID", ident).detail("Location", location) \
                .detail("Time", round(t, 6)).log()
        else:
            self.events.append((t, name, ident, location))

    def add_event(self, name: str, ident: str, location: str) -> None:
        if self.enabled:
            self._record(name, ident, location)

    def add_attach(self, name: str, ident: str, to: str) -> None:
        if self.enabled:
            self._record(name, ident, f"attach:{to}")

    def dump(self) -> list[tuple[float, str, str, str]]:
        out, self.events = self.events, []
        return out


def trace_counters(logger: TraceLog, name: str, ident: str, counters) -> None:
    """Periodic counter snapshot (CounterCollection::traceCounters)."""
    code_probe(True, "metrics.counters_flushed")
    ev = TraceEvent(name, logger=logger).detail("ID", ident)
    for k, v in counters.as_dict().items():
        ev.detail(k, v)
    ev.log()


#: process-wide default sinks (swapped per run with install())
g_trace = TraceLog()
g_trace_batch = TraceBatch(enabled=False)


def install(log: TraceLog, batch: TraceBatch):
    """Install per-run sinks; returns the previous (log, batch) pair so
    callers can restore them."""
    global g_trace, g_trace_batch
    old = (g_trace, g_trace_batch)
    g_trace, g_trace_batch = log, batch
    return old
