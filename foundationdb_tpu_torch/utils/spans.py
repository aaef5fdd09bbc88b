"""OTEL-style spans: trace contexts threaded through every request (the
port's own copy of foundationdb_tpu.utils.spans).

The reference threads a `Span`/`SpanContext` through each RPC
(fdbclient/Tracing.actor.cpp; `ResolveTransactionBatchRequest.spanContext`
ResolverInterface.h:129) and exports finished spans to a collector:

* `SpanContext(trace_id, span_id)`: ids come from the active exporter's
  counter, so a fresh exporter per run gives reproducible ids.
* `Span(location, parent=ctx, clock=...)`: start and end from an
  injectable clock (virtual time works), key-value attributes;
  `finish()` hands it to the exporter bound when it was created.
* `SpanExporter`: an in-memory collector with an optional TraceLog sink.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class SpanContext:
    trace_id: int
    span_id: int

    def as_tuple(self) -> tuple[int, int]:
        return (self.trace_id, self.span_id)


def make_context(trace_id: Optional[int] = None) -> SpanContext:
    """New context; ids come from the active exporter's counter."""
    with _lock:
        _exporter._next_id += 1
        sid = _exporter._next_id
    return SpanContext(trace_id=trace_id if trace_id is not None else sid,
                       span_id=sid)


class SpanExporter:
    """Collects finished spans (the collector role)."""

    def __init__(self, trace_log=None, *, max_finished: int = 10_000):
        self.finished: list[dict] = []
        self.trace_log = trace_log
        self.max_finished = max_finished
        self._next_id = 0  # span-id counter (see make_context)

    def export(self, span: "Span") -> None:
        rec = {
            "location": span.location,
            "trace_id": span.context.trace_id,
            "span_id": span.context.span_id,
            "parent_id": span.parent.span_id if span.parent else 0,
            "begin": span.begin,
            "end": span.end,
            "attributes": dict(span.attributes),
        }
        self.finished.append(rec)
        if len(self.finished) > self.max_finished:
            del self.finished[: len(self.finished) // 2]
        if self.trace_log is not None:
            from foundationdb_tpu_torch.utils.trace import (
                SEV_DEBUG,
                TraceEvent,
            )

            TraceEvent("Span", severity=SEV_DEBUG, logger=self.trace_log) \
                .detail("Location", rec["location"]) \
                .detail("TraceID", rec["trace_id"]) \
                .detail("SpanID", rec["span_id"]) \
                .detail("ParentID", rec["parent_id"]) \
                .detail("Begin", rec["begin"]) \
                .detail("End", rec["end"]).log()

    def traces(self, trace_id: int) -> list[dict]:
        return [s for s in self.finished if s["trace_id"] == trace_id]


#: process-wide exporter; swap with set_exporter()
_exporter = SpanExporter()


def set_exporter(e: SpanExporter) -> SpanExporter:
    """Install `e`; returns the previous exporter."""
    global _exporter
    old = _exporter
    _exporter = e
    return old


def get_exporter() -> SpanExporter:
    return _exporter


class Span:
    """One timed operation; finish() exports it. Usable as a context
    manager."""

    def __init__(self, location: str, *, parent: Optional[SpanContext] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.location = location
        self.parent = parent
        self.context = make_context(
            trace_id=parent.trace_id if parent else None
        )
        self._clock = clock or (lambda: 0.0)
        self.begin = self._clock()
        self.end: Optional[float] = None
        self.attributes: dict = {}
        self._finished = False
        # bound at creation: a span finished late (by an abandoned
        # coroutine) must not land in a later run's exporter
        self._exporter = _exporter

    def attribute(self, key: str, value) -> "Span":
        self.attributes[key] = value
        return self

    def finish(self) -> None:
        if not self._finished:
            self._finished = True
            self.end = self._clock()
            self._exporter.export(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()
