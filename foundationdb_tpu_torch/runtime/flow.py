"""A deterministic single-threaded actor runtime: the Flow/Net2 analog
(the port's own copy of what the Resolver role needs from
foundationdb_tpu.runtime.flow).

Every role is an actor (a cooperative coroutine) on a single-threaded
prioritized run loop (`flow/Net2.actor.cpp:1421`; `flow/flow.h`
Future/Promise), and the same code runs under a simulated clock:

* `Scheduler`: the run loop. With `sim=True` time is virtual: when no
  task is runnable the clock jumps to the next timer, so a run is
  deterministic. With `sim=False` timers wait on the wall clock.
* `Future`/`Promise`: single-assignment async values, awaitable from an
  actor coroutine.
* `Notified`: a monotone value with `when_at_least` (NotifiedVersion,
  the resolver's version chain, Resolver.actor.cpp:283).
* `Trigger`: an edge-triggered signal (AsyncTrigger).
* `all_of` / `any_of`: waitForAll and choose/when.

Task order is strict: (time, -priority, sequence). The JAX package's
interleaving auditor, schedule perturbation, run-loop profile and actor
cancellation are not copied: the Resolver role uses none of them.
"""

from __future__ import annotations

import heapq
import sys
import time as _time
import traceback
from typing import Any, Callable, Generator, Iterable, Optional


class TaskPriority:
    """The two priorities of the reference's lattice (TaskPriority.h) that
    the run loop defaults to."""

    DefaultDelay = 7010
    DefaultEndpoint = 7000


class Future:
    """Single-assignment future. Await it from an actor coroutine."""

    __slots__ = ("_done", "_value", "_error", "_callbacks",
                 "_error_observed", "_consumed", "_members")

    def __init__(self):
        self._done = False
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._callbacks: list[Callable[[Future], None]] = []
        #: something consumed the error (get() raised it, or a consumed
        #: combinator covered it): the scheduler's unhandled ledger
        #: filters on this
        self._error_observed = False
        #: the outcome reached someone (get() returned or raised)
        self._consumed = False
        #: set by all_of/any_of on the aggregate: member futures whose
        #: errors are delegated to it once it is consumed
        self._members: Optional[list["Future"]] = None

    # -- producer side ---------------------------------------------------

    def _set(self, value: Any) -> None:
        if self._done:
            raise RuntimeError("future already set")
        self._done = True
        self._value = value
        cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def _set_error(self, err: BaseException) -> None:
        if self._done:
            raise RuntimeError("future already set")
        self._done = True
        self._error = err
        if self._consumed:
            # consumed before the error arrived: that consumer covers it
            self._error_observed = True
        cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    # -- consumer side ---------------------------------------------------

    @property
    def is_ready(self) -> bool:
        return self._done

    @property
    def is_error(self) -> bool:
        return self._done and self._error is not None

    def _mark_consumed(self) -> None:
        """The outcome reached a consumer; a combinator's member errors
        count as observed here, and only here."""
        if self._consumed:
            return
        self._consumed = True
        if self._error is not None:
            self._error_observed = True
        if self._members:
            for m in self._members:
                if m.is_error:
                    m._error_observed = True

    def get(self) -> Any:
        if not self._done:
            raise RuntimeError("future not ready")
        self._mark_consumed()
        if self._error is not None:
            raise self._error
        return self._value

    def add_done_callback(self, cb: Callable[[Future], None]) -> None:
        if self._done:
            cb(self)
        else:
            self._callbacks.append(cb)

    def __await__(self) -> Generator["Future", None, Any]:
        if not self._done:
            yield self
        return self.get()


class Promise:
    """Producer handle for a Future (reference Promise<T>)."""

    __slots__ = ("future",)

    def __init__(self):
        self.future = Future()

    def send(self, value: Any = None) -> None:
        self.future._set(value)

    def send_error(self, err: BaseException) -> None:
        self.future._set_error(err)

    @property
    def is_set(self) -> bool:
        return self.future.is_ready


class Notified:
    """Monotone value with when_at_least: NotifiedVersion, the backbone
    of the version chains (Resolver.actor.cpp:283)."""

    def __init__(self, value=0):
        self._value = value
        self._waiters: list[tuple[Any, Future]] = []  # (threshold, future)

    def get(self):
        return self._value

    def set(self, value) -> None:
        if value < self._value:
            raise ValueError(f"Notified must not decrease: {value} < {self._value}")
        self._value = value
        still = []
        for threshold, fut in self._waiters:
            if fut.is_ready:
                continue
            if threshold <= value:
                fut._set(value)
            else:
                still.append((threshold, fut))
        self._waiters = still

    def when_at_least(self, threshold) -> Future:
        f = Future()
        if threshold <= self._value:
            f._set(self._value)
        else:
            self._waiters.append((threshold, f))
        return f

    def num_waiting(self) -> int:
        return sum(1 for _, f in self._waiters if not f.is_ready)


class Trigger:
    """An edge-triggered signal (AsyncTrigger): on_trigger wakes all waiters."""

    def __init__(self):
        self._waiters: list[Future] = []

    def on_trigger(self) -> Future:
        f = Future()
        self._waiters.append(f)
        return f

    def trigger(self) -> None:
        ws, self._waiters = self._waiters, []
        for f in ws:
            if not f.is_ready:
                f._set(None)


class Task:
    """A spawned actor: drives a coroutine over Futures."""

    __slots__ = ("_coro", "_sched", "_priority", "done", "_name",
                 "_waiting")

    def __init__(self, coro, sched: "Scheduler", priority: int, name: str = ""):
        self._coro = coro
        self._sched = sched
        self._priority = priority
        self._name = name or getattr(coro, "__name__", "actor")
        #: the future this actor is suspended on
        self._waiting: Optional[Future] = None
        self.done = Future()

    def _step(self, fut: Optional[Future]) -> None:
        if self.done.is_ready:
            return
        self._waiting = None  # resumed: no longer suspended on `fut`
        try:
            if fut is not None and fut.is_error:
                fut._mark_consumed()  # delivered into the actor
                waited = self._coro.throw(fut._error)
            else:
                # Future.__await__ returns the value itself; send resumes
                waited = self._coro.send(None)
        except StopIteration as stop:
            self.done._set(stop.value)
            return
        except BaseException as e:
            if not self.done._callbacks:
                # a fire-and-forget actor crashed with nobody awaiting
                print(f"[flow] unhandled error in actor {self._name!r}:",
                      file=sys.stderr)
                traceback.print_exception(e, file=sys.stderr)
            # entries whose done future is consumed later drop out of
            # Scheduler.unhandled_errors()
            self._sched._maybe_unhandled.append((self._name, e, self.done))
            self.done._set_error(e)
            return
        if not isinstance(waited, Future):
            raise TypeError(f"actor awaited non-Future {waited!r}")
        self._waiting = waited
        waited.add_done_callback(
            lambda f: self._sched._schedule(0.0, self._priority, lambda: self._step(f))
        )

    def __await__(self):
        return self.done.__await__()


class Scheduler:
    """The single-threaded prioritized run loop (Net2::run / Sim2).

    sim=True: a virtual clock; the loop never sleeps, it advances `now`
    to the next timer when idle (fdbrpc/sim2.actor.cpp:977).
    sim=False: timers wait on the wall clock (time.monotonic).
    """

    def __init__(self, *, sim: bool = True, start_time: float = 0.0):
        self.sim = sim
        self._now = start_time if sim else _time.monotonic()
        self._seq = 0
        #: (actor name, error, done future) for every actor crash
        self._maybe_unhandled: list[tuple[str, BaseException, Future]] = []
        # (due, -priority, seq, fn)
        self._heap: list[tuple[float, int, int, Callable[[], None]]] = []

    def unhandled_errors(self) -> list[tuple[str, BaseException]]:
        """Actor crashes whose error nothing ever consumed."""
        return [
            (name, err)
            for name, err, fut in self._maybe_unhandled
            if not fut._error_observed
        ]

    def clear_unhandled(self) -> None:
        self._maybe_unhandled.clear()

    def now(self) -> float:
        return self._now

    def _schedule(self, delay: float, priority: int, fn: Callable[[], None]) -> None:
        self._seq += 1
        due = self._now + max(0.0, delay)
        heapq.heappush(self._heap, (due, -priority, self._seq, fn))

    def delay(self, seconds: float, priority: int = TaskPriority.DefaultDelay) -> Future:
        f = Future()
        self._schedule(seconds, priority, lambda: None if f.is_ready else f._set(None))
        return f

    def spawn(self, coro, priority: int = TaskPriority.DefaultEndpoint,
              name: str = "") -> Task:
        task = Task(coro, self, priority, name)
        self._schedule(0.0, priority, lambda: task._step(None))
        return task

    def run_until(self, fut: Future, *, max_time: float = float("inf")) -> Any:
        """Drive the loop until `fut` resolves (or the virtual clock
        passes max_time / the run queue drains)."""
        while not fut.is_ready:
            if not self._heap:
                raise RuntimeError("deadlock: run queue drained, future unresolved")
            due, negpri, seq, fn = heapq.heappop(self._heap)
            if due > self._now:
                if due > max_time:
                    # put the event back: a later run must still see it
                    heapq.heappush(self._heap, (due, negpri, seq, fn))
                    raise TimeoutError(
                        f"virtual clock passed {max_time} awaiting future"
                    )
                if self.sim:
                    self._now = due
                else:
                    _time.sleep(max(0.0, due - _time.monotonic()))
                    self._now = _time.monotonic()
            fn()
        return fut.get()

    def run_for(self, seconds: float) -> None:
        """Run the loop for a span of (virtual) time."""
        self.run_until(self.delay(seconds))


def all_of(futures: Iterable[Future]) -> Future:
    """waitForAll: resolves with the list of values (first error wins).
    Consuming the aggregate observes every member's error."""
    futures = list(futures)
    out = Future()
    out._members = futures
    remaining = [len(futures)]
    if not futures:
        out._set([])
        return out

    def on_done(f: Future) -> None:
        if f.is_error and out._consumed:
            f._error_observed = True  # late arrival, aggregate consumed
        if out.is_ready:
            return
        if f.is_error:
            out._set_error(f._error)
            return
        remaining[0] -= 1
        if remaining[0] == 0:
            out._set([x.get() for x in futures])

    for f in futures:
        f.add_done_callback(on_done)
    return out


def any_of(futures: Iterable[Future]) -> Future:
    """choose/when: resolves with (index, value) of the first ready
    future; consuming the aggregate handles the losers' errors."""
    futures = list(futures)
    out = Future()
    out._members = futures

    def make_cb(i: int):
        def cb(f: Future) -> None:
            if f.is_error and out._consumed:
                f._error_observed = True  # loser after a consumed race
            if out.is_ready:
                return
            if f.is_error:
                out._set_error(f._error)
            else:
                out._set((i, f.get()))

        return cb

    for i, f in enumerate(futures):
        f.add_done_callback(make_cb(i))
    return out
