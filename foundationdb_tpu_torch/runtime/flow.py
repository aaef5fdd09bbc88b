"""A deterministic single-threaded actor runtime: the Flow/Net2 analog
(the port's own copy of foundationdb_tpu.runtime.flow, whole: the
Resolver role, the wire roles and the simulated cluster run on it, and
its schedule, the perturbed tie-break included, is the JAX module's bit
for bit).

The reference's entire architecture rests on one idea: every role is an
actor (a cooperative coroutine) on a single-threaded prioritized run loop
(`flow/Net2.actor.cpp:1421` run loop; `flow/flow.h` Future/Promise), and
the same code runs under a simulated clock for deterministic testing
(`fdbrpc/sim2.actor.cpp`). This module provides the same contract in
Python:

* `Scheduler` — the run loop. In `sim` mode time is virtual: when no task
  is runnable the clock jumps to the next timer, so a whole cluster of
  actors runs deterministically in one OS process, reproducible from a
  seed (the Sim2 strategy). In real mode timers use the wall clock.
* `Future`/`Promise` — single-assignment async values (`flow/flow.h`
  SAV). Awaitable from any actor coroutine.
* `PromiseStream`/`FutureStream` — multi-value channels (RPC endpoints).
* `Notified` — a monotonically increasing value with `when_at_least`,
  mirroring NotifiedVersion, the primitive behind the resolver/proxy
  version chains (`fdbserver/Resolver.actor.cpp:283`).
* Task ordering is strict: (time, -priority, sequence). Two runs with the
  same seed and the same spawn order execute identically — determinism
  IS the race detector here, as in the reference (SURVEY.md §5.2).

Actors are plain `async def` functions awaiting these primitives; the
scheduler drives the coroutines directly (no asyncio), so the event order
is fully owned by this module.
"""

from __future__ import annotations

import heapq
import time as _time
from typing import Any, Awaitable, Callable, Generator, Iterable, Optional

from foundationdb_tpu_torch.utils.probes import code_probe, declare

declare("runtime.slow_task")


class ActorCancelled(BaseException):
    """Raised inside an actor when its task is cancelled (actor_cancelled)."""


class TaskPriority:
    """A small slice of the reference's priority lattice (TaskPriority.h)."""

    Max = 1000000
    RunLoop = 30000
    DefaultDelay = 7010
    DefaultEndpoint = 7000
    ProxyCommit = 8540
    ProxyResolverReply = 8547
    ResolutionMetrics = 8700
    Low = 2000
    Zero = 0


class Future:
    """Single-assignment future. Await it from an actor coroutine."""

    __slots__ = ("_done", "_value", "_error", "_callbacks",
                 "_error_observed", "_consumed", "_members")

    def __init__(self):
        self._done = False
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._callbacks: list[Callable[[Future], None]] = []
        #: set once SOMETHING consumed the error (get() raised it, or the
        #: consumed aggregate of a combinator covered it) — the
        #: scheduler's unhandled-error ledger filters on this, so a
        #: fire-and-forget crash awaited later does not count as escaped
        #: (the round-5 soak printed 264 tracebacks for exactly that
        #: shape and still passed green)
        self._error_observed = False
        #: the outcome of this future was delivered to someone (get()
        #: returned or raised) — combinator member observation keys off
        #: THIS, so a dropped `any_of(...)` aggregate does not silently
        #: consume its members' errors
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
            # consumed BEFORE the error arrived (abandoned by a
            # cancelled awaiter): the error is covered by that consumer
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
        """This future's outcome reached a consumer. Member errors
        (combinators) become observed HERE — racing/fanning futures and
        consuming the aggregate is handling the losers too (two tlog
        replicas raising on one epoch lock: first error wins the await,
        the sibling's is delegated) — but only here: an aggregate nobody
        ever consumes keeps its members' errors escaped."""
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

    __slots__ = ("future", "tag", "debug_id", "span_ctx", "grv_start")

    def __init__(self):
        self.future = Future()
        self.tag = None  # optional transaction tag (GRV throttling)
        self.debug_id = None  # commit-path tracing (GRV micro-events)
        self.span_ctx = None  # client span context (GRV batch span parent)
        self.grv_start = 0.0  # enqueue time for the GRV latency bands

    def send(self, value: Any = None) -> None:
        self.future._set(value)

    def send_error(self, err: BaseException) -> None:
        self.future._set_error(err)

    @property
    def is_set(self) -> bool:
        return self.future.is_ready


class FutureStream:
    """Consumer end of a PromiseStream."""

    __slots__ = ("_queue", "_waiters")

    def __init__(self):
        self._queue: list[Any] = []
        self._waiters: list[Future] = []

    def next(self) -> Future:
        f = Future()
        if self._queue:
            f._set(self._queue.pop(0))
        else:
            self._waiters.append(f)
        return f

    def try_next(self):
        """(True, value) if an item is queued, else (False, None) — no
        future, no suspension. Drain loops use this so a value can never
        sit inside a waiter future orphaned by task cancellation (the
        send()-delivers-into-waiter model means a consumer cancelled
        between delivery and resumption silently loses the item)."""
        if self._queue:
            return True, self._queue.pop(0)
        return False, None

    def is_empty(self) -> bool:
        return not self._queue


class PromiseStream:
    """Multi-value channel; the shape of an RPC request stream."""

    __slots__ = ("stream",)

    def __init__(self):
        self.stream = FutureStream()

    def send(self, value: Any) -> None:
        s = self.stream
        while s._waiters:
            w = s._waiters.pop(0)
            if not w.is_ready:  # waiter may have been cancelled via choose
                w._set(value)
                return
        s._queue.append(value)


class Notified:
    """Monotone value with when_at_least — NotifiedVersion.

    The backbone of the version chains: the resolver waits
    `version.when_at_least(req.prev_version)` before computing
    (fdbserver/Resolver.actor.cpp:283), the proxy chains batches the same
    way (CommitProxyServer.actor.cpp:822-853).
    """

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


class InterleavingAuditor:
    """Runtime side of the `flow.*` rules: lost-update detection on
    shared objects across actor yield points.

    The static pass (analysis/rules_flow.py) proves shapes; this
    auditor catches the *executions*: an actor reads a tracked
    (object, key) slot in one step, a DIFFERENT actor writes that slot
    in a later step, and the first actor then writes it based on the
    stale read — the Eraser-lesson RMW interleaving, adapted to a
    cooperative single-threaded scheduler where the only possible race
    is across a wait(). Ordering discipline is re-reading: an actor
    that re-reads the slot after the foreign write (the handoff idiom)
    updates its pending read and is clean; an actor that writes from a
    pre-wait value is flagged whether or not a future "ordered" its
    resumption, because the value it wrote is stale either way.

    Pure observation: tracking changes no behavior and no schedule, so
    audited runs stay seed-deterministic. Objects opt in via
    `AuditedDict` (or direct record_read/record_write calls); code that
    never wraps anything pays nothing.
    """

    MAX_CONFLICTS = 64

    def __init__(self):
        self.step = 0              # global actor-step counter
        self.current: Optional[str] = None  # actor name mid-step
        #: (label, key) -> actor name -> step of last unconsumed read
        self._reads: dict[tuple, dict[str, int]] = {}
        #: (label, key) -> (actor name, step) of the last write
        self._last_write: dict[tuple, tuple[str, int]] = {}
        self.conflicts: list[dict] = []

    # -- step boundaries (driven by Task._step) ---------------------------

    def begin_step(self, name: str) -> None:
        self.step += 1
        self.current = name

    def end_step(self) -> None:
        self.current = None

    # -- access recording --------------------------------------------------

    def record_read(self, label: str, key) -> None:
        if self.current is None:
            return  # setup/verify code outside any actor step
        self._reads.setdefault((label, key), {})[self.current] = self.step

    def record_write(self, label: str, key) -> None:
        me = self.current
        if me is None:
            return
        # `key` and the whole-object wildcard "*" address the same
        # slot; a wildcard WRITE (clear) addresses every slot of the
        # label, so it probes all recorded keys — a stale scan followed
        # by clear() loses foreign per-key writes just as surely as a
        # per-key overwrite would
        if key == "*":
            # sorted: the first conflicting key wins the report, and
            # "first" must not depend on PYTHONHASHSEED (each run's
            # failure output is part of its reproducibility contract)
            probe = tuple(sorted(
                (k for (lb, k) in set(self._reads) | set(self._last_write)
                 if lb == label),
                key=repr,  # keys may mix str/bytes/ints with the "*"
                #            sentinel: repr orders across types, so the
                #            winning conflict stays hash-seed-independent
            )) or ("*",)
        else:
            probe = (key, "*")
        my_read = None
        for k2 in probe:
            r = self._reads.get((label, k2), {}).get(me)
            if r is not None and (my_read is None or r > my_read):
                my_read = r
        if my_read is not None:
            for k2 in probe:
                lw = self._last_write.get((label, k2))
                if lw is None:
                    continue
                w_actor, w_step = lw
                if w_actor != me and my_read < w_step:
                    if len(self.conflicts) < self.MAX_CONFLICTS:
                        self.conflicts.append({
                            "label": label, "key": key,
                            "actor": me, "read_step": my_read,
                            "writer": w_actor, "write_step": w_step,
                            "step": self.step,
                        })
                    break
        # this write consumes our pending read — BOTH probe slots: a
        # wildcard scan that fed this write is consumed by it too, or a
        # single stale scan would re-flag against every later write —
        # and becomes the slot's latest write
        for k2 in probe:
            self._reads.get((label, k2), {}).pop(me, None)
        self._last_write[(label, key)] = (me, self.step)


class AuditedDict:
    """A dict proxy reporting per-key access to the scheduler's
    interleaving auditor. With no auditor installed the overhead is one
    attribute check per operation — cheap enough to leave in soak
    workloads permanently. Aggregate operations (iteration, len, bool,
    items) read — and clear() writes — the wildcard slot "*", which
    conflicts with every per-key access."""

    __slots__ = ("_d", "_sched", "_label")

    def __init__(self, sched: "Scheduler", label: str, initial=None):
        self._d = dict(initial or {})
        self._sched = sched
        self._label = label

    def _read(self, key) -> None:
        a = self._sched.auditor
        if a is not None:
            a.record_read(self._label, key)

    def _write(self, key) -> None:
        a = self._sched.auditor
        if a is not None:
            a.record_write(self._label, key)

    def __getitem__(self, key):
        self._read(key)
        return self._d[key]

    def __setitem__(self, key, value) -> None:
        self._write(key)
        self._d[key] = value

    def __delitem__(self, key) -> None:
        self._read(key)  # presence check is an observation
        if key in self._d:
            self._write(key)  # only a real removal is a write
        del self._d[key]

    def __contains__(self, key) -> bool:
        self._read(key)
        return key in self._d

    def get(self, key, default=None):
        self._read(key)
        return self._d.get(key, default)

    def setdefault(self, key, default=None):
        self._read(key)
        if key not in self._d:
            self._write(key)
        return self._d.setdefault(key, default)

    def pop(self, key, *default):
        self._read(key)  # presence check is an observation
        if key in self._d:
            # only a real removal is a write: pop(absent, default)
            # mutates nothing, and a phantom last_write here would
            # frame this actor as the writer in a later conflict
            self._write(key)
        return self._d.pop(key, *default)

    def update(self, other=(), **kw) -> None:
        items = dict(other, **kw)
        for k in items:
            self._write(k)
        self._d.update(items)

    def clear(self) -> None:
        self._write("*")
        self._d.clear()

    def keys(self):
        self._read("*")
        return self._d.keys()

    def values(self):
        self._read("*")
        return self._d.values()

    def items(self):
        self._read("*")
        return self._d.items()

    def __iter__(self):
        self._read("*")
        return iter(self._d)

    def __len__(self) -> int:
        self._read("*")
        return len(self._d)

    def __bool__(self) -> bool:
        self._read("*")
        return bool(self._d)

    def __eq__(self, other):
        self._read("*")
        return self._d == (other._d if isinstance(other, AuditedDict)
                           else other)

    def __repr__(self) -> str:
        return f"AuditedDict({self._label!r}, {self._d!r})"


class Task:
    """A spawned actor: drives a coroutine over Futures."""

    __slots__ = ("_coro", "_sched", "_priority", "done", "_cancelled",
                 "_name", "_waiting", "_retired")

    def __init__(self, coro, sched: "Scheduler", priority: int, name: str = ""):
        self._coro = coro
        self._sched = sched
        self._priority = priority
        self._cancelled = False
        self._name = name or getattr(coro, "__name__", "actor")
        #: the future this actor is currently suspended on — cancelling
        #: the actor ABANDONS it (the reference's drop-the-future
        #: semantics), which counts as consumption for the unhandled
        #: ledger: a tlog replica erroring after recovery cancelled the
        #: batch actor awaiting it is not an "escaped" error
        self._waiting: Optional[Future] = None
        self.done = Future()
        #: live-task census: retired exactly once, at the terminal
        #: done._set/_set_error — NOT via add_done_callback, which would
        #: defeat the `not done._callbacks` fire-and-forget crash print
        self._retired = False
        sched._tasks_live += 1

    def _retire(self) -> None:
        if not self._retired:
            self._retired = True
            self._sched._tasks_live -= 1

    def cancel(self) -> None:
        """Cancel the actor (reference: dropping the last Future reference)."""
        if self.done.is_ready or self._cancelled:
            return
        self._cancelled = True
        self._sched._schedule(0.0, self._priority, self._step_throw)

    def _step_throw(self) -> None:
        if self.done.is_ready:
            return
        if self._waiting is not None:
            # cancellation abandons the pending await: its (possibly
            # later) error is consumed by the cancel, not escaped
            self._waiting._mark_consumed()
            self._waiting = None
        auditor = self._sched.auditor
        if auditor is not None:
            # the cancel throw still runs actor code (finally blocks
            # may touch audited shared state): it is a step too
            auditor.begin_step(self._name)
        try:
            self._step_throw_inner()
        finally:
            if auditor is not None:
                auditor.end_step()

    def _step_throw_inner(self) -> None:
        try:
            self._coro.throw(ActorCancelled())
        except (StopIteration, ActorCancelled):
            self.done._set_error(ActorCancelled())
            self._retire()
            return
        except BaseException as e:  # actor swallowed the cancel and raised
            self.done._set_error(e)
            self._retire()
            return
        # Actor caught the cancellation and kept awaiting: treat as done.
        self.done._set_error(ActorCancelled())
        self._retire()

    def _step(self, fut: Optional[Future]) -> None:
        if self.done.is_ready or self._cancelled:
            return
        # slow-task profiling measures WALL time on purpose: it reports
        # a step blocking the real run loop, not virtual time
        t0 = _time.perf_counter()  # flowcheck: ignore[determinism]
        auditor = self._sched.auditor
        if auditor is not None:
            auditor.begin_step(self._name)
        try:
            self._step_inner(fut)
        finally:
            if auditor is not None:
                auditor.end_step()
            sched = self._sched
            elapsed = _time.perf_counter() - t0  # flowcheck: ignore[determinism]
            # run-loop utilization accounting (Net2's networkMetrics
            # priority-busy counters): every step's wall time lands in
            # the busy total — one add on a float already in hand
            sched._busy_wall += elapsed
            sched._steps += 1
            # fast path: two clock reads + one compare per step; the
            # full per-actor profile is opt-in (Scheduler(profile=True))
            if sched._profile or elapsed > sched.SLOW_TASK_THRESHOLD:
                sched._note_step(self._name, elapsed)

    def _step_inner(self, fut: Optional[Future]) -> None:
        self._waiting = None  # resumed: no longer suspended on `fut`
        try:
            if fut is not None and fut.is_error:
                fut._mark_consumed()  # delivered into the actor
                waited = self._coro.throw(fut._error)
            else:
                # The awaited value is delivered by Future.__await__'s own
                # `return self.get()`; send just resumes the coroutine.
                waited = self._coro.send(None)
        except StopIteration as stop:
            self.done._set(stop.value)
            self._retire()
            return
        except ActorCancelled:
            self.done._set_error(ActorCancelled())
            self._retire()
            return
        except BaseException as e:
            if not self.done._callbacks:
                # Fire-and-forget actor crashed with nobody awaiting: surface
                # it (a silent death here stalls whatever chains on the
                # actor's side effects — the hardest deadlock to debug).
                import sys
                import traceback

                print(
                    f"[flow] unhandled error in actor {self._name!r}:",
                    file=sys.stderr,
                )
                traceback.print_exception(e, file=sys.stderr)
            # ledger every non-cancel crash; entries whose done future is
            # later consumed (awaited / get()) drop out of
            # Scheduler.unhandled_errors() — what remains truly escaped.
            # Amortized bound: once the ledger is large, shed entries
            # already observed (routine handled chaos must not pin every
            # exception+traceback for the scheduler's lifetime)
            ledger = self._sched._maybe_unhandled
            if len(ledger) >= 256:
                ledger[:] = [
                    ent for ent in ledger if not ent[2]._error_observed
                ]
                if len(ledger) >= 1024:
                    # hard cap for long-lived real-mode schedulers where
                    # nobody drains the ledger: shed the oldest escapes
                    # (each pins an exception + traceback frames) — any
                    # remaining entry still fails a soak seed
                    del ledger[:512]
            ledger.append((self._name, e, self.done))
            self.done._set_error(e)
            self._retire()
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

    sim=True — virtual clock: the loop never sleeps, it advances `now` to
    the next timer when idle. This is what makes whole-cluster tests
    deterministic and fast (the Sim2 design, fdbrpc/sim2.actor.cpp:977).
    sim=False — timers wait on the wall clock (time.monotonic).
    """

    #: one actor step blocking the loop longer than this (WALL seconds)
    #: is a slow task: the single-threaded run loop serves nothing else
    #: meanwhile (flow/Net2.actor.cpp:1462 checkForSlowTask)
    SLOW_TASK_THRESHOLD = 0.05

    def __init__(self, *, sim: bool = True, start_time: float = 0.0,
                 profile: bool = False, audit: bool = False,
                 perturb_seed: Optional[int] = None):
        self.sim = sim
        self._profile = profile
        # real mode anchors the clock to the wall on purpose
        self._now = start_time if sim else _time.monotonic()  # flowcheck: ignore[determinism]
        self._seq = 0
        #: opt-in interleaving auditor (lost updates across yield
        #: points on AuditedDict-tracked shared objects)
        self.auditor: Optional[InterleavingAuditor] = (
            InterleavingAuditor() if audit else None
        )
        #: schedule perturbation: a seeded tie-break among EQUALLY
        #: RUNNABLE entries — same due time, same priority. Any such
        #: order is a legal schedule; a correctness property that only
        #: holds under FIFO tie order is a race. None = FIFO (the
        #: historical order, byte-identical to pre-perturbation runs).
        self._perturb_state: Optional[int] = (
            None if perturb_seed is None
            else (perturb_seed ^ 0x9E3779B97F4A7C15) & ((1 << 64) - 1)
        )
        #: (actor name, error, done future) for every non-cancel actor
        #: crash; see unhandled_errors()
        self._maybe_unhandled: list[tuple[str, BaseException, Future]] = []
        # (due, -priority, tie, seq, fn): `tie` is 0 under FIFO order
        # and a seeded draw under perturbation; `seq` keeps comparisons
        # off `fn` either way
        self._heap: list[tuple[float, int, int, int, Callable[[], None]]] = []
        self._running = False
        #: per-actor-name step profile: [steps, total_wall_s, max_wall_s]
        #: — the ActorLineageProfiler collapsed to what a single-threaded
        #: deterministic loop can measure honestly. With profile=True
        #: EVERY step is recorded (no sampling thread required); by
        #: default only steps over SLOW_TASK_THRESHOLD land here, so
        #: step counts/totals for fast actors are intentionally absent
        self.actor_profile: dict[str, list] = {}
        self.slow_tasks: list[tuple[str, float]] = []
        # run-loop utilization (the Net2 networkMetrics busy fraction):
        # WALL seconds spent inside actor steps vs wall seconds since
        # construction. Wall-clock on purpose — it measures how busy
        # this OS process's loop is, which virtual time cannot; status
        # readers surface it, traced simulation output never does (the
        # trace-digest determinism contract).
        self._busy_wall = 0.0
        self._steps = 0
        self._slow_task_total = 0
        #: live-task census (incremented at Task construction, retired
        #: at its terminal done-set): the scheduler half of the
        #: resource census gate — a drained run returns this to its
        #: pre-run baseline or the census gate fails the seed
        self._tasks_live = 0
        self._wall_anchor = _time.perf_counter()  # flowcheck: ignore[determinism]

    def run_loop_stats(self) -> dict:
        """Saturation view of the run loop: busy fraction, step count,
        slow-task ledger summary. The "~40% idle parent loop" class of
        diagnosis (PIPELINE_r07) reads directly off `utilization`
        instead of being reconstructed from traces after the fact."""
        wall = _time.perf_counter() - self._wall_anchor  # flowcheck: ignore[determinism]
        slow_by_actor: dict[str, int] = {}
        for name, _s in self.slow_tasks:
            slow_by_actor[name] = slow_by_actor.get(name, 0) + 1
        return {
            "utilization": (self._busy_wall / wall) if wall > 0 else 0.0,
            "busy_seconds": self._busy_wall,
            "wall_seconds": wall,
            "steps": self._steps,
            "tasks_live": self._tasks_live,
            "slow_tasks": self._slow_task_total,
            "slow_tasks_by_actor": dict(
                sorted(slow_by_actor.items(), key=lambda kv: -kv[1])[:10]
            ),
        }

    def _note_step(self, name: str, elapsed: float) -> None:
        st = self.actor_profile.get(name)
        if st is None:
            st = self.actor_profile[name] = [0, 0.0, 0.0]
        st[0] += 1
        st[1] += elapsed
        if elapsed > st[2]:
            st[2] = elapsed
        if elapsed > self.SLOW_TASK_THRESHOLD:
            self._slow_task_total += 1
            if len(self.slow_tasks) >= 256:  # bounded, like trace rolls
                del self.slow_tasks[:128]
            code_probe(True, "runtime.slow_task")
            self.slow_tasks.append((name, elapsed))
            from foundationdb_tpu_torch.utils.trace import SEV_WARN, TraceEvent

            TraceEvent("SlowTask", severity=SEV_WARN).detail(
                "Actor", name
            ).detail("Ms", round(elapsed * 1e3, 1)).log()

    def profile_top(self, n: int = 10) -> list[tuple[str, int, float, float]]:
        """Top actors by cumulative wall time in their steps: (name,
        steps, total_s, max_step_s) — the profiler surface the reference
        gets from ActorLineageProfiler sampling."""
        rows = [
            (name, st[0], st[1], st[2])
            for name, st in self.actor_profile.items()
        ]
        rows.sort(key=lambda r: -r[2])
        return rows[:n]

    # -- unhandled actor errors -------------------------------------------

    def unhandled_errors(self) -> list[tuple[str, BaseException]]:
        """Actor crashes nothing ever consumed: the error reached the
        Task's done future and NO ONE awaited/get() it (directly or via
        a combinator). The reference makes this class structurally loud
        (an ACTOR error lands in its Future; the simulator crashes on
        unhandled ones) — soak fails a seed on any entry here."""
        return [
            (name, err)
            for name, err, fut in self._maybe_unhandled
            if not fut._error_observed
        ]

    def clear_unhandled(self) -> None:
        self._maybe_unhandled.clear()

    # -- interleaving audit ------------------------------------------------

    def audit_conflicts(self) -> list[dict]:
        """Lost-update conflicts the interleaving auditor observed on
        tracked shared objects (empty when auditing is off). Soak fails
        a seed on any entry, like the unhandled-error ledger."""
        return [] if self.auditor is None else list(self.auditor.conflicts)

    # -- time -------------------------------------------------------------

    def now(self) -> float:
        return self._now

    def _tie(self) -> int:
        """Next tie-break value: 0 (FIFO via seq) unless perturbing, in
        which case a splitmix64 draw — deterministic per perturb_seed,
        so a perturbed schedule is itself exactly reproducible."""
        if self._perturb_state is None:
            return 0
        m = (1 << 64) - 1
        self._perturb_state = (
            self._perturb_state + 0x9E3779B97F4A7C15
        ) & m
        z = self._perturb_state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
        return z ^ (z >> 31)

    def _schedule(self, delay: float, priority: int, fn: Callable[[], None]) -> None:
        self._seq += 1
        due = self._now + max(0.0, delay)
        heapq.heappush(
            self._heap, (due, -priority, self._tie(), self._seq, fn)
        )

    def delay(self, seconds: float, priority: int = TaskPriority.DefaultDelay) -> Future:
        f = Future()
        self._schedule(seconds, priority, lambda: None if f.is_ready else f._set(None))
        return f

    # -- actors -----------------------------------------------------------

    def spawn(self, coro, priority: int = TaskPriority.DefaultEndpoint,
              name: str = "") -> Task:
        task = Task(coro, self, priority, name)
        self._schedule(0.0, priority, lambda: task._step(None))
        return task

    # -- run loop ---------------------------------------------------------

    def run_until(self, fut: Future, *, max_time: float = float("inf")) -> Any:
        """Drive the loop until `fut` resolves (or the virtual clock passes
        max_time / the task queue drains)."""
        self._running = True
        try:
            while not fut.is_ready:
                if not self._heap:
                    raise RuntimeError("deadlock: run queue drained, future unresolved")
                due, negpri, tie, seq, fn = heapq.heappop(self._heap)
                if due > self._now:
                    if due > max_time:
                        # Put the event back: a later run must still see it.
                        heapq.heappush(self._heap, (due, negpri, tie, seq, fn))
                        raise TimeoutError(
                            f"virtual clock passed {max_time} awaiting future"
                        )
                    if self.sim:
                        self._now = due
                    else:
                        # real mode: timers genuinely wait on the wall
                        _time.sleep(max(0.0, due - _time.monotonic()))  # flowcheck: ignore[determinism]
                        self._now = _time.monotonic()  # flowcheck: ignore[determinism]
                fn()
            return fut.get()
        finally:
            self._running = False

    def run_for(self, seconds: float) -> None:
        """Run the loop for a span of (virtual) time."""
        self.run_until(self.delay(seconds))


# -- combinators ----------------------------------------------------------


def all_of(futures: Iterable[Future]) -> Future:
    """waitForAll: resolves with the list of values (first error wins).

    Member-error observation is delegated to the aggregate: once `out`
    is consumed, every member error (including a sibling failing AFTER
    the first error won — two tlog replicas raising on one epoch lock)
    counts as handled. An aggregate nobody consumes delegates nothing:
    its members' errors stay on the unhandled ledger."""
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
    future. Same delegation contract as all_of: consuming the aggregate
    handles the losers' errors (racing IS the error policy); a dropped
    aggregate handles nothing."""
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
