"""The port's actor runtime (runtime/flow.py) and census, held against the
JAX package's.

Each scripted actor program runs once through `foundationdb_tpu.runtime.
flow` and once through `foundationdb_tpu_torch.runtime.flow` and must leave
the same observable log: a cancel at an await, ActorCancelled reaching the
children a parent cancels, cancelling a finished task, PromiseStream /
FutureStream order and try_next, the seeded tie-break (perturb_seed 0-7,
its raw draws too), the unhandled-error ledger, the live-task count, the
interleaving auditor on a lost-update program, the run-loop profile and
the slow-task record. The census's `snapshot(sched)` reports the
scheduler's live tasks as the JAX census does. The tolerance is equality.
"""

from __future__ import annotations

import time

import pytest

from foundationdb_tpu.runtime import census as JC
from foundationdb_tpu.runtime import flow as JF
from foundationdb_tpu.utils import trace as JT
from foundationdb_tpu_torch.runtime import census as PC
from foundationdb_tpu_torch.runtime import flow as PF
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import trace as PT

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

BOTH = [(JF, JT), (PF, PT)]


def both(program, *args):
    """The program's log through each runtime; asserts they are equal."""
    logs = [program(F, *args) for F, _T in BOTH]
    assert logs[1] == logs[0]
    return logs[0]


def _err(fut):
    return None if not fut.is_error else type(fut._error).__name__


# ---------------------------------------------------------------------------
# Cancellation


def cancel_at_await(F):
    sched = F.Scheduler(sim=True)
    log = []

    async def actor():
        log.append(("start", sched.now()))
        try:
            await sched.delay(1.0)
            log.append("not reached")
        except F.ActorCancelled:
            log.append(("cancelled", sched.now()))
            raise
        finally:
            log.append(("finally", sched.now()))

    t = sched.spawn(actor(), name="victim")

    async def killer():
        await sched.delay(0.25)
        t.cancel()
        log.append(("cancel sent", sched.now()))

    sched.spawn(killer(), name="killer")
    sched.run_for(2.0)
    log.append(("done", t.done.is_ready, _err(t.done)))
    log.append(("tasks_live", sched.run_loop_stats()["tasks_live"]))
    log.append(("unhandled", sched.unhandled_errors()))
    return log


def test_cancel_at_an_await():
    log = both(cancel_at_await)
    assert log[1:4] == [("cancel sent", 0.25), ("cancelled", 0.25),
                        ("finally", 0.25)]
    assert log[4] == ("done", True, "ActorCancelled")
    assert log[5:] == [("tasks_live", 0), ("unhandled", [])]


def cancel_reaches_children(F):
    sched = F.Scheduler(sim=True)
    log = []

    async def child(i):
        try:
            await sched.delay(5.0 + i)
            log.append(("child done", i))
        except F.ActorCancelled:
            log.append(("child cancelled", i, sched.now()))
            raise

    async def parent():
        kids = [sched.spawn(child(i), name=f"child{i}") for i in range(3)]
        try:
            await F.all_of([k.done for k in kids])
        except F.ActorCancelled:
            log.append(("parent cancelled", sched.now()))
            raise
        finally:
            for k in kids:
                k.cancel()

    p = sched.spawn(parent(), name="parent")
    sched.run_for(0.5)
    log.append(("live before", sched.run_loop_stats()["tasks_live"]))
    p.cancel()
    sched.run_for(0.5)
    log.append(("live after", sched.run_loop_stats()["tasks_live"]))
    log.append(("parent", _err(p.done)))
    log.append(("unhandled", sched.unhandled_errors()))
    return log


def test_actor_cancelled_reaches_children():
    log = both(cancel_reaches_children)
    assert log[:2] == [("live before", 4), ("parent cancelled", 0.5)]
    assert [e[0] for e in log[2:5]] == ["child cancelled"] * 3
    assert log[5:] == [("live after", 0), ("parent", "ActorCancelled"),
                       ("unhandled", [])]


def cancel_finished(F):
    sched = F.Scheduler(sim=True)

    async def quick():
        await sched.delay(0.01)
        return 7

    async def crash():
        await sched.delay(0.01)
        raise KeyError("boom")

    t, c = sched.spawn(quick(), name="quick"), sched.spawn(crash(), name="crash")
    sched.run_for(0.1)
    t.cancel()
    c.cancel()
    t.cancel()
    sched.run_for(0.1)
    out = [t.done.get(), _err(c.done), sched.run_loop_stats()["tasks_live"],
           [(n, type(e).__name__) for n, e in sched.unhandled_errors()]]

    async def consume():
        try:
            await c
        except KeyError:
            return "consumed"

    out.append(sched.run_until(sched.spawn(consume()).done))
    out.append(sched.unhandled_errors())
    return out


def test_cancelling_a_finished_task_changes_nothing():
    assert both(cancel_finished) == [
        7, "KeyError", 0, [("crash", "KeyError")], "consumed", []]


# ---------------------------------------------------------------------------
# Streams


def stream_order(F):
    sched = F.Scheduler(sim=True)
    ps = F.PromiseStream()
    log = []
    ps.send("a")
    ps.send("b")
    log.append(("try", ps.stream.try_next()))
    log.append(("empty", ps.stream.is_empty()))

    async def consumer(name, n):
        for _ in range(n):
            v = await ps.stream.next()
            log.append((name, v, sched.now()))

    sched.spawn(consumer("c1", 3), name="c1")
    sched.spawn(consumer("c2", 2), name="c2")

    async def producer():
        for i in range(4):
            await sched.delay(0.1)
            ps.send(i)

    sched.spawn(producer(), name="producer")
    sched.run_for(1.0)
    log.append(("try", ps.stream.try_next()))
    ps.send("late")
    log.append(("try", ps.stream.try_next(), ps.stream.try_next()))
    return log


def test_promise_stream_order_and_try_next():
    log = both(stream_order)
    assert log[0] == ("try", (True, "a"))
    assert log[-1] == ("try", (True, "late"), (False, None))


# ---------------------------------------------------------------------------
# The seeded tie-break


def tie_orders(F, seed):
    sched = F.Scheduler(sim=True, perturb_seed=seed)
    log = []

    async def actor(i, pri_delay):
        await sched.delay(pri_delay)
        log.append(i)
        await sched.delay(0.01)
        log.append(-i - 1)

    for i in range(8):
        sched.spawn(actor(i, 0.01 if i % 3 else 0.02), name=f"t{i}")
    for i in range(8, 12):
        sched.spawn(actor(i, 0.01),
                    priority=F.TaskPriority.ProxyCommit, name=f"p{i}")
    sched.run_for(0.1)
    probe = F.Scheduler(sim=True, perturb_seed=seed)
    draws = [probe._tie() for _ in range(16)]
    return tuple(log), draws


@pytest.mark.parametrize("seed", [None, 0, 1, 2, 3, 4, 5, 6, 7])
def test_perturbed_tie_break_is_bit_for_bit(seed):
    order, draws = both(tie_orders, seed)
    if seed is None:
        assert draws == [0] * 16
    assert sorted(order) == sorted(list(range(12)) + [-i - 1 for i in range(12)])


def test_perturbation_reorders_some_seed():
    fifo = both(tie_orders, None)[0]
    assert any(both(tie_orders, k)[0] != fifo for k in range(8))


# ---------------------------------------------------------------------------
# The unhandled-error ledger and the live-task count


def ledger(F):
    sched = F.Scheduler(sim=True)

    async def crash(kind):
        await sched.delay(0.01)
        raise kind("x")

    async def waiter(t):
        try:
            await t
        except ValueError:
            return "handled"

    sched.spawn(crash(RuntimeError), name="escaped")
    awaited = sched.spawn(crash(ValueError), name="awaited")
    w = sched.spawn(waiter(awaited), name="waiter")
    async def hold():
        await sched.delay(100.0)

    forever = sched.spawn(hold(), name="forever")
    log = [("live", sched.run_loop_stats()["tasks_live"])]
    sched.run_for(0.1)
    log.append(("waiter", w.done.get()))
    log.append(("live", sched.run_loop_stats()["tasks_live"]))
    forever.cancel()
    sched.run_for(0.1)
    log.append(("live", sched.run_loop_stats()["tasks_live"]))
    log.append(("unhandled", [(n, type(e).__name__)
                              for n, e in sched.unhandled_errors()]))
    sched.clear_unhandled()
    log.append(("cleared", sched.unhandled_errors()))
    stats = sched.run_loop_stats()
    log.append(("stats", sorted(stats), stats["steps"],
                stats["slow_tasks"]))
    return log


def test_unhandled_errors_and_tasks_live():
    log = both(ledger)
    assert log[0] == ("live", 4)
    assert log[2] == ("live", 1) and log[3] == ("live", 0)
    assert log[4] == ("unhandled", [("escaped", "RuntimeError")])


# ---------------------------------------------------------------------------
# The interleaving auditor


def lost_update(F, audit):
    """tests/test_interleave.py::test_racy_rmw_across_await_is_flagged and
    ::test_reread_after_wait_is_the_ordering_discipline."""
    out = []
    for reread in (False, True):
        sched = F.Scheduler(sim=True, audit=audit)
        d = F.AuditedDict(sched, "shared", {"n": 0})

        def spawn(name):
            async def actor():
                v = d["n"]
                await sched.delay(0.01)
                if reread:
                    v = d["n"]
                d["n"] = v + 1

            sched.spawn(actor(), name=name)

        spawn("actor-a")
        spawn("actor-b")
        sched.run_for(0.1)
        out.append((sched.audit_conflicts(), d._d["n"], repr(d)))
    return out


def test_audit_conflicts_on_a_lost_update():
    armed = both(lost_update, True)
    (conflicts, n, _), (clean, n2, _) = armed
    assert len(conflicts) == 1 and n == 1
    assert {conflicts[0]["actor"], conflicts[0]["writer"]} == {
        "actor-a", "actor-b"}
    assert clean == [] and n2 == 2
    off = both(lost_update, False)
    assert [o[0] for o in off] == [[], []]


def audited_dict_ops(F):
    sched = F.Scheduler(sim=True, audit=True)
    d = F.AuditedDict(sched, "x", {"a": 1})
    d["b"] = 2
    out = [d["a"], d.get("c"), "b" in d, d.setdefault("c", 3), d.pop("c")]
    d.update({"e": 5}, f=6)
    out += [sorted(d.keys()), len(d), bool(d), dict(d.items())]
    del d["f"]
    out += [sorted(d), d == {"a": 1, "b": 2, "e": 5}]
    d.clear()
    out.append(bool(d))
    return out


def test_audited_dict_is_a_dict():
    assert both(audited_dict_ops)[-1] is False


# ---------------------------------------------------------------------------
# The run-loop profile and the slow-task record


def profile(F, T):
    log = T.TraceLog()
    old = T.install(log, T.TraceBatch(enabled=False))
    try:
        sched = F.Scheduler(sim=True, profile=True)

        async def worker(n):
            for _ in range(n):
                await sched.delay(0.01)

        async def slow():
            await sched.delay(0.01)
            time.sleep(F.Scheduler.SLOW_TASK_THRESHOLD * 1.2)

        for i in range(3):
            sched.spawn(worker(i + 1), name=f"w{i}")
        sched.spawn(slow(), name="slow")
        sched.run_for(0.1)
        top = {name: steps for name, steps, _t, _m in sched.profile_top(10)}
        stats = sched.run_loop_stats()
    finally:
        T.install(*old)
    slow_events = [e["Actor"] for e in log.events if e["Type"] == "SlowTask"]
    return (top, [n for n, _s in sched.slow_tasks], stats["slow_tasks"],
            stats["slow_tasks_by_actor"], slow_events)


def test_profile_and_slow_task_record():
    logs = [profile(F, T) for F, T in BOTH]
    assert logs[1] == logs[0]
    top, slow_names, n_slow, by_actor, events = logs[0]
    assert top == {"w0": 2, "w1": 3, "w2": 4, "slow": 2}
    assert slow_names == ["slow"] and n_slow == 1
    assert by_actor == {"slow": 1} and events == ["slow"]


# ---------------------------------------------------------------------------
# The census's scheduler gauge


def test_census_snapshot_reports_the_scheduler_tasks():
    for C, F in ((JC, JF), (PC, PF)):
        assert set(C.snapshot()) == {"fds", "connections", "servers",
                                     "tasks"}
        assert C.snapshot()["tasks"] == 0
        sched = F.Scheduler(sim=True)
        async def hold(sched=sched):
            await sched.delay(1.0)

        t = sched.spawn(hold(), name="held")
        pre = C.snapshot(sched)
        assert pre["tasks"] == 1
        t.cancel()
        sched.run_for(0.1)
        post = C.snapshot(sched)
        assert post["tasks"] == 0
        C.check_drained(pre, post)
        grown = dict(pre, tasks=3)
        assert C.growth(pre, grown, ignore={"fds"}) == ["tasks grew 1 -> 3"]
        with pytest.raises(RuntimeError, match="tasks grew 1 -> 3"):
            C.check_drained(pre, grown, ignore={"fds"}, label="unit")
