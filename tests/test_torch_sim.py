"""The port's simulated disk and network (sim/diskqueue.py, sim/network.py),
held against the JAX package's.

* SimDiskQueue: seeded streams of pushes, pops, commits and crashes (a
  random prefix of the un-fsynced buffer survives, the next record may
  land torn) and the recovery scan after each; every record on the
  "disk", the recovered view, the next sequence number and random reads
  byte-identical to JAX's under the same numpy rng. Also a replicated
  LogSystem's crash_and_reboot on both packages: the rebooted replica's
  recovered records and peeks.
* SimNetwork: seeded latency, pair clogs, partitions and heals on one
  virtual clock: each call's delivery times and failures identical.
"""

from __future__ import annotations

import numpy as np
import pytest

from foundationdb_tpu.cluster import logsystem as JL
from foundationdb_tpu.cluster import tlog as JTL
from foundationdb_tpu.runtime import flow as JF
from foundationdb_tpu.sim import diskqueue as JD
from foundationdb_tpu.sim import network as JN
from foundationdb_tpu_torch.cluster import logsystem as PL
from foundationdb_tpu_torch.cluster import tlog as PTL
from foundationdb_tpu_torch.runtime import flow as PF
from foundationdb_tpu_torch.sim import diskqueue as PD
from foundationdb_tpu_torch.sim import network as PN
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()


def _disk(q):
    return [(r.seq, r.is_pop, r.pop_to, r.data, r.corrupt) for r in q._disk]


def disk_stream(D, seed: int, steps: int = 200):
    """A seeded op stream through one SimDiskQueue; the log of every
    observable after each crash and at the end."""
    ops = np.random.default_rng(seed)
    crash_rng = np.random.default_rng(seed + 1000)
    q = D.SimDiskQueue()
    log = []
    for i in range(steps):
        op = int(ops.integers(0, 10))
        if op < 5:
            n = int(ops.integers(0, 40))
            log.append(("push", q.push(ops.bytes(n))))
        elif op < 7:
            log.append(("commit", q.commit()))
        elif op < 8:
            q.pop(int(ops.integers(0, q.next_seq + 1)))
        elif op < 9:
            q.crash(crash_rng)
            log.append(("crash", i, _disk(q), q.recovered, q.next_seq,
                        q._pop_floor))
        else:
            rec = q.recovered if not any(r.corrupt for r in q._disk) else []
            if rec:
                seq = rec[int(ops.integers(0, len(rec)))][0]
                log.append(("read", seq, q.read(seq)))
    q.crash(crash_rng)
    log.append(("end", _disk(q), q.recovered, q.next_seq))
    return log


@pytest.mark.parametrize("seed", range(8))
def test_sim_disk_queue_crash_and_recovery_byte_identical(seed):
    jax_log = disk_stream(JD, seed)
    port_log = disk_stream(PD, seed)
    assert port_log == jax_log
    assert any(e[0] == "crash" for e in jax_log)


def test_torn_tail_is_truncated_the_same():
    """A long un-fsynced buffer crashed under many rngs: some crash
    lands a torn frame, and both scans truncate it to the same disk."""
    torn = 0
    for seed in range(40):
        outs = []
        for D in (JD, PD):
            q = D.SimDiskQueue()
            for i in range(5):
                q.push(b"committed-%d" % i)
            q.commit()
            for i in range(6):
                q.push(b"buffered-record-%d" % i * 3)
            rng = np.random.default_rng(seed)
            n_before = len(q._disk)
            q.crash(rng)
            outs.append((_disk(q), q.recovered, q.next_seq,
                         len(q._disk) - n_before))
        assert outs[1] == outs[0]
        torn += outs[0][3] < 6
    assert torn > 0


def logsystem_reboot(F, L, TL, seed):
    """tests/test_sim_diskqueue.py::test_logsystem_crash_reboot_preserves_
    acked and ::test_logsystem_reboot_after_pops_replays_only_tail."""
    sched = F.Scheduler(sim=True)
    ls = L.LogSystem(sched, n_logs=2)

    def commit(prev, ver, payload):
        req = TL.TLogCommitRequest(
            prev_version=prev, version=ver,
            messages={0: [("set", payload, payload)],
                      TL.LOG_STREAM_TAG: [("set", payload, payload)]},
        )
        sched.run_until(sched.spawn(ls.commit(req)).done)

    for i in range(8):
        commit(i * 10, (i + 1) * 10, b"m%d" % i)
    ls.pop(0, 50)
    ls.pop(-1, 50, consumer="storage")
    commit(80, 90, b"post")
    ls.crash_and_reboot(1, np.random.default_rng(seed))
    rec = ls.tlogs[1].dq.recovered
    peeks = []
    for i in range(2):
        t = sched.spawn(ls.tlogs[i].peek(0, 0))
        sched.run_until(t.done)
        peeks.append(t.done.get())
    commit(90, 100, b"post2")
    return rec, peeks, ls.version.get(), [_disk(t.dq) for t in ls.tlogs]


@pytest.mark.parametrize("seed", [1, 3])
def test_logsystem_crash_reboot_identical(seed):
    jax = logsystem_reboot(JF, JL, JTL, seed)
    port = logsystem_reboot(PF, PL, PTL, seed)
    assert port == jax
    rec, peeks, version, _ = jax
    assert 0 < len(rec) < 9 and version == 100
    assert peeks[0] == peeks[1]


class _Echo:
    def __init__(self, sched):
        self.sched = sched

    async def call(self, x):
        await self.sched.delay(0.001)
        return (x, self.sched.now())


def network_program(F, N, seed):
    sched = F.Scheduler(sim=True)
    net = N.SimNetwork(sched, seed=seed)
    a = net.wrap("client", "server", _Echo(sched), ["call"])
    b = net.wrap("proxy", "server", _Echo(sched), ["call"])
    log = []

    async def caller(name, stub, n):
        for i in range(n):
            try:
                log.append((name, i, await stub.call(i), sched.now()))
            except N.PartitionedError as e:
                log.append((name, i, "partitioned", str(e), sched.now()))
            await sched.delay(0.002)

    async def faults():
        await sched.delay(0.01)
        net.clog_pair("client", "server", 0.05)
        await sched.delay(0.02)
        net.partition("proxy", "server")
        await sched.delay(0.03)
        net.heal("proxy", "server")
        net.clog_pair("proxy", "server", 0.02)

    sched.spawn(caller("client", a, 12), name="client")
    sched.spawn(caller("proxy", b, 12), name="proxy")
    sched.spawn(faults(), name="faults")
    sched.run_for(1.0)
    draws = [float(net.rng.random()) for _ in range(4)]
    return log, draws, sched.now()


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_sim_network_latency_and_clog_sequences_identical(seed):
    jax = network_program(JF, JN, seed)
    port = network_program(PF, PN, seed)
    assert port == jax
    log = jax[0]
    assert any(e[2] == "partitioned" for e in log)
    assert len(log) == 24
