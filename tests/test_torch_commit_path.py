"""The port's wire commit path, held against the JAX package on the CPU.

* The host modules the path runs on: `AdaptiveBatchSizer` and
  `commit_txn_bytes`, the `Sequencer`, the generation state machine, the
  `ByteSample` treap and the `TagCounter`, the same on seeded inputs.
* Same results: one seeded sequential stream (GRVs, versioned reads,
  blind writes, read-modify-writes at stale snapshots, range clears)
  through the JAX pipeline over JAX roles and through the port's
  pipeline over port roles, served in this process: the same versions,
  verdicts, reads, GRVs, storage snapshot and tlog peeks. The resolver
  is port "cuda" (device="cpu") against JAX "tpu-force" with a small
  RESOLVER_KERNEL, and "cpu" against "cpu". Mixed: the port's pipeline
  over the JAX tlog and storage, and the JAX pipeline over the port's.
* Twins of the JAX package's scenarios (tests/test_multiprocess.py,
  tests/test_wire_pipeline.py, tests/test_commit_scaleout.py) on the
  port: visibility and MVCC, the contended counter, the min-combine of
  two resolvers, the tlog pop on durable storage only, stage overlap
  with ordered replies, the read coalescer, a failed successor batch,
  the frame choice, fail-fast; the sequencer's grants, the partitioned
  tlog's chain wait and lock, chained storage applies, the merged
  catch-up and two proxies on one sequencer against the oracle.
* The rate fetcher against a JAX RatekeeperRole with no peers.
* One test spawns the three port children (a "cuda" resolver on the
  CPU, a persistent tlog, a storage) and commits through them with the
  port's pipeline, its resolver tracing into a file.

Roles are served in this process (`_serve_role` tasks on the test's
loop) wherever a process is not the point. The tolerance is equality
throughout.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import tempfile
import types

import numpy as np
import pytest

from foundationdb_tpu.cluster import batching as JB
from foundationdb_tpu.cluster import generation as JG
from foundationdb_tpu.cluster import multiprocess as JMP
from foundationdb_tpu.cluster import sampling as JS
from foundationdb_tpu.cluster import sequencer as JSQ
from foundationdb_tpu.models import types as JT
from foundationdb_tpu.runtime import flow as JF
from foundationdb_tpu.wire import codec as JC
from foundationdb_tpu.wire import transport as JTR
from foundationdb_tpu_torch.cluster import batching as PB
from foundationdb_tpu_torch.cluster import generation as PG
from foundationdb_tpu_torch.cluster import multiprocess as PMP
from foundationdb_tpu_torch.cluster import sampling as PS
from foundationdb_tpu_torch.cluster import sequencer as PSQ
from foundationdb_tpu_torch.models import types as PT
from foundationdb_tpu_torch.runtime import flow as PF
from foundationdb_tpu_torch.testing.oracle import (
    COMMITTED,
    ConflictOracle,
    OracleTxn,
)
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.wire import codec as PC
from foundationdb_tpu_torch.wire import transport as PTR

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

PKG = {
    "port": types.SimpleNamespace(types=PT, codec=PC, transport=PTR, mp=PMP),
    "jax": types.SimpleNamespace(types=JT, codec=JC, transport=JTR, mp=JMP),
}
#: port resolver backend -> JAX resolver backend
BACKENDS = {"cuda": "tpu-force", "cpu": "cpu"}
SMALL_KERNEL = ("KernelConfig(max_key_bytes=16, max_txns=64, max_reads=256,"
                " max_writes=256, history_capacity=4096)")


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@pytest.fixture
def sock_dir():
    # a short path: a Unix socket's holds at most 107 bytes
    d = tempfile.mkdtemp(prefix="cp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


class Roles:
    """Roles of either package served on sockets from this event loop."""

    def __init__(self, directory: str):
        self.dir = directory
        self.tasks: list[asyncio.Task] = []
        self.n = 0

    def serve(self, pkg: str, name: str, backend="native", **kw) -> str:
        self.n += 1
        address = os.path.join(self.dir, f"{pkg[0]}{name}{self.n}.sock")
        if pkg == "port" and name == "resolver":
            kw.setdefault("device", "cpu")
        self.tasks.append(asyncio.ensure_future(
            PKG[pkg].mp._serve_role(name, address, backend, **kw)))
        return address

    async def close(self) -> None:
        for t in self.tasks:
            t.cancel()
        await asyncio.gather(*self.tasks, return_exceptions=True)


async def _conns(pkg: str, *addresses):
    return [await PKG[pkg].mp.connect(a) for a in addresses]


async def _close(*conns):
    for c in conns:
        await c.close()


# ---------------------------------------------------------------------------
# the host modules, on seeded inputs


def test_batch_sizer_and_txn_bytes_match_jax():
    rng = np.random.default_rng(3)
    kw = dict(interval=0.004, min_interval=0.001, max_interval=0.02,
              target_count=64, max_count=512, max_bytes=1 << 20,
              latency_budget=0.05, alpha=0.1, latency_fraction=0.1)
    port, jax = PB.AdaptiveBatchSizer(**kw), JB.AdaptiveBatchSizer(**kw)
    for i in range(300):
        kind = int(rng.integers(0, 3))
        if kind == 0 and i < 150:
            port.batch_full()
            jax.batch_full()
        elif kind == 1 and i < 150:
            n = int(rng.integers(0, 64))
            port.batch_underfull(n)
            jax.batch_underfull(n)
        else:
            s = float(rng.exponential(0.03))
            full = bool(rng.integers(0, 2))
            port.observe_stage_latency(s, full=full)
            jax.observe_stage_latency(s, full=full)
        assert port.as_dict() == jax.as_dict(), i
    for i in range(20):
        p, j = PKG["port"], PKG["jax"]
        args = dict(
            read_conflict_ranges=[(b"r%d" % i, b"s" * i)],
            write_conflict_ranges=[(b"w", b"w\x00")] * (i % 3),
            mutations=[p.codec.Mutation(0, b"k" * i, b"v" * (7 * i))])
        assert PB.commit_txn_bytes(p.types.CommitTransaction(**args)) == \
            JB.commit_txn_bytes(j.types.CommitTransaction(**{
                **args, "mutations": [j.codec.Mutation(0, b"k" * i,
                                                       b"v" * (7 * i))]}))
    assert PB.commit_txn_bytes(PT.CommitTransaction(
        mutations=[(0, b"key", b"value")])) == JB.commit_txn_bytes(
        JT.CommitTransaction(mutations=[(0, b"key", b"value")]))


def test_sequencer_matches_jax():
    """Both Sequencers on virtual clocks, fed the same seeded requests
    (in and out of order, duplicates, stale ones): the same grants."""

    def drive(flow, seq_mod):
        sched = flow.Scheduler(sim=True)
        seq = seq_mod.Sequencer(sched, recovery_version=500)
        rng = np.random.default_rng(9)
        out = []

        async def proxy(pid):
            processed = 0
            for rn in range(1, 12):
                await sched.delay(float(rng.exponential(0.01)))
                rep = await seq.get_commit_version(pid, rn, processed)
                out.append((pid, rn, rep.version, rep.prev_version))
                processed = rn
                dup = await seq.get_commit_version(pid, rn, processed - 1)
                out.append(("dup", dup.version))
                stale = await seq.get_commit_version(pid, 0, processed)
                out.append(("stale", stale))
                seq.report_live_committed_version(rep.version - 3)
                out.append(("live", seq.get_live_committed_version()))

        tasks = [sched.spawn(proxy(p)) for p in ("a", "b", "c")]
        sched.run_until(flow.all_of([t.done for t in tasks]))
        return out

    assert drive(PF, PSQ) == drive(JF, JSQ)
    assert (PSQ.VERSIONS_PER_SECOND, PSQ.MAX_READ_TRANSACTION_LIFE_VERSIONS,
            PSQ.MAX_VERSION_RATE_MODIFIER) == (
        JSQ.VERSIONS_PER_SECOND, JSQ.MAX_READ_TRANSACTION_LIFE_VERSIONS,
        JSQ.MAX_VERSION_RATE_MODIFIER)


def test_generation_matches_jax():
    rows = {}
    for name, mod in (("port", PG), ("jax", JG)):
        ticks = iter(np.arange(0.0, 10.0, 0.25).tolist())
        gen = mod.GenerationState(clock=lambda: next(ticks), timeline_cap=4)
        for _ in range(2):
            gen.begin_recovery(floor=3)
            for status in mod.RECOVERY_STATES[1:]:
                gen.transition(status, Reason="test")
        with pytest.raises(ValueError, match="unknown recovery state"):
            gen.transition("nowhere")
        rows[name] = (gen.epoch, gen.status, gen.timeline_dicts())
    assert rows["port"] == rows["jax"] and rows["port"][0] == 5
    assert PG.RECOVERY_STATES == JG.RECOVERY_STATES
    assert PG.RECOVERY_VERSION_GAP == JG.RECOVERY_VERSION_GAP
    assert PG.recovery_version_for(7, 3) == JG.recovery_version_for(7, 3)
    assert PC.encode(PG.conservative_recovery_transaction(99)) == JC.encode(
        JG.conservative_recovery_transaction(99))
    assert PG.elastic_reason("resolver", 2) == JG.elastic_reason("resolver", 2)
    assert PG.is_elastic_reason("elastic:x") and not PG.is_elastic_reason(None)
    assert PG.stale_epoch_message(1, 2) == JG.stale_epoch_message(1, 2)
    records = [{"Type": "MasterRecoveryState", "Time": 3.0 - i, "Epoch": i,
                "StatusCode": s} for i, s in enumerate(PG.RECOVERY_STATES)]
    records.append({"Type": "Other", "Time": 0.0})
    assert PG.recovery_timeline_from_trace(records) == \
        JG.recovery_timeline_from_trace(records)


def test_byte_sample_and_tag_counter_match_jax():
    rng = np.random.default_rng(4)
    clock = [0.0]
    port = PS.ByteSample(seed=77, capacity=64)
    jax = JS.ByteSample(seed=77, capacity=64)
    ptags = PS.TagCounter(capacity=4, clock=lambda: clock[0])
    jtags = JS.TagCounter(capacity=4, clock=lambda: clock[0])
    for i in range(3000):
        tenant = b"t%d/" % rng.integers(0, 7) if i % 3 else b""
        key = tenant + bytes(rng.integers(0, 256, int(rng.integers(1, 12)),
                                          dtype=np.uint8))
        value = b"v" * int(rng.integers(0, 2000))
        if i % 97 == 0:
            port.erase_range(key, key + b"\xff")
            jax.erase_range(key, key + b"\xff")
        else:
            port.note_write(key, value)
            jax.note_write(key, value)
        clock[0] += 0.01
        ptags.note(PS.tag_of_key(key), len(value))
        jtags.note(JS.tag_of_key(key), len(value))
    assert port.gc_rounds > 0 and port.count
    assert port.items() == jax.items()
    assert port.hot_ranges() == jax.hot_ranges()
    assert port.sampled_bytes(b"t2", b"t5") == jax.sampled_bytes(b"t2", b"t5")
    assert port.snapshot() == jax.snapshot()
    again = PS.ByteSample(seed=1)
    again.restore(port.snapshot())
    assert again.items() == port.items()
    assert ptags.top() == jtags.top() and ptags.busiest() == jtags.busiest()
    assert ptags.rollovers == jtags.rollovers > 0
    for key in (b"\x1eten/x", b"/x", b"a" * 30 + b"/", b"ab/c"):
        assert PS.tag_of_key(key) == JS.tag_of_key(key)


# ---------------------------------------------------------------------------
# same results: one seeded sequential stream through both packages


def seeded_ops(seed: int, n: int = 40) -> list:
    rng = np.random.default_rng(seed)
    return [tuple(int(x) for x in (rng.integers(0, 6), rng.integers(0, 6),
                                   rng.integers(0, 4))) for _ in range(n)]


async def drive_stream(p, pipe, storage, tlog, ops) -> dict:
    """One op at a time: a GRV, a read at it, then a commit (a blind
    write, a range clear, or a read-modify-write at the snapshot of an
    earlier GRV, reporting its conflicting keys or not)."""
    T, M = p.types.CommitTransaction, p.codec.Mutation
    out, grvs = [], []
    for kind, k, lag in ops:
        key = b"key%d" % k
        rv = await pipe.get_read_version()
        grvs.append(rv)
        snap = grvs[max(0, len(grvs) - 1 - lag)]
        cur = await pipe.read(key, rv)
        n = int.from_bytes(cur or b"\0" * 8, "little")
        kr = (key, key + b"\x00")
        bump = [M(0, key, (n + 1).to_bytes(8, "little"))]
        if kind == 0:
            txn = T(write_conflict_ranges=[kr], mutations=bump)
        elif kind == 1:
            hi = b"key%d" % (k + 2)
            txn = T(read_conflict_ranges=[(key, hi)],
                    write_conflict_ranges=[(key, hi)], read_snapshot=snap,
                    mutations=[M(1, key, hi)], report_conflicting_keys=True)
        else:
            txn = T(read_conflict_ranges=[kr], write_conflict_ranges=[kr],
                    read_snapshot=snap, mutations=bump,
                    report_conflicting_keys=kind == 3)
        try:
            outcome = await pipe.commit(txn)
        except p.mp.NotCommittedError as e:
            outcome = str(e)
        out.append((rv, cur, outcome))
    await pipe.stop()
    head = pipe.committed_version
    snap = await storage.call(p.mp.TOKEN_STORAGE_SNAPSHOT,
                              p.mp.StorageSnapshotReq(version=head))
    peek = await tlog.call(p.mp.TOKEN_TLOG_PEEK_BATCH,
                           p.mp.TLogPeekBatchReq(after_version=-1,
                                                 max_entries=10_000))
    return dict(ops=out, head=head, grv=await pipe.get_read_version(),
                snapshot=(snap.version, snap.kvs),
                tlog=[(v, [(m.op, m.param1, m.param2) for m in g])
                      for v, g in zip(peek.versions, peek.groups)])


async def stream_through(sock_dir, pipeline, resolver, logs, backend,
                         seed=21):
    roles = Roles(sock_dir)
    r_backend = backend if resolver == "port" else BACKENDS[backend]
    addrs = [roles.serve(resolver, "resolver", r_backend),
             roles.serve(logs, "tlog"), roles.serve(logs, "storage")]
    try:
        res, tlog, storage = await _conns(pipeline, *addrs)
        pipe = PKG[pipeline].mp.ProxyPipeline([res], tlog, storage,
                                              batch_interval=0.001)
        pipe.start()
        out = await drive_stream(PKG[pipeline], pipe, storage, tlog,
                                 seeded_ops(seed))
        await _close(res, tlog, storage)
        return out
    finally:
        await roles.close()


_REFERENCE: dict = {}


@pytest.mark.parametrize("backend,pipeline,resolver,logs", [
    ("cpu", "port", "port", "port"),
    ("cuda", "port", "port", "port"),
    ("cpu", "port", "port", "jax"),
    ("cpu", "jax", "jax", "port"),
    ("cuda", "jax", "port", "port"),
])
def test_same_results_as_jax(monkeypatch, sock_dir, backend, pipeline,
                             resolver, logs):
    monkeypatch.setenv("RESOLVER_KERNEL", SMALL_KERNEL)
    if backend not in _REFERENCE:
        _REFERENCE[backend] = run(stream_through(sock_dir, "jax", "jax",
                                                 "jax", backend))
    want = _REFERENCE[backend]
    got = run(stream_through(sock_dir, pipeline, resolver, logs, backend))
    outcomes = [o for _rv, _cur, o in want["ops"]]
    assert "CONFLICT" in outcomes and any(isinstance(o, int)
                                          for o in outcomes)
    assert any(m[0] == 1 for _v, g in want["tlog"] for m in g)
    assert got == want


# ---------------------------------------------------------------------------
# twins of tests/test_multiprocess.py (roles in this process)


def test_pipeline_visibility_conflict_and_mvcc(sock_dir):
    async def scenario():
        roles = Roles(sock_dir)
        res, tlog, storage = await _conns("port", *(
            roles.serve("port", n) for n in ("resolver", "tlog", "storage")))
        pipe = PMP.ProxyPipeline([res], tlog, storage)
        pipe.start()
        M = PC.Mutation
        v1 = await pipe.commit(PT.CommitTransaction(
            write_conflict_ranges=[(b"a", b"a\x00")],
            mutations=[M(0, b"a", b"1")]))
        assert v1 > 0
        assert await pipe.read(b"a", v1) == b"1"
        assert await pipe.get_read_version() >= v1
        with pytest.raises(PMP.NotCommittedError):
            await pipe.commit(PT.CommitTransaction(
                read_conflict_ranges=[(b"a", b"a\x00")],
                write_conflict_ranges=[(b"a", b"a\x00")],
                read_snapshot=0, mutations=[M(0, b"a", b"2")]))
        v2 = await pipe.commit(PT.CommitTransaction(
            read_conflict_ranges=[(b"a", b"a\x00")],
            write_conflict_ranges=[(b"a", b"a\x00")],
            read_snapshot=await pipe.get_read_version(),
            mutations=[M(0, b"a", b"2")]))
        assert v2 > v1
        assert await pipe.read(b"a", v2) == b"2"
        assert await pipe.read(b"a", v1) == b"1"
        await pipe.stop()
        await _close(res, tlog, storage)
        await roles.close()

    run(scenario())


def test_contended_counter_workload(sock_dir):
    n_clients, n_ops, n_keys = 8, 15, 4

    async def scenario():
        roles = Roles(sock_dir)
        res, tlog, storage = await _conns("port", *(
            roles.serve("port", n) for n in ("resolver", "tlog", "storage")))
        pipe = PMP.ProxyPipeline([res], tlog, storage, batch_interval=0.001)
        pipe.start()
        committed = [0] * n_keys

        async def client(cid):
            for i in range(n_ops):
                key = b"ctr%d" % ((cid + i) % n_keys)
                kr = (key, key + b"\x00")
                rv = await pipe.get_read_version()
                cur = await pipe.read(key, rv)
                n = int.from_bytes(cur or b"\0" * 8, "little")
                try:
                    await pipe.commit(PT.CommitTransaction(
                        read_conflict_ranges=[kr], write_conflict_ranges=[kr],
                        read_snapshot=rv,
                        mutations=[PC.Mutation(0, key,
                                               (n + 1).to_bytes(8, "little"))]))
                    committed[(cid + i) % n_keys] += 1
                except PMP.NotCommittedError:
                    pass

        await asyncio.gather(*(client(c) for c in range(n_clients)))
        rv = await pipe.get_read_version()
        snap = await storage.call(PMP.TOKEN_STORAGE_SNAPSHOT,
                                  PMP.StorageSnapshotReq(version=rv))
        got = {k: int.from_bytes(v, "little") for k, v in snap.kvs}
        assert 0 < sum(committed) < n_clients * n_ops
        for i in range(n_keys):
            assert got.get(b"ctr%d" % i, 0) == committed[i]
        blocks = PMP._pipeline_status_blocks(pipe)
        want = JMP._pipeline_status_blocks(pipe)
        assert json.dumps(blocks) and sorted(blocks) == sorted(want)
        assert sorted(blocks["proxy0"]["qos"]) == sorted(want["proxy0"]["qos"])
        await pipe.stop()
        await _close(res, tlog, storage)
        await roles.close()

    run(scenario())


def test_multi_resolver_min_combine(sock_dir):
    async def scenario():
        roles = Roles(sock_dir)
        r0, r1, tlog, storage = await _conns("port", *(
            roles.serve("port", n)
            for n in ("resolver", "resolver", "tlog", "storage")))
        pipe = PMP.ProxyPipeline([r0, r1], tlog, storage)
        pipe.start()
        v1 = await pipe.commit(PT.CommitTransaction(
            write_conflict_ranges=[(b"k", b"k\x00")],
            mutations=[PC.Mutation(0, b"k", b"v")]))
        with pytest.raises(PMP.NotCommittedError):
            await pipe.commit(PT.CommitTransaction(
                read_conflict_ranges=[(b"k", b"k\x00")], read_snapshot=0))
        assert await pipe.read(b"k", v1) == b"v"
        await pipe.stop()
        await _close(r0, r1, tlog, storage)
        await roles.close()

    run(scenario())


@pytest.mark.parametrize("durable", [False, True])
def test_tlog_pop_requires_durable_storage(sock_dir, durable):
    async def scenario():
        roles = Roles(sock_dir)
        res, tlog, storage = await _conns(
            "port", roles.serve("port", "resolver"),
            roles.serve("port", "tlog", data_dir=os.path.join(sock_dir, "tl")),
            roles.serve("port", "storage", data_dir=(
                os.path.join(sock_dir, "sd") if durable else None)))
        pipe = PMP.ProxyPipeline([res], tlog, storage, batch_interval=0.001)
        pipe.start()
        for i in range(4):
            await pipe.commit(PT.CommitTransaction(
                mutations=[PC.Mutation(0, b"p%d" % i, b"v")]))
        await pipe.stop()
        st = json.loads((await tlog.call(PMP.TOKEN_STATUS,
                                         PMP.StatusRequest(pad=0))).payload)
        await _close(res, tlog, storage)
        await roles.close()
        return st["qos"]["entries"]

    entries = run(scenario())
    assert entries < 4 if durable else entries == 4


# ---------------------------------------------------------------------------
# twins of tests/test_wire_pipeline.py's stage-overlap cases (stub roles)


def _txn(key: bytes, value: bytes, rv: int = 0):
    kr = (key, key + b"\x00")
    return PT.CommitTransaction(
        read_conflict_ranges=[kr], write_conflict_ranges=[kr],
        read_snapshot=rv, mutations=[PC.Mutation(0, key, value)])


class _StubResolver:
    def __init__(self, journal, latency=0.0):
        self.journal, self.latency = journal, latency
        self.version = -1
        self.frames: list[type] = []

    async def call(self, token, req, **_kw):
        assert token == PMP.TOKEN_RESOLVE
        self.frames.append(type(req))
        self.journal.append(("resolve_start", req.version))
        if self.latency:
            await asyncio.sleep(self.latency)
        assert req.prev_version >= self.version or self.version == -1
        self.version = req.version
        self.journal.append(("resolve_end", req.version))
        n = (req.cols.n_txns if isinstance(req, PC.ResolveBatchColumnar)
             else len(req.transactions))
        return PT.ResolveTransactionBatchReply(
            committed=[int(PT.TransactionResult.COMMITTED)] * n)


class _StubTLog:
    def __init__(self, journal, latency=0.0):
        self.journal, self.latency = journal, latency
        self.version = -1

    async def call(self, token, req, **_kw):
        assert token == PMP.TOKEN_TLOG_PUSH
        self.journal.append(("push_start", req.version))
        if self.latency:
            await asyncio.sleep(self.latency)
        assert req.version > self.version
        self.version = req.version
        self.journal.append(("push_end", req.version))
        return PMP.TLogPushReply(durable_version=self.version)


class _StubStorage:
    def __init__(self, journal):
        self.journal = journal
        self.version = 0
        self.data: dict = {}

    async def call(self, token, req, **_kw):
        if token == PMP.TOKEN_STORAGE_APPLY_BATCH:
            self.journal.append(("apply_batch", tuple(req.versions)))
            assert list(req.versions) == sorted(req.versions)
            for v, muts in zip(req.versions, req.groups):
                assert v > self.version
                for m in muts:
                    self.data.setdefault(m.param1, []).append((v, m.param2))
                self.version = v
            return PMP.StorageApplyReply(durable_version=self.version)
        if token == PMP.TOKEN_STORAGE_GET_BATCH:
            self.journal.append(("get_batch", tuple(req.keys)))
            vals = []
            for k, rv in zip(req.keys, req.versions):
                assert self.version >= rv, "read served before apply"
                val = None
                for v, x in self.data.get(k, []):
                    if v <= rv:
                        val = x
                vals.append(val)
            return PMP.StorageGetBatchReply(values=vals)
        raise AssertionError(f"unexpected token {token:#x}")


def test_batch_overlap_and_ordered_replies():
    async def go():
        journal = []
        pipe = PMP.ProxyPipeline(
            [_StubResolver(journal)], _StubTLog(journal, latency=0.05),
            _StubStorage(journal), batch_interval=0.005, max_batch=4)
        pipe.start()
        order = []

        async def commit(key, tag):
            v = await pipe.commit(_txn(key, b"v-" + tag))
            order.append((tag, v))
            return v

        t1 = asyncio.ensure_future(commit(b"k1", b"a"))
        await asyncio.sleep(0.02)
        t2 = asyncio.ensure_future(commit(b"k2", b"b"))
        v1, v2 = await t1, await t2
        await pipe.stop()
        idx = journal.index
        assert v2 > v1
        assert idx(("resolve_end", v2)) < idx(("push_end", v1)), journal
        assert idx(("push_start", v1)) < idx(("resolve_start", v2)), journal
        assert idx(("push_end", v1)) < idx(("push_start", v2)), journal
        assert order == [(b"a", v1), (b"b", v2)]
        applied = [v for ev, vs in journal if ev == "apply_batch" for v in vs]
        assert applied == sorted(applied) and set(applied) == {v1, v2}

    asyncio.run(go())


def test_read_coalescer_single_rpc_exact_versions():
    async def go():
        journal = []
        storage = _StubStorage(journal)
        pipe = PMP.ProxyPipeline([_StubResolver(journal)], _StubTLog(journal),
                                 storage, batch_interval=0.002, max_batch=64)
        pipe.start()
        v1 = await pipe.commit(_txn(b"k", b"old"))
        while storage.version < v1:
            await asyncio.sleep(0.002)
        v2 = await pipe.commit(_txn(b"k", b"new"))
        while storage.version < v2:
            await asyncio.sleep(0.002)
        journal.clear()
        got = await asyncio.gather(pipe.read(b"k", v1), pipe.read(b"k", v2))
        await pipe.stop()
        assert got == [b"old", b"new"]
        gets = [ev for ev in journal if ev[0] == "get_batch"]
        assert len(gets) == 1 and len(gets[0][1]) == 2, journal

    asyncio.run(go())


def test_successor_failure_does_not_fail_inflight_predecessor():
    class _SecondDies(_StubResolver):
        calls = 0

        async def call(self, token, req, **kw):
            self.calls += 1
            if self.calls >= 2:
                raise PTR.RemoteError("resolver died")
            return await super().call(token, req, **kw)

    class _GatedTLog(_StubTLog):
        def __init__(self, journal, release):
            super().__init__(journal)
            self.release = release

        async def call(self, token, req, **_kw):
            self.journal.append(("push_start", req.version))
            await self.release.wait()
            self.version = req.version
            self.journal.append(("push_end", req.version))
            return PMP.TLogPushReply(durable_version=self.version)

    async def go():
        journal = []
        release = asyncio.Event()
        storage = _StubStorage(journal)
        pipe = PMP.ProxyPipeline([_SecondDies(journal)],
                                 _GatedTLog(journal, release), storage,
                                 batch_interval=0.005, max_batch=4)
        pipe.start()
        t1 = asyncio.ensure_future(pipe.commit(_txn(b"k1", b"v1")))
        while not any(ev[0] == "push_start" for ev in journal):
            await asyncio.sleep(0.001)
        t2 = asyncio.ensure_future(pipe.commit(_txn(b"k2", b"v2")))
        with pytest.raises(PTR.RemoteError):
            await t2
        assert pipe.failed is not None
        release.set()
        v1 = await t1
        await pipe.stop()
        assert v1 > 0 and pipe.committed_version == v1
        assert storage.version == v1 and storage.data[b"k1"] == [(v1, b"v1")]

    asyncio.run(go())


@pytest.mark.parametrize("columnar", [True, False])
def test_pipeline_frame_selection(columnar):
    async def go():
        journal = []
        resolver = _StubResolver(journal)
        pipe = PMP.ProxyPipeline([resolver], _StubTLog(journal),
                                 _StubStorage(journal), batch_interval=0.002,
                                 max_batch=8, resolve_columnar=columnar)
        pipe.start()
        assert await pipe.commit(_txn(b"k", b"v")) > 0
        await pipe.stop()
        want = (PC.ResolveBatchColumnar if columnar
                else PT.ResolveTransactionBatchRequest)
        assert resolver.frames == [want]

    asyncio.run(go())


def test_pipeline_failure_fails_fast_not_wedged():
    class _Dying(_StubResolver):
        async def call(self, token, req, **_kw):
            raise PTR.RemoteError("resolver died")

    async def go():
        journal = []
        pipe = PMP.ProxyPipeline([_Dying(journal)], _StubTLog(journal),
                                 _StubStorage(journal), batch_interval=0.002,
                                 max_batch=4)
        pipe.start()
        with pytest.raises(PTR.RemoteError):
            await pipe.commit(_txn(b"k", b"v"))
        assert pipe.failed is not None
        with pytest.raises(PTR.RemoteError):
            await asyncio.wait_for(pipe.commit(_txn(b"k", b"v2")), 1.0)
        await pipe.stop()

    asyncio.run(go())


# ---------------------------------------------------------------------------
# twins of tests/test_commit_scaleout.py


def test_sequencer_grants_chain_globally_and_per_tag():
    async def scenario():
        seq = PMP.SequencerRole(recovery_version=100, n_tags=2)

        def req(pid, rn, done, tags):
            return PMP.GetCommitVersionRequest(
                proxy_id=pid, request_num=rn, most_recent_processed=done,
                epoch=0, tags=tags)

        g1 = await seq.get_commit_version(req("proxy0", 1, 0, [0]))
        assert g1.prev_version == 100 and g1.version > 100
        assert list(g1.tag_prevs) == [100]
        g2 = await seq.get_commit_version(req("proxy1", 1, 0, [0, 1]))
        assert g2.prev_version == g1.version
        assert list(g2.tag_prevs) == [g1.version, 100]
        g3 = await seq.get_commit_version(req("proxy0", 2, 1, [1]))
        assert g3.prev_version == g2.version
        assert list(g3.tag_prevs) == [g2.version]
        dup = await seq.get_commit_version(req("proxy0", 2, 1, [1]))
        assert (dup.version, dup.prev_version, list(dup.tag_prevs)) == (
            g3.version, g3.prev_version, list(g3.tag_prevs))
        assert seq.grants == 3
        st = seq.status()
        assert st["qos"]["proxies_seen"] == 2 and json.dumps(st)

    run(scenario())


def test_sequencer_fences_and_live_committed():
    async def scenario():
        seq = PMP.SequencerRole(epoch=5, recovery_version=50)
        with pytest.raises(PTR.RemoteError, match="stale_epoch"):
            await seq.get_commit_version(PMP.GetCommitVersionRequest(
                proxy_id="proxy0", request_num=1, most_recent_processed=0,
                epoch=4, tags=[0]))
        with pytest.raises(PTR.RemoteError, match="stale_epoch"):
            await seq.report_committed(
                PMP.ReportRawCommittedVersionRequest(version=7, epoch=4))
        assert seq.stale_epoch_rejects == 2

        async def live(version):
            return (await seq.report_committed(
                PMP.ReportRawCommittedVersionRequest(version=version,
                                                     epoch=5))).live_version

        assert await live(-1) == 50
        await live(90)
        assert await live(-1) == 90
        assert (await seq.get_version(PMP.RoleVersionReq(pad=0))).version == 50

    run(scenario())


def test_partitioned_tlog_parks_until_predecessor_lands():
    async def scenario():
        tlog = PMP.TLogRole(partitioned=True)
        await tlog.lock(PMP.TLogLock(epoch=0, recovery_version=0,
                                     partitioned=1))
        order = []

        async def late():
            rep = await tlog.push(PMP.TLogPush(
                version=10, prev_version=5,
                mutations=[PC.Mutation(0, b"b", b"2")], epoch=0))
            order.append(("late", rep.durable_version))

        task = asyncio.ensure_future(late())
        await asyncio.sleep(0.05)
        assert not task.done() and tlog._chain_waiters == 1
        rep = await tlog.push(PMP.TLogPush(
            version=5, prev_version=0,
            mutations=[PC.Mutation(0, b"a", b"1")], epoch=0))
        order.append(("early", rep.durable_version))
        await task
        assert order == [("early", 5), ("late", 10)]
        assert [v for v, _m in tlog.entries] == [5, 10]

    run(scenario())


def test_partitioned_tlog_lock_drains_parked_waiters_as_stale():
    async def scenario():
        tlog = PMP.TLogRole(partitioned=True)
        await tlog.lock(PMP.TLogLock(epoch=1, recovery_version=0,
                                     partitioned=1))
        task = asyncio.ensure_future(tlog.push(PMP.TLogPush(
            version=100, prev_version=99, mutations=[], epoch=1)))
        await asyncio.sleep(0.05)
        assert not task.done()
        await tlog.lock(PMP.TLogLock(epoch=2, recovery_version=120,
                                     partitioned=1))
        with pytest.raises(PTR.RemoteError, match="stale_epoch"):
            await task
        assert tlog.version == 120
        with pytest.raises(PTR.RemoteError, match="stale_epoch"):
            await tlog.lock(PMP.TLogLock(epoch=1))
        surv = PMP.TLogRole()
        assert not surv.partitioned
        await surv.lock(PMP.TLogLock(epoch=1, recovery_version=0,
                                     partitioned=1))
        assert surv.partitioned

    run(scenario())


def test_storage_chained_applies_and_advance_floor():
    async def scenario():
        st = PMP.StorageRole()
        done = []

        async def late():
            await st.apply_batch(PMP.StorageApplyBatch(
                versions=[20], groups=[[PC.Mutation(0, b"k", b"late")]],
                prev_versions=[10]))
            done.append("late")

        task = asyncio.ensure_future(late())
        await asyncio.sleep(0.05)
        assert not task.done()
        await st.apply_batch(PMP.StorageApplyBatch(
            versions=[10], groups=[[PC.Mutation(0, b"k", b"early")]],
            prev_versions=[0]))
        done.append("early")
        await task
        assert done == ["early", "late"] and st.version == 20
        assert st.history[b"k"] == [(10, b"early"), (20, b"late")]
        await st.apply_batch(PMP.StorageApplyBatch(
            versions=[30, 40], groups=[[], [PC.Mutation(0, b"k", b"v40")]],
            prev_versions=[20, 30]))
        assert st.version == 40
        # recovery's floor advance unblocks the new generation's chain
        task = asyncio.ensure_future(st.apply_batch(PMP.StorageApplyBatch(
            versions=[60], groups=[[PC.Mutation(0, b"k", b"new")]],
            prev_versions=[50])))
        await asyncio.sleep(0.05)
        assert not task.done()
        await st.advance_floor(50)
        await task
        assert st.version == 60
        assert (await st.get(PMP.StorageGet(key=b"k", version=55))
                ).value == b"v40"

    run(scenario())


def test_storage_merged_catchup_combines_cross_tag_versions(sock_dir):
    async def scenario():
        roles = Roles(sock_dir)
        a0, a1 = roles.serve("port", "tlog"), roles.serve("port", "tlog")
        c0, c1 = await _conns("port", a0, a1)
        M = PC.Mutation
        for c, v, prev, m in ((c0, 10, 0, M(0, b"a", b"1")),
                              (c0, 20, 10, M(0, b"a", b"2")),
                              (c1, 20, 0, M(0, b"\xf0z", b"9")),
                              (c1, 30, 20, M(0, b"\xf0z", b"10"))):
            await c.call(PMP.TOKEN_TLOG_PUSH, PMP.TLogPush(
                version=v, prev_version=prev, mutations=[m], epoch=0))
        st = PMP.StorageRole()
        rep = await st.catch_up(PMP.StorageCatchUp(
            tlog_address=a0, tlog_addresses=[a1], recovery_version=45))
        assert rep.version == 45
        assert st.history[b"a"] == [(10, b"1"), (20, b"2")]
        assert st.history[b"\xf0z"] == [(20, b"9"), (30, b"10")]
        one = PMP.StorageRole()
        await one.catch_up(PMP.StorageCatchUp(tlog_address=a1))
        assert one.version == 30 and b"a" not in one.history
        await _close(c0, c1)
        await roles.close()

    run(scenario())


def test_two_proxies_share_the_version_chain_with_oracle_parity(sock_dir):
    n_clients, n_ops, n_keys = 6, 10, 4
    keys = [b"ctr%d" % i for i in range(n_keys // 2)] + [
        b"\xf0ctr%d" % i for i in range(n_keys - n_keys // 2)]

    async def scenario():
        roles = Roles(sock_dir)
        addr = {n: roles.serve("port", n.rstrip("01"))
                for n in ("resolver", "tlog0", "tlog1", "storage",
                          "sequencer")}
        for name in ("tlog0", "tlog1"):
            (c,) = await _conns("port", addr[name])
            await c.call(PMP.TOKEN_TLOG_LOCK, PMP.TLogLock(
                epoch=0, recovery_version=0, partitioned=1))
            await c.close()
        (c,) = await _conns("port", addr["resolver"])
        await c.call(PMP.TOKEN_RESOLVE, PT.ResolveTransactionBatchRequest(
            prev_version=-1, version=0, last_received_version=-1, epoch=0))
        await c.close()
        pipes, all_conns = [], []
        for pid in ("proxy0", "proxy1"):
            res, tl0, tl1, storage, seq = await _conns(
                "port", *(addr[n] for n in ("resolver", "tlog0", "tlog1",
                                            "storage", "sequencer")))
            pipe = PMP.ProxyPipeline(
                [res], tl0, storage, sequencer=seq, proxy_id=pid,
                tlogs=[tl0, tl1], tlog_boundaries=[b"\x80"],
                batch_interval=0.001)
            pipe.start()
            pipes.append(pipe)
            all_conns += [res, tl0, tl1, storage, seq]
        committed = {k: 0 for k in keys}
        records = []

        async def client(cid):
            pipe = pipes[cid % 2]
            for i in range(n_ops):
                key = keys[(cid + i) % n_keys]
                kr = (key, key + b"\x00")
                rv = await pipe.get_read_version()
                cur = await pipe.read(key, rv)
                n = int.from_bytes(cur or b"\0" * 8, "little")
                try:
                    v = await pipe.commit(PT.CommitTransaction(
                        read_conflict_ranges=[kr], write_conflict_ranges=[kr],
                        read_snapshot=rv, mutations=[PC.Mutation(
                            0, key, (n + 1).to_bytes(8, "little"))]))
                except PMP.NotCommittedError:
                    records.append((key, rv, None))
                    continue
                committed[key] += 1
                records.append((key, rv, v))
                assert await pipes[(cid + 1) % 2].get_read_version() >= v

        await asyncio.gather(*(client(c) for c in range(n_clients)))
        assert sum(committed.values()) > 0
        assert all(p.version_grants > 0 for p in pipes)
        assert pipes[0].saturation()["tag_partitioned"]
        for pipe in pipes:
            rv = await pipe.get_read_version()
            for key in keys:
                cur = await pipe.read(key, rv)
                assert int.from_bytes(cur or b"\0" * 8, "little") == \
                    committed[key]
        oracle = ConflictOracle()
        commits = sorted((v, key, rv) for key, rv, v in records
                         if v is not None)
        by_version: dict = {}
        for v, key, rv in commits:
            by_version.setdefault(v, []).append((key, rv))
        for v in sorted(by_version):
            txns = [OracleTxn([(k, k + b"\x00")], [(k, k + b"\x00")], rv)
                    for k, rv in by_version[v]]
            assert oracle.resolve(txns, v).verdicts == [COMMITTED] * len(txns)
        for key, rv, v in records:
            if v is None:
                assert any(cv > rv and ck == key for cv, ck, _r in commits)
        for name, lo, hi in (("tlog0", b"", b"\x80"),
                             ("tlog1", b"\x80", None)):
            (c,) = await _conns("port", addr[name])
            rep = await c.call(PMP.TOKEN_TLOG_PEEK_BATCH, PMP.TLogPeekBatchReq(
                after_version=0, max_entries=10_000))
            assert rep.versions
            for muts in rep.groups:
                for m in muts:
                    assert m.param1 >= lo and (hi is None or m.param1 < hi)
            await c.close()
        for pipe in pipes:
            await pipe.stop()
        await _close(*all_conns)
        await roles.close()

    run(scenario())


# ---------------------------------------------------------------------------
# the rate fetcher against the JAX ratekeeper


def test_rate_fetcher_against_a_jax_ratekeeper(sock_dir):
    async def scenario():
        roles = Roles(sock_dir)
        rk_addr = roles.serve("jax", "ratekeeper", peers=[])
        addrs = [roles.serve("port", n) for n in ("resolver", "tlog",
                                                  "storage")]
        res, tlog, storage, rk = await _conns("port", *addrs, rk_addr)
        pipe = PMP.ProxyPipeline([res], tlog, storage, ratekeeper=rk,
                                 rate_fetch_interval=0.02)
        pipe.start()
        for _ in range(200):
            if pipe._rate_info:
                break
            await asyncio.sleep(0.01)
        direct = json.loads((await rk.call(
            PMP.TOKEN_GET_RATE_INFO, PMP.GetRateInfoRequest(pad=0))).payload)
        assert set(pipe._rate_info) == set(direct)
        assert pipe._rate_tau == direct["failsafe_tau"]
        grv = pipe.grv_saturation()
        assert grv["transactions_per_second_limit"] is not None
        assert not grv["budget_stale"]
        assert await pipe.get_read_version() == 0
        # the ratekeeper goes away: two missed fetches mark the budget
        # stale and decay it toward the fail-safe floor
        await rk.close()
        for _ in range(300):
            if pipe._rate_stale:
                break
            await asyncio.sleep(0.01)
        assert pipe.grv_saturation()["budget_stale"]
        assert pipe._rate_limit >= pipe._rate_floor
        await pipe.stop()
        await _close(res, tlog, storage)
        await roles.close()

    run(scenario())


# ---------------------------------------------------------------------------
# the three port children


def test_port_pipeline_over_three_port_processes(sock_dir, tmp_path):
    """A port ProxyPipeline over a port "cuda" resolver (on the CPU), a
    persistent port tlog and a port storage, each its own process: a
    contended counter load, the exact count in the snapshot, the tlog's
    entries the committed versions, and the resolver's span chained to
    this process's trace in its trace file."""
    from foundationdb_tpu_torch.utils import spans as _spans
    from foundationdb_tpu_torch.utils import trace as _tr

    res_trace = str(tmp_path / "resolver.jsonl")
    procs = [
        PMP.spawn_role("resolver", sock_dir, backend="cuda", device="cpu",
                       trace_file=res_trace,
                       env={"RESOLVER_KERNEL": SMALL_KERNEL}),
        PMP.spawn_role("tlog", sock_dir, data_dir=str(tmp_path / "tl")),
        PMP.spawn_role("storage", sock_dir),
    ]
    sink = _tr.TraceLog(min_severity=_tr.SEV_DEBUG)
    prev_sinks = _tr.install(sink, _tr.TraceBatch(logger=sink, enabled=True))
    prev_exp = _spans.set_exporter(_spans.SpanExporter(trace_log=sink))
    try:
        async def scenario():
            res, tlog, storage = [await PMP.connect(p.address, proc=p)
                                  for p in procs]
            pipe = PMP.ProxyPipeline([res], tlog, storage, trace=True,
                                     batch_interval=0.001)
            pipe.start()
            committed: dict = {}

            async def client(cid):
                for i in range(6):
                    key = b"ctr%d" % ((cid + i) % 3)
                    kr = (key, key + b"\x00")
                    rv = await pipe.get_read_version()
                    n = int.from_bytes(await pipe.read(key, rv)
                                       or b"\0" * 8, "little")
                    try:
                        v = await pipe.commit(PT.CommitTransaction(
                            read_conflict_ranges=[kr],
                            write_conflict_ranges=[kr], read_snapshot=rv,
                            mutations=[PC.Mutation(
                                0, key, (n + 1).to_bytes(8, "little"))]))
                    except PMP.NotCommittedError:
                        continue
                    committed.setdefault(key, []).append(v)

            await asyncio.gather(*(client(c) for c in range(6)))
            await pipe.stop()
            head = pipe.committed_version
            snap = await storage.call(PMP.TOKEN_STORAGE_SNAPSHOT,
                                      PMP.StorageSnapshotReq(version=head))
            assert {k: int.from_bytes(v, "little") for k, v in snap.kvs} == {
                k: len(vs) for k, vs in committed.items()}
            peek = await tlog.call(PMP.TOKEN_TLOG_PEEK_BATCH,
                                   PMP.TLogPeekBatchReq(after_version=-1,
                                                        max_entries=1000))
            logged = {v for v, g in zip(peek.versions, peek.groups) if g}
            assert logged == {v for vs in committed.values() for v in vs}
            st = json.loads((await res.call(
                PMP.TOKEN_STATUS, PMP.StatusRequest(pad=0))).payload)
            assert st["backend"] == "cuda" and st["version"] == head
            assert st["qos"]["resolve_path"]["columnar_batches"] >= 2
            await _close(res, tlog, storage)

        run(scenario())
    finally:
        _tr.install(*prev_sinks)
        _spans.set_exporter(prev_exp)
        for p in procs:
            p.stop()
    trace_ids = {r["TraceID"] for r in sink.events if r["Type"] == "Span"}
    with open(res_trace) as f:
        child = [json.loads(line) for line in f]
    spans = [r for r in child if r["Type"] == "Span"
             and r["Location"] == "Resolver.resolveBatch"]
    assert spans and all(s["TraceID"] in trace_ids and s["ParentID"]
                         for s in spans)
    assert any(r.get("Location") == "Resolver.resolveBatch.After"
               for r in child)
