"""The port's Resolver role, held against the JAX package's on the CPU.

Every scenario of tests/test_resolver.py, and seeded multi-proxy
streams, run through the JAX `Resolver` on the JAX `Scheduler` and
through the port's `Resolver(device="cpu")` on the port's, with the
same requests in the same spawn order. The backends map as the port's
table says (models/conflict_set.py): JAX "tpu-force" against the port's
"cuda" on the CPU (both run their conflict kernels), and "cpu" against
"cpu" (both the host oracle). Held equal, exactly:

* every reply: `committed`, `conflicting_key_range_map`,
  `state_mutations`, `private_mutations`, `tpcv_map`, `written_tags`,
  and `None` for the reference's Never();
* the role's counters;
* `saturation()`: every entry, and in its `kernel` block the entries a
  run decides (counts, occupancy, device gauges); the wall-clock ones
  (stage seconds, kernel build cache) are only checked to be present.

Also: the knob-routed construction on both sides just under and at the
min batch (both packages' SERVER_KNOBS set by monkeypatch: at TEST_CONFIG
the JAX knob path builds the CPU oracle, so parity there alone would
hold two oracles against each other), `route_stream` against JAX's, and
that the device is never hidden (`device=None` raises without a card,
explicit "cuda" is never gated).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from foundationdb_tpu import resolver as JR
from foundationdb_tpu.config import KernelConfig as JaxConfig
from foundationdb_tpu.models import conflict_set as JCS
from foundationdb_tpu.models import types as JT
from foundationdb_tpu.runtime import flow as JF
from foundationdb_tpu.utils import packing as jax_packing
from foundationdb_tpu.utils.knobs import SERVER_KNOBS as JAX_KNOBS
from foundationdb_tpu_torch import resolver as PR
from foundationdb_tpu_torch.config import TEST_CONFIG, KernelConfig
from foundationdb_tpu_torch.models import conflict_set as PCS
from foundationdb_tpu_torch.models import types as PT
from foundationdb_tpu_torch.runtime import flow as PF
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import packing, probes
from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS as PORT_KNOBS

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

TEST_KW = dataclasses.asdict(TEST_CONFIG)
TIERED_KW = {**TEST_KW, "delta_capacity": 512, "compact_interval": 3}

#: (JAX backend, port backend): both kernels, both oracles
BACKENDS = {"kernel": ("tpu-force", "cuda"), "oracle": ("cpu", "cpu")}

#: the kernel block's entries that wall-clock time decides
WALL_KEYS = ("kernel_seconds_per_batch", "kernel_p99_seconds",
             "stage_p99_seconds", "compile_seconds", "compile_cache_hits",
             "compile_cache_misses", "last_compile_seconds",
             "collective_time_share")


class Side:
    """One package's scheduler and resolver, driven by neutral requests:
    txns as (reads, writes, snapshot, report, mutations) tuples."""

    def __init__(self, pkg: str, config_kw: dict, backend: str, **kw):
        self.pkg = pkg
        if pkg == "jax":
            self.T, self.F = JT, JF
            self.sched = JF.Scheduler(sim=True)
            self.res = JR.Resolver(self.sched, JaxConfig(**config_kw),
                                   backend=backend, **kw)
        else:
            self.T, self.F = PT, PF
            self.sched = PF.Scheduler(sim=True)
            self.res = PR.Resolver(self.sched, KernelConfig(**config_kw),
                                   backend=backend, device="cpu", **kw)

    def txn(self, reads=(), writes=(), snapshot=0, report=False,
            mutations=()):
        return self.T.CommitTransaction(
            read_conflict_ranges=list(reads),
            write_conflict_ranges=list(writes), read_snapshot=snapshot,
            report_conflicting_keys=report, mutations=list(mutations))

    def req(self, prev, version, txns=(), *, proxy="p0", last_received=0,
            state_idx=(), written_tags=frozenset()):
        return self.T.ResolveTransactionBatchRequest(
            prev_version=prev, version=version,
            last_received_version=last_received,
            transactions=[self.txn(*t) for t in txns],
            txn_state_transactions=list(state_idx), proxy_id=proxy,
            written_tags=frozenset(written_tags))

    def spawn(self, req):
        return self.sched.spawn(self.res.resolve(req))

    def run(self, tasks):
        self.sched.run_until(self.F.all_of([t.done for t in tasks]))
        return [t.done.get() for t in tasks]

    def resolve(self, req):
        return self.run([self.spawn(req)])[0]

    def bootstrap(self):
        return self.resolve(self.T.ResolveTransactionBatchRequest(
            prev_version=-1, version=0, last_received_version=-1,
            transactions=[]))


def summary(reply):
    """A reply as plain values (None for Never())."""
    if reply is None:
        return None
    return {
        "committed": [int(v) for v in reply.committed],
        "conflicting": {int(t): list(r) for t, r in
                        reply.conflicting_key_range_map.items()},
        "state": [[(bool(s.committed), list(s.mutations)) for s in group]
                  for group in reply.state_mutations],
        "private": {int(t): list(m)
                    for t, m in reply.private_mutations.items()},
        "tpcv": dict(reply.tpcv_map),
        "tags": sorted(reply.written_tags),
    }


def assert_same_role(jax: Side, port: Side) -> None:
    assert port.res.counters.as_dict() == jax.res.counters.as_dict()
    js, ps = jax.res.saturation(), port.res.saturation()
    jk, pk = js.pop("kernel"), ps.pop("kernel")
    assert ps == js
    assert set(pk) == set(jk)
    for key in WALL_KEYS:
        assert key in pk
    assert ({k: v for k, v in pk.items() if k not in WALL_KEYS}
            == {k: v for k, v in jk.items() if k not in WALL_KEYS})
    assert set(pk["stage_p99_seconds"]) == set(jk["stage_p99_seconds"])
    assert port.res.version.get() == jax.res.version.get()
    assert port.res.total_state_bytes == jax.res.total_state_bytes
    assert port.res.txn_state_store == jax.res.txn_state_store
    assert port.res.metrics() == jax.res.metrics()


def pair(backends: str, config_kw=TEST_KW, **kw):
    jb, pb = BACKENDS[backends]
    return (Side("jax", config_kw, jb, **kw),
            Side("port", config_kw, pb, **kw))


# ---------------------------------------------------------------------------
# the scenarios of tests/test_resolver.py, each a function of one side
# returning what it observed

def sc_simple_commit_then_conflict(s: Side):
    s.bootstrap()
    return [summary(s.resolve(s.req(0, 10, [((), [(b"a", b"b")], 5)]))),
            summary(s.resolve(s.req(10, 20, [([(b"a", b"b")], (), 5)]))),
            summary(s.resolve(s.req(20, 30, [([(b"a", b"b")], (), 20)])))]


def sc_version_chain_waits_for_prev(s: Side):
    s.bootstrap()
    order = []

    async def send(req, tag):
        out = await s.res.resolve(req)
        order.append(tag)
        return out

    t2 = s.sched.spawn(send(s.req(10, 20, [((), [(b"c", b"d")])]), "second"))
    t1 = s.sched.spawn(send(s.req(0, 10, [((), [(b"a", b"b")])]), "first"))
    outs = s.run([t1, t2])
    return [order, s.res.version.get()] + [summary(r) for r in outs]


def sc_duplicate_replays_cached_reply(s: Side):
    s.bootstrap()
    req = s.req(0, 10, [((), [(b"a", b"b")], 5)])
    r1 = s.resolve(req)
    r2 = s.resolve(req)
    return [summary(r1), r2 is r1, s.res.counters.get("resolveBatchStart"),
            s.res.counters.get("resolveBatchIn")]


def sc_acked_trimmed_then_never(s: Side):
    s.bootstrap()
    s.resolve(s.req(0, 10, [((), [(b"a", b"b")])]))
    s.resolve(s.req(10, 20, [((), [(b"c", b"d")])], last_received=10))
    info = s.res.proxy_info["p0"]
    return [sorted(info.outstanding_batches),
            summary(s.resolve(s.req(0, 10, [((), [(b"a", b"b")])])))]


def sc_too_old_through_role(s: Side):
    s.bootstrap()
    w = TEST_CONFIG.window_versions
    s.resolve(s.req(0, w + 100, [((), [(b"a", b"b")])]))
    r = s.resolve(s.req(w + 100, w + 200, [([(b"x", b"y")], (), 50)]))
    return [summary(r), s.res.counters.get("transactionsTooOld")]


STATE_MUT = ("set", b"\xffkey", b"value")
STATE_TXN = ((), [(b"\xffk", b"\xffl")], 0, False, [STATE_MUT])


def sc_state_forwarded_to_other_proxy(s: Side):
    s.bootstrap()
    out = [summary(s.resolve(s.req(0, 10, [STATE_TXN], proxy="A",
                                   state_idx=[0])))]
    out.append(summary(s.resolve(s.req(10, 20, [((), [(b"m", b"n")])],
                                       proxy="B"))))
    out.append(summary(s.resolve(s.req(20, 30, [((), [(b"o", b"p")])],
                                       proxy="A", last_received=10))))
    return out


def sc_state_trimmed_once_caught_up(s: Side):
    s.bootstrap()
    s.resolve(s.req(0, 10, [STATE_TXN], proxy="A", state_idx=[0]))
    size = s.res.recent_state.size
    s.resolve(s.req(10, 20, [((), [(b"m", b"n")])], proxy="B"))
    return [size, s.res.recent_state.size, s.res.total_state_bytes]


def sc_conflicting_key_range_report(s: Side):
    s.bootstrap()
    s.resolve(s.req(0, 10, [((), [(b"a", b"c")])]))
    r = s.resolve(s.req(10, 20, [([(b"x", b"y"), (b"a", b"b")], (), 5,
                                  True)]))
    return [summary(r)]


def sc_counters(s: Side):
    s.bootstrap()
    r = s.resolve(s.req(0, 10, [((), [(b"a", b"b")], 0),
                                ([(b"q", b"r")], [(b"q", b"r")], 0)]))
    return [summary(r), s.res.compute_time.count,
            s.res.resolver_latency.count]


def sc_key_sample_stays_bounded(s: Side):
    """80 batches of 60 distinct keys: past KEY_SAMPLE_LIMIT, so the
    sample decays (60 txns: the kernel backends take 64 a batch; the
    version step keeps two batches in the window, within the history
    capacity)."""
    prev = -1
    for i in range(80):
        version = (i + 1) * 500
        txns = [((), [(b"k%06d" % (i * 60 + j), b"k%06d\x00" % (i * 60 + j))])
                for j in range(60)]
        s.resolve(s.req(prev, version, txns, last_received=prev))
        prev = version
    return [len(s.res._key_sample), s.res.split_point(b"k", b"l", 0.5),
            s.res.split_point(b"k000100", b"k000200", 0.25)]


SCENARIOS = {
    "simple_commit_then_conflict": (sc_simple_commit_then_conflict, {}),
    "version_chain_waits_for_prev": (sc_version_chain_waits_for_prev, {}),
    "duplicate_replays_cached_reply": (sc_duplicate_replays_cached_reply,
                                       {}),
    "acked_trimmed_then_never": (sc_acked_trimmed_then_never, {}),
    "too_old_through_role": (sc_too_old_through_role, {}),
    "state_forwarded_to_other_proxy": (sc_state_forwarded_to_other_proxy,
                                       {"commit_proxy_count": 2}),
    "state_trimmed_once_caught_up": (sc_state_trimmed_once_caught_up,
                                     {"commit_proxy_count": 2}),
    "conflicting_key_range_report": (sc_conflicting_key_range_report, {}),
    "counters": (sc_counters, {}),
    "key_sample_stays_bounded": (sc_key_sample_stays_bounded,
                                 {"resolver_count": 2}),
}


@pytest.mark.parametrize("backends", sorted(BACKENDS))
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name, backends):
    fn, kw = SCENARIOS[name]
    jax, port = pair(backends, **kw)
    want = fn(jax)
    assert fn(port) == want
    assert_same_role(jax, port)


def test_scenarios_hold_the_reference_semantics():
    """The scenarios' observations are the ones tests/test_resolver.py
    asserts (the parity above would also hold two equal faults)."""
    jax, port = pair("kernel")
    c, k = int(JT.TransactionResult.COMMITTED), int(JT.TransactionResult.CONFLICT)
    r = sc_simple_commit_then_conflict(port)
    assert [x["committed"] for x in r] == [[c], [k], [c]]
    _, port = pair("kernel")
    order, version, *_ = sc_version_chain_waits_for_prev(port)
    assert order == ["first", "second"] and version == 20
    _, port = pair("kernel")
    _, same, starts, ins = sc_duplicate_replays_cached_reply(port)
    assert same and starts == 2 and ins == 3
    _, port = pair("kernel")
    assert sc_acked_trimmed_then_never(port) == [[20], None]
    _, port = pair("kernel", commit_proxy_count=2)
    ra, rb, ra2 = sc_state_forwarded_to_other_proxy(port)
    assert rb["state"] == [[], [(True, [STATE_MUT])]]
    assert ra2["state"] == [[]]
    _, port = pair("kernel")
    assert sc_conflicting_key_range_report(port)[0]["conflicting"] == {0: [1]}
    _, port = pair("oracle", resolver_count=2)
    n, sp, _ = sc_key_sample_stays_bounded(port)
    assert n <= PR.KEY_SAMPLE_LIMIT + 200 and b"k" <= sp <= b"l"


# ---------------------------------------------------------------------------
# seeded multi-proxy streams

def stream_requests(rng, n_batches: int, n_proxies: int, *,
                    max_txns: int = 24, keyspace: int = 40):
    """A version chain of requests from `n_proxies` proxies: point and
    short range reads and writes over a small keyspace (conflicts),
    snapshots from the batch before to far past the window (too old),
    blind writes, state transactions with set and clear mutations on
    the system keyspace, written tags, and each proxy acking what it
    has received."""
    def key(i):
        return b"k%03d" % i

    def rng_range():
        a = int(rng.integers(0, keyspace))
        return key(a), key(a + int(rng.integers(1, 4)))

    out, prev = [], 0
    last_seen = {}
    for i in range(n_batches):
        version = (i + 1) * 100
        proxy = f"p{int(rng.integers(0, n_proxies))}"
        txns, state_idx = [], []
        for t in range(int(rng.integers(1, max_txns + 1))):
            if rng.random() < 0.12:
                a = int(rng.integers(0, 8))
                muts = [("set", b"\xffconf/%d" % a, b"v%d" % i)]
                if rng.random() < 0.3:
                    muts.append(("clear", b"\xffconf/0", b"\xffconf/4"))
                if rng.random() < 0.3:
                    muts.append(("set", key(a), b"user"))
                txns.append(((), [(b"\xffconf/%d" % a, b"\xffconf/%d\x00" % a)],
                             version - 100, False, muts))
                state_idx.append(t)
                continue
            reads = [] if rng.random() < 0.2 else [
                rng_range() for _ in range(int(rng.integers(1, 3)))]
            writes = [rng_range() for _ in range(int(rng.integers(0, 3)))]
            lag = int(rng.choice([50, 150, 300, 2500]))
            txns.append((reads, writes, max(0, version - lag),
                         bool(rng.random() < 0.5)))
        tags = frozenset(int(x) for x in
                         rng.integers(0, 6, int(rng.integers(0, 3))))
        out.append(dict(prev=prev, version=version, txns=txns,
                        proxy=proxy, last_received=last_seen.get(proxy, 0),
                        state_idx=state_idx, written_tags=tags))
        last_seen[proxy] = version
        prev = version
    return out


def drive_stream(s: Side, reqs, rng_order):
    """Bootstrap, then spawn every request, shuffled with duplicates of
    a few (the request object again, in flight together), and run them
    to the end together; then duplicates of some more and of each
    proxy's last request (its reply not yet acked). The replies in
    spawn order, and which of the late duplicates were answered."""
    s.bootstrap()
    objs = [s.req(r["prev"], r["version"], r["txns"], proxy=r["proxy"],
                  last_received=r["last_received"],
                  state_idx=r["state_idx"], written_tags=r["written_tags"])
            for r in reqs]
    n = len(objs)
    order = [int(i) for i in rng_order.permutation(
        np.concatenate([np.arange(n), rng_order.choice(n, n // 8)]))]
    last = {r["proxy"]: i for i, r in enumerate(reqs)}
    dups = sorted({*(int(i) for i in rng_order.choice(n, n // 4)),
                   *last.values()})
    first = s.run([s.spawn(objs[i]) for i in order])
    again = s.run([s.spawn(objs[i]) for i in dups])
    return [summary(r) for r in first + again], [r is not None
                                                 for r in again]


@pytest.mark.parametrize("seed,n_proxies,knobs,config,limit", [
    (0, 2, (False, False), "classic", 10),
    (1, 3, (True, True), "classic", 1_000_000),
    (2, 2, (True, False), "tiered", 40),
    (3, 3, (False, True), "tiered", 400),
])
@pytest.mark.parametrize("backends", sorted(BACKENDS))
def test_seeded_multi_proxy_stream(monkeypatch, seed, n_proxies, knobs,
                                   config, limit, backends):
    """`limit` is the state memory limit: the small ones hold requests
    in the memory backpressure loop until the state is trimmed."""
    private, vector = knobs
    breached = probes.snapshot().get("resolver.backpressure_breached", 0)
    for knob_set in (JAX_KNOBS, PORT_KNOBS):
        monkeypatch.setattr(knob_set, "PROXY_USE_RESOLVER_PRIVATE_MUTATIONS",
                            private)
        monkeypatch.setattr(knob_set, "ENABLE_VERSION_VECTOR_TLOG_UNICAST",
                            vector)
    kw = TEST_KW if config == "classic" else TIERED_KW
    reqs = stream_requests(np.random.default_rng(seed), 40, n_proxies)
    jax, port = pair(backends, kw, commit_proxy_count=n_proxies,
                     num_logs=3, state_memory_limit=limit)
    want = drive_stream(jax, reqs, np.random.default_rng(seed + 100))
    got = drive_stream(port, reqs, np.random.default_rng(seed + 100))
    if limit <= 40:
        assert probes.snapshot()["resolver.backpressure_breached"] > breached
    assert got == want
    assert_same_role(jax, port)
    # the stream reaches what it is for
    replies = [r for r in want[0] if r is not None]
    flat = [v for r in replies for v in r["committed"]]
    assert {0, 1, 3} <= set(flat)  # conflicts, too old, commits
    assert any(r["state"] and any(g for g in r["state"]) for r in replies)
    assert any(want[1])  # duplicates replayed from the reply cache
    assert not all(want[1])  # and acked ones answered Never()
    if private:
        assert any(r["private"] for r in replies)
        assert port.res.txn_state_store
    if vector:
        assert any(r["tpcv"] for r in replies)


# ---------------------------------------------------------------------------
# the knob-routed construction, the gate and the router

@pytest.mark.parametrize("at_min", [False, True])
def test_knob_routed_resolver_matches_jax(monkeypatch, at_min):
    """backend None with the knob's device backend (JAX "tpu", port
    "cuda"): just under the min batch both route to the CPU oracle, at
    it both to their kernels, and the replies match either way."""
    n = TEST_CONFIG.max_txns
    monkeypatch.setattr(JAX_KNOBS, "RESOLVER_TPU_MIN_BATCH",
                        n if at_min else n + 1)
    monkeypatch.setattr(PORT_KNOBS, "RESOLVER_CUDA_MIN_BATCH",
                        n if at_min else n + 1)
    assert JAX_KNOBS.RESOLVER_BACKEND == "tpu"
    assert PORT_KNOBS.RESOLVER_BACKEND == "cuda"
    jax = Side("jax", TEST_KW, None)
    port = Side("port", TEST_KW, None)
    assert jax.res.conflict_set is None and port.res.conflict_set is None
    reqs = stream_requests(np.random.default_rng(5), 12, 1)
    want = drive_stream(jax, reqs, np.random.default_rng(6))
    assert drive_stream(port, reqs, np.random.default_rng(6)) == want
    assert_same_role(jax, port)
    kinds = (type(jax.res.conflict_set).__name__,
             type(port.res.conflict_set).__name__)
    assert kinds == (("TpuConflictSet", "TorchConflictSet") if at_min
                     else ("CpuConflictSet", "CpuConflictSet"))
    assert jax.res._profile == port.res._profile == "uniform"


@pytest.mark.parametrize("at_min", [False, True])
def test_knob_gate_of_the_factory(monkeypatch, at_min):
    """make_conflict_set(cfg, None) is JAX's make_conflict_set(cfg) with
    the knob's device backend; explicit "cuda" is never gated."""
    n = TEST_CONFIG.max_txns
    monkeypatch.setattr(JAX_KNOBS, "RESOLVER_TPU_MIN_BATCH",
                        n if at_min else n + 1)
    monkeypatch.setattr(PORT_KNOBS, "RESOLVER_CUDA_MIN_BATCH",
                        n if at_min else n + 1)
    jcs = JCS.make_conflict_set(JaxConfig(**TEST_KW))
    pcs = PCS.make_conflict_set(TEST_CONFIG, None, device="cpu")
    assert type(jcs).__name__ == ("TpuConflictSet" if at_min
                                  else "CpuConflictSet")
    assert type(pcs).__name__ == ("TorchConflictSet" if at_min
                                  else "CpuConflictSet")
    forced = PCS.make_conflict_set(TEST_CONFIG, "cuda", device="cpu")
    assert type(forced).__name__ == "TorchConflictSet"
    monkeypatch.setattr(PORT_KNOBS, "RESOLVER_BACKEND", "cpu")
    assert type(PCS.make_conflict_set(TEST_CONFIG, None)).__name__ == (
        "CpuConflictSet")


def test_route_stream_matches_jax(monkeypatch):
    """route_stream on uniform, hot-key and range-scan streams, at and
    under the min batch, answers JAX's ("tpu" read as "cuda")."""
    from foundationdb_tpu.testing import benchgen as jax_benchgen
    from foundationdb_tpu_torch.testing import benchgen

    kw = dict(max_key_bytes=8, max_txns=256, max_reads=256, max_writes=256,
              history_capacity=4096, window_versions=10_000)
    cases = {
        "uniform": {},
        "zipf": {"keyspace": 1000, "zipf": 1.1},
    }
    variants = [{}, {"delta_capacity": 1024, "dedup_reads": 64},
                {"delta_capacity": 1024, "range_sweep": True}]
    for limit in (256, 257):
        monkeypatch.setattr(JAX_KNOBS, "RESOLVER_TPU_MIN_BATCH", limit)
        monkeypatch.setattr(PORT_KNOBS, "RESOLVER_CUDA_MIN_BATCH", limit)
        for extra in variants:
            pc, jc = KernelConfig(**kw, **extra), JaxConfig(**kw, **extra)
            for name, gen_kw in cases.items():
                mk = dict(version=1000, keyspace=gen_kw.get("keyspace",
                                                            1 << 20),
                          snapshot_lag=100, key_bytes=8)
                if "zipf" in gen_kw:
                    mk["zipf"] = gen_kw["zipf"]
                pbs = [benchgen.skiplist_style_batch(
                    np.random.default_rng(i), pc, 256, **mk)
                    for i in range(2)]
                jbs = [jax_benchgen.skiplist_style_batch(
                    np.random.default_rng(i), jc, 256, **mk)
                    for i in range(2)]
                want = JCS.route_stream(jbs, jc)
                got = PCS.route_stream(pbs, pc)
                assert got == {"tpu": "cuda", "cpu": "cpu"}[want], (
                    limit, extra, name)
            ycsb = [benchgen.ycsb_batch(np.random.default_rng(3), pc, 256,
                                        "ycsb_e", version=1000,
                                        keyspace=10_000, scan_max=100,
                                        snapshot_lag=100, key_bytes=8)]
            jy = [jax_benchgen.ycsb_batch(np.random.default_rng(3), jc, 256,
                                          "ycsb_e", version=1000,
                                          keyspace=10_000, scan_max=100,
                                          snapshot_lag=100, key_bytes=8)]
            assert PCS.route_stream(ycsb, pc) == {
                "tpu": "cuda", "cpu": "cpu"}[JCS.route_stream(jy, jc)]


def test_the_device_is_never_hidden(monkeypatch):
    """Without a card: device=None raises where the card is chosen (an
    explicit "cuda" at construction, a routed "cuda" at the first batch
    the gate sends to the card); "cpu" and the gate's CPU route run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PR.Resolver(PF.Scheduler(sim=True), TEST_CONFIG, backend="cuda")
    monkeypatch.setattr(PORT_KNOBS, "RESOLVER_CUDA_MIN_BATCH", 1)
    sched = PF.Scheduler(sim=True)
    res = PR.Resolver(sched, TEST_CONFIG)
    t = sched.spawn(res.resolve(PT.ResolveTransactionBatchRequest(
        prev_version=-1, version=0, last_received_version=-1)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sched.run_until(t.done)
    monkeypatch.setattr(PORT_KNOBS, "RESOLVER_CUDA_MIN_BATCH", 1 << 20)
    sched = PF.Scheduler(sim=True)
    res = PR.Resolver(sched, TEST_CONFIG)
    t = sched.spawn(res.resolve(PT.ResolveTransactionBatchRequest(
        prev_version=-1, version=0, last_received_version=-1)))
    sched.run_until(t.done)
    assert type(res.conflict_set).__name__ == "CpuConflictSet"
    cpu = PR.Resolver(PF.Scheduler(sim=True), TEST_CONFIG, backend="cpu")
    assert type(cpu.conflict_set).__name__ == "CpuConflictSet"


def test_resolver_packs_what_jax_packs():
    """The port's Resolver and JAX's pack a request's transactions into
    the same kernel arguments (the role hands the conflict set what the
    JAX role hands the JAX one)."""
    jax, port = pair("kernel")
    reqs = stream_requests(np.random.default_rng(9), 3, 1)
    for r in reqs:
        jt = [jax.txn(*t) for t in r["txns"]]
        pt = [port.txn(*t) for t in r["txns"]]
        a = jax_packing.pack_batch(jt, r["version"], 0, JaxConfig(**TEST_KW))
        b = packing.pack_batch(pt, r["version"], 0, TEST_CONFIG)
        for k, v in a.device_args().items():
            assert np.array_equal(np.asarray(v), b.device_args()[k]), k
