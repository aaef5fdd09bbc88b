"""The harness of the feature twins: the features beside the commit path
(tenants, the metacluster, DR, multi-region failover, parallel restore,
the blob store, blob granules, the layers, the multiversion client and
the cli), held between the JAX package and the port on the CPU.

A scenario is written once against a package namespace (`w.P.dr`,
`w.P.tenant`, ... from either `foundationdb_tpu` or
`foundationdb_tpu_torch`) and a `World` that opens the scenario's
clusters on one backend. `check_twin` runs it as the JAX package and as
the port, as two pairs of backends: JAX "cpu" against the port's "cpu"
(the host oracle), and JAX "tpu-force" (its kernels on the CPU) against
the port's "cuda" with device="cpu" (the plain PyTorch versions of the
kernels). The two runs' digests must be equal: every result the
scenario returns, every storage snapshot of every cluster it opened,
the final virtual time, the unhandled actor errors and the probes hit
(each package's own registry, counted over the run; the wall clock's
watchdog and JAX's persistent compile cache misses left out). Each
resolver of
every cluster must be the pair's conflict set.

This module is a helper of the test files; it holds no test.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import shutil
import tempfile
import types

JAX = "foundationdb_tpu"
PORT = "foundationdb_tpu_torch"

#: (the JAX package's backend, the port's backend) of each pair
PAIRS = (("cpu", "cpu"), ("tpu-force", "cuda"))
PAIR_IDS = ("cpu-cpu", "tpu_force-cuda")

#: each pair's conflict-set class, by package
SET_CLASS = {(JAX, "cpu"): "CpuConflictSet",
             (JAX, "tpu-force"): "TpuConflictSet",
             (PORT, "cpu"): "CpuConflictSet",
             (PORT, "cuda"): "TorchConflictSet"}

_MODULES = {
    "database": "cluster.database",
    "commit_proxy": "cluster.commit_proxy",
    "consistency": "cluster.consistency",
    "backup": "cluster.backup",
    "tenant": "cluster.tenant",
    "metacluster": "cluster.metacluster",
    "dr": "cluster.dr",
    "multiregion": "cluster.multiregion",
    "restore": "cluster.restore",
    "blob_store": "cluster.blob_store",
    "blob_granules": "cluster.blob_granules",
    "multiversion": "cluster.multiversion",
    "multiprocess": "cluster.multiprocess",
    "transport": "wire.transport",
    "tuple": "layers.tuple",
    "directory": "layers.directory",
    "taskbucket": "layers.taskbucket",
    "cli": "cli",
    "atomic": "utils.atomic",
    "probes": "utils.probes",
    "flow": "runtime.flow",
}


def ns(pkg: str) -> types.SimpleNamespace:
    """The package's modules under one namespace."""
    return types.SimpleNamespace(
        name=pkg,
        **{k: importlib.import_module(f"{pkg}.{m}")
           for k, m in _MODULES.items()},
    )


def norm(x):
    """A package-independent form of a value: dataclasses by class name
    and fields, enums by value, errors by class name."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple(
            (f.name, norm(getattr(x, f.name))) for f in dataclasses.fields(x)
        ))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, BaseException):
        return ("error", type(x).__name__)
    if isinstance(x, dict):
        return ("dict", tuple((norm(k), norm(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(norm(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted((norm(v) for v in x), key=repr)))
    return x


async def outcome(coro):
    """A coroutine's result, or its error's class name."""
    try:
        return ("ok", await coro)
    except Exception as e:  # noqa: BLE001 - the class is the result
        return ("err", type(e).__name__)


class World:
    """One run of a scenario: the package, its backend, the clusters the
    scenario opened (on one scheduler or several) and a scratch
    directory of its own."""

    def __init__(self, pkg: str, backend: str):
        self.P = ns(pkg)
        self.backend = backend
        self.clusters = []
        self.scheds = []
        self._tmp = None

    @property
    def port(self) -> bool:
        return self.P.name == PORT

    @property
    def tmp(self) -> str:
        """A short scratch directory (Unix socket paths fit in it)."""
        if self._tmp is None:
            self._tmp = tempfile.mkdtemp(prefix="tw")
        return self._tmp

    def config(self, **kw):
        """A ClusterConfig on this run's backend (the port's on the CPU)."""
        kw["resolver_backend"] = self.backend
        if self.port:
            kw["device"] = "cpu"
        return self.P.database.ClusterConfig(**kw)

    def scheduler(self):
        sched = self.P.flow.Scheduler(sim=True)
        self.scheds.append(sched)
        return sched

    def open(self, sched=None, **kw):
        """open_cluster on this run's backend; the cluster is stopped and
        digested at the end of the run."""
        sched, cluster, db = self.P.database.open_cluster(
            self.config(**kw), sched=sched)
        if sched not in self.scheds:
            self.scheds.append(sched)
        self.clusters.append(cluster)
        return sched, cluster, db

    @staticmethod
    def run(sched, coro):
        t = sched.spawn(coro, name="drive")
        sched.run_until(t.done)
        return t.done.get()

    def sets(self) -> set:
        return {type(r.conflict_set).__name__
                for c in self.clusters for r in c.resolvers}

    def digest(self, results, hits) -> dict:
        return {
            "results": norm(results),
            "storage": [[norm(ss.snapshot()) for ss in c.storage_servers]
                        for c in self.clusters],
            "now": [s.now() for s in self.scheds],
            "unhandled": [sorted((n, type(e).__name__)
                                 for n, e in s.unhandled_errors())
                          for s in self.scheds],
            "probes": hits,
        }

    def close(self) -> None:
        for c in self.clusters:
            c.stop()
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)


#: probes that are not the schedule's, left out: the wall clock's
#: watchdog, and the JAX package's persistent compile cache missing
#: (`perf.compile_cache_miss`, fired by its process-wide listener once an
#: earlier test in the process turned the cache on, at the process's
#: first compile of a shape; the port compiles nothing at run time)
WALL_PROBES = {"runtime.slow_task", "perf.compile_cache_miss"}


def hits_between(before: dict, after: dict) -> dict:
    """The probes that fired between two snapshots, with their counts."""
    return {n: c - before.get(n, 0) for n, c in sorted(after.items())
            if c - before.get(n, 0) and n not in WALL_PROBES}


def run_scenario(pkg: str, backend: str, body) -> tuple[dict, set]:
    """Run `body(w)` as `pkg` on `backend`; its digest and the
    conflict-set classes of every cluster it opened."""
    w = World(pkg, backend)
    before = w.P.probes.snapshot()
    try:
        results = body(w)
        hits = hits_between(before, w.P.probes.snapshot())
        return w.digest(results, hits), w.sets()
    finally:
        w.close()


def check_twin(body, pair) -> dict:
    """Run `body` as the JAX package and as the port on `pair`; fail
    unless the digests are equal and every resolver is the pair's
    conflict set. Returns the port's digest."""
    jax_backend, port_backend = pair
    jax_digest, jax_sets = run_scenario(JAX, jax_backend, body)
    port_digest, port_sets = run_scenario(PORT, port_backend, body)
    assert jax_sets <= {SET_CLASS[(JAX, jax_backend)]}, jax_sets
    assert port_sets == ({SET_CLASS[(PORT, port_backend)]} if jax_sets
                         else set()), port_sets
    for key in jax_digest:
        assert port_digest[key] == jax_digest[key], (
            (key, port_digest[key], jax_digest[key]) if key == "probes"
            else key)
    return port_digest


def check_packages(body) -> dict:
    """Run `body(w)` (no cluster) as each package; fail unless the
    results are equal. Returns the port's."""
    got = {}
    for pkg in (JAX, PORT):
        w = World(pkg, None)
        try:
            got[pkg] = norm(body(w))
        finally:
            w.close()
    assert got[PORT] == got[JAX]
    return got[PORT]
