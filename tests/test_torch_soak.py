"""The port's soak ensemble against the JAX one, on the host backend.

`run_seed` (testing/soak.py) runs one seed of a spec: the cluster shape,
knobs and fault mix the spec draws, the workload's model checks, the
ApiCorrectness cross-check, the consistency check. Here seeds that draw
the "cpu" backend (the host oracle) run through both packages and their
signatures are equal: outcome counts, virtual end time, epoch, final
keys, api counts, and with `trace=True` the trace digest (the status
probe and the census armed too). Each self-test hook fails the port's
seed as it fails the JAX one's, and every resolver of every epoch is the
backend the plan drew. The seeds that draw the device backend are
tests/test_torch_soak_device.py's and test_torch_soak_sharded.py's.

The JAX specs are built from their files with `tomllib` (the JAX
`load_spec` imports `tomli`, which this host lacks).
"""

from __future__ import annotations

import tomllib

import pytest

from foundationdb_tpu.testing import soak as JSK
from foundationdb_tpu.testing import spec as JS
from foundationdb_tpu_torch.models.conflict_set import (
    CpuConflictSet,
    TorchConflictSet,
)
from foundationdb_tpu_torch.resolver import Resolver
from foundationdb_tpu_torch.testing import soak as PSK
from foundationdb_tpu_torch.testing.spec import load_spec
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()


def jax_spec(name: str):
    with open(JS.SPEC_DIR / f"{name}.toml", "rb") as f:
        return JS.SoakSpec.from_dict(tomllib.load(f))


def both(seed: int, name: str, **kw):
    """(JAX signature, port signature) of one seed; the port's seed runs
    the cuda backend's plain versions where the plan draws it."""
    j = JSK.run_seed(seed, spec=jax_spec(name), **kw)
    p = PSK.run_seed(seed, spec=name, device="cpu", **kw)
    return j, p


CPU_SEEDS = ([("smoke", s) for s in range(4)]
             + [("default", s) for s in (0, 1, 6)]
             + [("saturation", 2), ("hotspot", 3), ("storage_stress", 1)])


@pytest.mark.parametrize("name,seed", CPU_SEEDS,
                         ids=[f"{n}-{s}" for n, s in CPU_SEEDS])
def test_cpu_seed_equals_jax(name, seed):
    assert PSK.plan_for_seed(seed, name).resolver_backend == "cpu"
    j, p = both(seed, name)
    assert p[1] > 0  # the seed committed work
    assert p == j


@pytest.mark.parametrize("kw", [
    {"trace": True, "status_probe": True},
    {"trace": True, "status_probe": True, "perturb": 1},
    {"trace": True, "census": True},
], ids=["trace-status", "trace-status-perturb", "trace-census"])
def test_traced_seed_digest_equals_jax(kw):
    j, p = both(7, "smoke", **kw)
    assert len(p) == 10 and p[8] == j[8]  # the trace digest
    assert p == j
    # rerun-identical, digest included
    assert PSK.run_seed(7, spec="smoke", device="cpu", **kw) == p


def test_signature_metrics_names_the_fields():
    p = PSK.run_seed(7, spec="smoke", device="cpu", trace=True)
    m = PSK.signature_metrics(p)
    assert (m["seed"], m["committed"], m["epoch"]) == (7, p[1], p[5])
    assert m["trace_digest"] == p[8] and m["traced_commits"] == p[9]
    assert m == JSK.signature_metrics(p)


def _resolvers(monkeypatch) -> list:
    """Every port Resolver built from here on (each epoch's recruits)."""
    built = []
    init = Resolver.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        built.append(self)

    monkeypatch.setattr(Resolver, "__init__", record)
    return built


def test_every_resolver_of_a_cpu_seed_is_the_host_oracle(monkeypatch):
    """default seed 2 kills a proxy: the recovery recruits a second
    epoch's resolvers, on the host oracle like the first's."""
    plan = PSK.plan_for_seed(2, "default")
    assert plan.resolver_backend == "cpu" and plan.kill_proxy
    built = _resolvers(monkeypatch)
    sig = PSK.run_seed(2, spec="default", device="cpu")
    assert sig[5] >= 2
    assert len(built) >= 2 * plan.n_resolvers
    assert all(isinstance(r.conflict_set, CpuConflictSet) for r in built)


def test_every_resolver_of_a_cuda_seed_is_the_port_set(monkeypatch):
    """A device seed with a proxy kill (ycsb_d 15, shortened): every
    resolver of both epochs, and none other, is a TorchConflictSet on
    the asked device. Holding the port's signature equal to JAX's on the
    unshortened seeds is test_torch_soak_device.py's."""
    spec = load_spec("ycsb_d").with_overrides(rounds=(6, 8), api_rounds=4)
    plan = PSK.plan_for_seed(15, spec)
    assert plan.resolver_backend == "cuda" and plan.kill_proxy
    built = _resolvers(monkeypatch)
    sig = PSK.run_seed(15, spec=spec, device="cpu")
    assert sig[5] >= 2
    assert len(built) >= 2 * plan.n_resolvers
    for r in built:
        assert isinstance(r.conflict_set, TorchConflictSet)
        assert r.conflict_set.device.type == "cpu"


def test_a_cuda_seed_without_a_card_raises(monkeypatch):
    """device=None is the card: a device seed does not fall back to the
    CPU where there is none."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seed = next(s for s in range(16)
                if PSK.plan_for_seed(s, "ycsb_d").resolver_backend == "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PSK.run_seed(seed, spec="ycsb_d")


async def _boom(sched, cluster, db):
    await sched.delay(0.1)
    raise RuntimeError("injected unhandled actor error")


@pytest.mark.parametrize("kw,match", [
    ({"_inject_fault": _boom}, "unhandled actor error"),
    ({"_corrupt_api": True}, "api model divergence"),
    ({"_inject_race": True}, "interleaving conflict"),
    ({"_corrupt_trace": True, "trace": True}, "span-chain violation"),
], ids=["inject-fault", "corrupt-api", "inject-race", "corrupt-trace"])
def test_self_test_hooks_fail_the_seed_as_jax(kw, match):
    """Each gate's self-test fails the port's seed as it fails the JAX
    one's (smoke seed 1: the api workload on, the auditor armed), and
    the same seed without the hook passes in both."""
    with pytest.raises(AssertionError, match=match):
        JSK.run_seed(1, spec=jax_spec("smoke"), **kw)
    with pytest.raises(AssertionError, match=match):
        PSK.run_seed(1, spec="smoke", device="cpu", **kw)
    j, p = both(1, "smoke")
    assert p == j


def test_race_self_test_needs_the_auditor():
    """With the spec's auditor off, the injected race passes in both
    packages (nothing else can see the lost update)."""
    import dataclasses

    pspec = load_spec("smoke")
    jspec = jax_spec("smoke")
    p_off = dataclasses.replace(
        pspec, policy={**pspec.policy, "audit": False})
    j_off = dataclasses.replace(
        jspec, policy={**jspec.policy, "audit": False})
    p = PSK.run_seed(1, spec=p_off, device="cpu", _inject_race=True)
    j = JSK.run_seed(1, spec=j_off, _inject_race=True)
    assert p == j


def test_collect_probes_resets_per_seed():
    p1, hits1 = PSK.run_seed(2, spec="smoke", device="cpu",
                             collect_probes=True)
    p2, hits2 = PSK.run_seed(2, spec="smoke", device="cpu",
                             collect_probes=True)
    assert p1 == p2
    # runtime.slow_task is the wall clock's watchdog, not the schedule's
    hits1.pop("runtime.slow_task", None)
    hits2.pop("runtime.slow_task", None)
    assert hits1 == hits2 and any(hits1.values())
