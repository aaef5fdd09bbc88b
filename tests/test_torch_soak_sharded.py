"""api_correctness seed 8 on the device: the port's "cuda" against the
JAX "tpu-force", on the CPU (the port's plain PyTorch versions).

A seed with seed % 4 == 0 runs the tiered kernel on 2 keyspace shards
(kernels I and J on the card), and this one also draws knob_quorum:
dynamic-knob writes race through the ConfigNode quorum while a
coordinator is down, the broadcast copy is wiped and restored from the
quorum (cluster/config_db.py). Its signature is equal in both packages.

The JAX specs are built from their files with `tomllib` (the JAX
`load_spec` imports `tomli`, which this host lacks). The JAX test
process forces 8 virtual CPU devices (tests/conftest.py), so the JAX
soak's 2-shard seeds shard there as the port's always do.
"""

from __future__ import annotations

import tomllib

from foundationdb_tpu.testing import soak as JSK
from foundationdb_tpu.testing import spec as JS
from foundationdb_tpu_torch.models.conflict_set import TorchConflictSet
from foundationdb_tpu_torch.resolver import Resolver
from foundationdb_tpu_torch.testing import soak as PSK
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()


def jax_spec(name: str):
    with open(JS.SPEC_DIR / f"{name}.toml", "rb") as f:
        return JS.SoakSpec.from_dict(tomllib.load(f))


def device_seed(monkeypatch, name: str, seed: int):
    """Run one device seed through both packages: the JAX "tpu-force"
    and the port's "cuda" on the plain PyTorch versions. Returns (JAX
    signature, port signature, the configs of every port resolver of
    every epoch); fails unless each of those is a TorchConflictSet on
    the CPU."""
    assert PSK.plan_for_seed(seed, name).resolver_backend == "cuda"
    built = []
    init = Resolver.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        built.append(self)

    monkeypatch.setattr(Resolver, "__init__", record)
    p = PSK.run_seed(seed, spec=name, device="cpu")
    monkeypatch.undo()
    j = JSK.run_seed(seed, spec=jax_spec(name))
    assert built
    for r in built:
        assert isinstance(r.conflict_set, TorchConflictSet)
        assert r.conflict_set.device.type == "cpu"
    return j, p, [r.conflict_set.config for r in built]


def test_api_correctness_8_sharded_knob_quorum(monkeypatch):
    assert PSK.plan_for_seed(8, "api_correctness").knob_quorum
    j, p, cfgs = device_seed(monkeypatch, "api_correctness", 8)
    assert all(c.n_shards == 2 and c.dedup_reads > 0 for c in cfgs)
    assert p[1] > 0
    assert p == j
