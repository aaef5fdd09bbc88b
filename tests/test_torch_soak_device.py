"""Device seeds of the soak ensemble: the port's "cuda" against the JAX
"tpu-force", on the CPU (the port's plain PyTorch versions).

Seeds that draw the device backend resolve through the conflict kernels
inside the whole fault mix. Each seed's signature (outcome counts,
virtual end time, epoch, final keys, api counts) is equal in both
packages:

* api_correctness 1: the classic kernel (an odd seed);
* api_correctness 6: the tiered kernel with read dedup and compaction
  every 2 batches, and the backup_restore fault (snapshot and log
  backup through the chaos, restored into a fresh cluster on the same
  backend and compared);
* ycsb_d 6: the tiered kernel under the read-latest workload.

api_correctness 8 (2 shards, knob_quorum) is test_torch_soak_sharded.py's
and range_heavy 8 (the sweep with spill, 2 shards) test_torch_soak_sweep.py's.

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


def test_api_correctness_1_classic(monkeypatch):
    j, p, cfgs = device_seed(monkeypatch, "api_correctness", 1)
    assert all(c.delta_capacity == 0 and c.n_shards == 0 for c in cfgs)
    assert p[1] > 0 and p[7] is not None
    assert p == j


def test_api_correctness_6_tiered_dedup_backup(monkeypatch):
    plan = PSK.plan_for_seed(6, "api_correctness")
    assert plan.backup_restore
    j, p, cfgs = device_seed(monkeypatch, "api_correctness", 6)
    # the seed's own resolvers, then the restore target's (default shape)
    assert any(c.dedup_reads > 0 and c.compact_interval == 2
               and c.n_shards == 0 for c in cfgs)
    assert any(c.dedup_reads == 0 for c in cfgs)
    assert p == j


def test_ycsb_d_6_tiered(monkeypatch):
    assert PSK.plan_for_seed(6, "ycsb_d").ycsb_d
    j, p, cfgs = device_seed(monkeypatch, "ycsb_d", 6)
    assert any(c.dedup_reads > 0 and c.compact_interval == 2 for c in cfgs)
    assert all(c.n_shards == 0 for c in cfgs)
    assert p == j
