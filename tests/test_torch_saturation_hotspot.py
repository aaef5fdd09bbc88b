"""The port's saturation ramp and hotspot gate against the JAX package's.

* `run_saturation` quick, with and without admission control: the
  port's "cpu" ramp equals the JAX ramp on its knob's route (the 64-txn
  configuration gates to the host oracle), and the port's "cuda" ramp
  (the plain PyTorch versions) equals the JAX ramp with the knob at
  "tpu-force"; ON passes the SLO gate and OFF violates it in both.
* `run_hotspot_sim`, zipf and uniform: the report equals JAX's.
* the wire legs are tests/test_torch_hotspot_wire.py's.

The JAX `load_saturation_config` and `load_hotspot_config` import
`tomli`, which this host lacks: the JAX side reads its spec's table with
`tomllib` here (the saturation loader monkeypatched, the hotspot runners
given `cfg=`).
"""

from __future__ import annotations

import tomllib

import pytest

import foundationdb_tpu.testing.hotspot as JHOT
import foundationdb_tpu.testing.saturation as JSAT
from foundationdb_tpu.testing import spec as JS
from foundationdb_tpu.utils.knobs import SERVER_KNOBS as J_KNOBS
from foundationdb_tpu_torch.testing import hotspot as PHOT
from foundationdb_tpu_torch.testing import saturation as PSAT
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()


def jax_table(spec: str, table: str, defaults: dict) -> dict:
    with open(JS.SPEC_DIR / f"{spec}.toml", "rb") as f:
        return {**defaults, **tomllib.load(f).get(table, {})}


@pytest.fixture
def jax_saturation(monkeypatch):
    monkeypatch.setattr(
        JSAT, "load_saturation_config",
        lambda spec_name="saturation": jax_table(
            spec_name, "saturation", JSAT.DEFAULTS))
    return JSAT


def test_configs_load_as_jax():
    assert PSAT.load_saturation_config() == jax_table(
        "saturation", "saturation", JSAT.DEFAULTS)
    assert PHOT.load_hotspot_config() == jax_table(
        "hotspot", "hotspot", JHOT.DEFAULTS)
    cfg = PHOT.load_hotspot_config()
    for seed in (0, 5):
        for skewed in (True, False):
            assert (PHOT.plan_workload(seed, skewed, cfg)
                    == JHOT.plan_workload(seed, skewed, cfg))


@pytest.mark.parametrize("admission", [True, False], ids=["on", "off"])
def test_saturation_cpu_equals_jax_knob_route(jax_saturation, admission):
    j = jax_saturation.run_saturation(admission=admission, quick=True)
    p = PSAT.run_saturation(admission=admission, quick=True,
                            resolver_backend="cpu")
    assert p == j
    assert p["slo"]["passed"] is admission


@pytest.mark.parametrize("admission", [True, False], ids=["on", "off"])
def test_saturation_cuda_equals_jax_tpu_force(jax_saturation, admission):
    try:
        J_KNOBS.set("RESOLVER_BACKEND", "tpu-force")
        j = jax_saturation.run_saturation(admission=admission, quick=True)
    finally:
        J_KNOBS.reset()
    p = PSAT.run_saturation(admission=admission, quick=True, device="cpu")
    assert p == j
    assert p["slo"]["passed"] is admission
    if admission:
        # with admission the ramp never outgrows the kernel's 64-txn
        # batches: the device report is the knob route's too
        assert p == jax_saturation.run_saturation(admission=True, quick=True)


@pytest.mark.parametrize("skewed", [True, False], ids=["zipf", "uniform"])
def test_hotspot_sim_leg_equals_jax(skewed):
    cfg = jax_table("hotspot", "hotspot", JHOT.DEFAULTS)
    j = JHOT.run_hotspot_sim(skewed=skewed, quick=True, cfg=cfg)
    p = PHOT.run_hotspot_sim(skewed=skewed, quick=True, device="cpu")
    assert p == j
    assert p["ok"]
