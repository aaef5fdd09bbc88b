"""The hotspot gate's wire legs: port role processes against JAX's.

`run_hotspot_wire` spawns a resolver, a tlog and a storage process and
drives a ProxyPipeline over them with the drill's zipf or uniform tenant
mix. The port's roles (the resolver "cuda" with device "cpu" at a small
RESOLVER_KERNEL, every child at one thread) reach the JAX roles' verdict
on the same seed: the wire legs seed their byte samples from wall
entropy, so only the verdict and the commit count compare. The JAX
runner is given `cfg=` (its loader imports `tomli`, which this host
lacks).
"""

from __future__ import annotations

import tomllib

import pytest

import foundationdb_tpu.testing.hotspot as JHOT
from foundationdb_tpu.testing import spec as JS
from foundationdb_tpu_torch.testing import hotspot as PHOT
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()


def jax_table(spec: str, table: str, defaults: dict) -> dict:
    with open(JS.SPEC_DIR / f"{spec}.toml", "rb") as f:
        return {**defaults, **tomllib.load(f).get(table, {})}


@pytest.mark.parametrize("skewed", [True, False], ids=["zipf", "uniform"])
def test_hotspot_wire_leg_verdict_equals_jax(monkeypatch, skewed):
    monkeypatch.setenv(
        "RESOLVER_KERNEL",
        "KernelConfig(max_key_bytes=16, max_txns=64, max_reads=256, "
        "max_writes=256, history_capacity=1 << 12, "
        "window_versions=5_000_000)")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = jax_table("hotspot", "hotspot", JHOT.DEFAULTS)
    p = PHOT.run_hotspot_wire(skewed=skewed, quick=True, device="cpu")
    j = JHOT.run_hotspot_wire(skewed=skewed, quick=True, cfg=cfg)
    assert (p["ok"], p["why"], p["attribution"]["attributed"]) == (
        j["ok"], j["why"], j["attribution"]["attributed"])
    assert p["ok"] and p["committed"] == j["committed"]
