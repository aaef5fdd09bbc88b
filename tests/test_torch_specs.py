"""The port's soak specs against the JAX package's.

* every port spec (foundationdb_tpu_torch/testing/specs/*.toml) equals
  its JAX twin field for field, the JAX "tpu-force" spelled "cuda";
* `plan_for_seed` gives the same plan in both packages for seeds 0-63
  of every spec, and the knob randomization draws the same values;
* the port's analogs of tests/test_specs.py: round trips, malformed
  specs refused, probability extremes, the auditor on everywhere, every
  fault class alive, probe budgets;
* the port's probe manifest is the set of probes the port declares,
  each named in the JAX manifest, and every probe a spec expects is in
  it; the probe registry's reset, missed and merge.

The JAX specs are read with `tomllib` and built with
`SoakSpec.from_dict`: the JAX `load_spec` imports `tomli`, which this
host lacks, and passes a SoakSpec through.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
import tomllib
from pathlib import Path

import numpy as np
import pytest

from foundationdb_tpu.testing import soak as JSK
from foundationdb_tpu.testing import spec as JS
from foundationdb_tpu.utils.knobs import SERVER_KNOBS as J_KNOBS
from foundationdb_tpu_torch.drills.soak import load_manifest
from foundationdb_tpu_torch.testing import soak as PSK
from foundationdb_tpu_torch.testing import spec as PS
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import probes
from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS as P_KNOBS

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

ROOT = Path(__file__).resolve().parents[1]
SPECS = PS.list_specs()


def jax_spec(name: str):
    with open(JS.SPEC_DIR / f"{name}.toml", "rb") as f:
        return JS.SoakSpec.from_dict(tomllib.load(f))


def port_spelling(obj):
    """A JAX spec value as the port spells it: "tpu-force" is "cuda"; the
    range_heavy description drops the JAX project's ticket tag (an
    upper-case word, a dash and a number)."""
    if isinstance(obj, str):
        return re.sub(r"\b[A-Z]+-\d+ ", "", obj.replace("tpu-force", "cuda"))
    if isinstance(obj, dict):
        return {k: port_spelling(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(port_spelling(v) for v in obj)
    return obj


def test_spec_inventory_is_jaxs():
    assert SPECS == JS.list_specs()
    assert len(SPECS) == 10


@pytest.mark.parametrize("name", SPECS)
def test_spec_equals_jax_twin(name):
    port = PS.load_spec(name)
    assert port.to_dict() == port_spelling(jax_spec(name).to_dict())
    # every field but the description is the JAX one with only the
    # backend respelled
    assert port.topology == jax_spec(name).topology
    assert port.faults == jax_spec(name).faults
    assert port.workloads == jax_spec(name).workloads
    assert port.expected_probes == jax_spec(name).expected_probes
    assert port.probe_budgets == jax_spec(name).probe_budgets
    # the [saturation] / [hotspot] tables the drills read
    with open(PS.SPEC_DIR / f"{name}.toml", "rb") as f:
        p_raw = tomllib.load(f)
    with open(JS.SPEC_DIR / f"{name}.toml", "rb") as f:
        j_raw = tomllib.load(f)
    for table in ("saturation", "hotspot"):
        assert p_raw.get(table) == j_raw.get(table)


@pytest.mark.parametrize("name", SPECS)
def test_plans_equal_jax_for_seeds_0_to_63(name):
    pspec, jspec = PS.load_spec(name), jax_spec(name)
    for seed in range(64):
        p = dataclasses.asdict(PSK.plan_for_seed(seed, name))
        j = port_spelling(dataclasses.asdict(JSK.plan_for_seed(seed, jspec)))
        assert p == j, seed
        assert PS.derive_plan_fields(seed, pspec) == port_spelling(
            JS.derive_plan_fields(seed, jspec))


def test_device_seeds_and_their_features():
    """The seeds the ensemble runs on the device, and the features they
    draw, as the JAX package draws them."""
    cuda = {name: [s for s in range(16)
                   if PSK.plan_for_seed(s, name).resolver_backend == "cuda"]
            for name in ("api_correctness", "range_heavy", "ycsb_d")}
    want = [1, 3, 5, 6, 8, 10, 11, 13, 15]
    assert cuda == {"api_correctness": want, "range_heavy": want,
                    "ycsb_d": want}
    assert PSK.plan_for_seed(6, "api_correctness").backup_restore
    assert PSK.plan_for_seed(8, "api_correctness").knob_quorum


def test_knob_randomization_draws_as_jax():
    try:
        for seed in range(100):
            rng_j = np.random.default_rng(seed ^ 0xBADC0DE)
            rng_p = np.random.default_rng(seed ^ 0xBADC0DE)
            assert (P_KNOBS.randomize_under_test(rng_p)
                    == J_KNOBS.randomize_under_test(rng_j)), seed
            # and the streams stay in step for what draws next
            assert rng_p.random() == rng_j.random()
            P_KNOBS.reset()
            J_KNOBS.reset()
    finally:
        P_KNOBS.reset()
        J_KNOBS.reset()


@pytest.mark.parametrize("name", SPECS)
def test_spec_roundtrips(name):
    spec = PS.load_spec(name)
    assert spec.name == name and spec.description
    again = PS.SoakSpec.from_dict(spec.to_dict())
    assert again == spec and again.to_dict() == spec.to_dict()


def test_every_fault_class_covered_by_some_spec():
    alive = set()
    for name in SPECS:
        spec = PS.load_spec(name)
        alive |= {f for f in PS.FAULT_FIELDS if spec.faults[f] > 0}
    assert alive == set(PS.FAULT_FIELDS)


def test_every_spec_arms_the_interleaving_auditor():
    for name in SPECS:
        assert PS.load_spec(name).policy["audit"] is True, name


def test_probability_extremes_are_honored():
    spec = PS.load_spec("default")
    on = dataclasses.replace(spec, faults={f: 1.0 for f in spec.faults})
    off = dataclasses.replace(spec, faults={f: 0.0 for f in spec.faults})
    for seed in (0, 7, 33):
        a = PS.derive_plan_fields(seed, on.validate())
        b = PS.derive_plan_fields(seed, off.validate())
        assert all(a[f] for f in PS.FAULT_FIELDS)
        assert not any(b[f] for f in PS.FAULT_FIELDS)
        assert a["n_storage"] == b["n_storage"]
        assert a["rounds"] == b["rounds"]
        assert a["resolver_backend"] == b["resolver_backend"]
        # the JAX package draws the same under the same edit
        jspec = jax_spec("default")
        ja = JS.derive_plan_fields(seed, dataclasses.replace(
            jspec, faults={f: 1.0 for f in jspec.faults}).validate())
        assert a == port_spelling(ja)


@pytest.mark.parametrize("edit", [
    lambda d: d["faults"].__setitem__("kill_proxy", 1.5),
    lambda d: d["faults"].__setitem__("warp_drive", 0.5),
    lambda d: d["topology"].__setitem__("storage", [3, 2]),
    lambda d: d["policy"].__setitem__("resolver_backends", ["gpu"]),
    # the JAX spelling is not the port's
    lambda d: d["policy"].__setitem__("resolver_backends", ["tpu-force"]),
    lambda d: d["policy"].__setitem__("resolver_backends", ["tpu"]),
    lambda d: d["policy"].pop("audit"),
    lambda d: d["policy"].__setitem__("audit", "yes"),
    lambda d: d["policy"].__setitem__("kernel_range_sweep", 1),
    lambda d: d["workloads"].__setitem__("api_rounds", 0),
    lambda d: d["workloads"].__setitem__("ycsb_d", 2.0),
    lambda d: d["probes"].__setitem__(
        "budgets", {"workload.no_such_probe": 0.02}),
    lambda d: d["probes"].__setitem__(
        "budgets", {"workload.api_unknown_resolved": 0.0}),
], ids=["probability", "unknown-fault", "inverted-range", "gpu", "tpu-force",
        "tpu", "no-audit", "audit-str", "sweep-int", "api-rounds",
        "ycsb-d", "budget-name", "budget-zero"])
def test_malformed_specs_are_refused(edit):
    d = PS.load_spec("api_correctness").to_dict()
    edit(d)
    with pytest.raises(PS.SpecError):
        PS.SoakSpec.from_dict(d)


def test_unknown_and_misnamed_specs_are_refused(tmp_path, monkeypatch):
    with pytest.raises(PS.SpecError, match="no such spec"):
        PS.load_spec("no_such_spec")
    text = (PS.SPEC_DIR / "smoke.toml").read_text()
    (tmp_path / "other.toml").write_text(text)
    monkeypatch.setattr(PS, "SPEC_DIR", tmp_path)
    with pytest.raises(PS.SpecError, match="must match the file stem"):
        PS.load_spec("other")


def test_probe_budgets_gate_as_jax():
    spec, jspec = PS.load_spec("api_correctness"), jax_spec("api_correctness")
    for n in (1, 10, 149, 150, 300):
        assert spec.gated_probes(n) == jspec.gated_probes(n)
    rare = "workload.api_unknown_resolved"
    assert rare not in spec.gated_probes(149)
    assert rare in spec.gated_probes(150)


def _port_declared() -> dict:
    found = {}
    for p in sorted((ROOT / "foundationdb_tpu_torch").rglob("*.py")):
        for n in ast.walk(ast.parse(p.read_text())):
            if (isinstance(n, ast.Call)
                    and getattr(n.func, "id", None) == "declare"):
                for a in n.args:
                    if isinstance(a, ast.Constant) and isinstance(a.value,
                                                                  str):
                        found.setdefault(
                            a.value, str(p.relative_to(ROOT)))
    return found


def test_probe_manifest_is_the_ports_declares():
    manifest = load_manifest()
    assert manifest == _port_declared()
    jax = json.loads((ROOT / "foundationdb_tpu" / "analysis"
                      / "probe_manifest.json").read_text())["probes"]
    assert set(manifest) <= set(jax)
    assert all(f.startswith("foundationdb_tpu_torch/")
               for f in manifest.values())


@pytest.mark.parametrize("name", SPECS)
def test_spec_expected_probes_are_declared(name):
    unknown = set(PS.load_spec(name).expected_probes) - set(load_manifest())
    assert not unknown, sorted(unknown)


def test_probe_registry_reset_missed_merge():
    before = probes.snapshot()
    try:
        probes.declare("selftest.a", "selftest.b")
        probes.reset()
        assert {"selftest.a", "selftest.b"} <= set(probes.missed())
        probes.code_probe(True, "selftest.a")
        assert "selftest.a" not in probes.missed()
        probes.merge({"selftest.b": 2, "selftest.c": 1})
        snap = probes.snapshot()
        assert (snap["selftest.a"], snap["selftest.b"],
                snap["selftest.c"]) == (1, 2, 1)
        probes.reset()
        assert all(v == 0 for v in probes.snapshot().values())
    finally:
        probes.reset()
        probes.merge(before)
