"""The port's perf ledger (`foundationdb_tpu_torch/utils/perf.py`) against
the JAX package's (`foundationdb_tpu/utils/perf.py`), twins of
tests/test_perf.py:48-230, :399, :411 and :453-472.

The same inputs go through both packages' functions. Records are equal
except the fingerprint's version keys (the port's `torch_version` and
`cuda_version` where JAX's has `jax_version` and `jaxlib_version`):

* round trip through a ledger file, live fingerprints, malformed records
  refused with the same message (one parametrised test), an invalid row
  never appended, a corrupt ledger refused, `FDBTPU_PERF_LEDGER` and
  `FDBTPU_PERF_DIR` redirection, the default ledger the port's own;
* baseline windows and the comparator in both directions, the
  structural tier exact, mismatched fingerprints skipped, one tier read
  at a time, the regression probe;
* the saturation and hotspot converters and the soak drill's row;
* `profile_trace` a no-op without a directory and a chrome trace with
  one on the CPU; `device_memory_stats` empty on the CPU.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from foundationdb_tpu.utils import perf as JP
from foundationdb_tpu_torch.utils import perf as PP
from foundationdb_tpu_torch.utils import probes as PPROBES
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

REPO = Path(__file__).resolve().parents[1]
#: each package's fingerprint version keys
VERSION_KEYS = {JP: ("jax_version", "jaxlib_version"),
                PP: ("torch_version", "cuda_version")}
#: the version key each package's hardware tier compares
HW_VERSION = {JP: "jaxlib_version", PP: "torch_version"}


def _fp(pkg, **over):
    fp = {"backend": "cpu", "device_kind": "cpu", "device_count": 1,
          "python_version": "3", "machine": "x"}
    fp.update({k: "0.0" for k in VERSION_KEYS[pkg]})
    fp.update(over)
    return fp


def _rec(pkg, value, *, source="t", tier="hardware", direction="higher",
         name="txn_s", fp=None, workload=None, knobs=None):
    return pkg.make_record(
        source, {name: pkg.metric(value, "txn/s", direction, tier=tier)},
        workload=workload or {"shape": 1}, knobs=knobs or {"k": 1},
        fingerprint=fp or _fp(pkg), git_sha="deadbeef", timestamp=0.0,
    )


def _unversioned(rec: dict) -> dict:
    """A record without its fingerprint's version keys."""
    out = json.loads(json.dumps(rec))
    for keys in VERSION_KEYS.values():
        for k in keys:
            out.get("fingerprint", {}).pop(k, None)
    return out


def _same_records(jrecs: list, precs: list) -> None:
    assert [_unversioned(r) for r in precs] == [
        _unversioned(r) for r in jrecs]


# ---------------------------------------------------------------------------
# Schema round trip + validation.


def test_record_roundtrip_through_ledger(tmp_path):
    rows = {}
    for pkg in (JP, PP):
        path = str(tmp_path / f"{pkg.__name__}.jsonl")
        rec = _rec(pkg, 100.0)
        assert pkg.append(rec, path=path) == path
        back = pkg.load_history(path)
        assert back == [rec]
        pkg.validate_record(back[0])
        rows[pkg] = back
    _same_records(rows[JP], rows[PP])
    for key in ("backend", "device_kind", "device_count", "torch_version",
                "cuda_version"):
        assert key in rows[PP][0]["fingerprint"]


def test_device_fingerprint_live():
    j, p = JP.device_fingerprint(), PP.device_fingerprint()
    assert p["backend"] == j["backend"] == "cpu"
    assert p["device_kind"] == "cpu" and p["device_count"] == 1
    assert p["torch_version"] == torch.__version__
    assert p["cuda_version"] == torch.version.cuda
    assert (p["python_version"], p["machine"]) == (j["python_version"],
                                                   j["machine"])
    assert set(p) - set(VERSION_KEYS[PP]) == set(j) - set(VERSION_KEYS[JP])
    PP.validate_record(PP.make_record(
        "t", {"m": PP.metric(1, "count")}, fingerprint=p))


@pytest.mark.parametrize("mutate, frag", [
    (lambda r: r["metrics"]["txn_s"].update(direction="sideways"),
     "direction"),
    (lambda r: r["metrics"]["txn_s"].update(tier="vibes"), "tier"),
    (lambda r: r["metrics"]["txn_s"].pop("unit"), "unit"),
    (lambda r: r["metrics"]["txn_s"].update(value="fast"), "number"),
    (lambda r: r["metrics"]["txn_s"].update(value=True), "number"),
    (lambda r: r.update(schema_version=99), "schema_version"),
    (lambda r: r.update(metrics={}), "metrics"),
    (lambda r: r.update(source=""), "source"),
    (lambda r: r.update(workload=[]), "workload"),
    (lambda r: r.update(experiment=""), "experiment"),
    (lambda r: r["fingerprint"].pop("device_kind"), "device_kind"),
], ids=["direction", "tier", "unit", "value", "bool-value",
        "schema_version", "metrics", "source", "workload", "experiment",
        "device_kind"])
def test_validate_rejects_malformed(mutate, frag):
    said = {}
    for pkg in (JP, PP):
        rec = _rec(pkg, 1.0)
        mutate(rec)
        with pytest.raises(ValueError, match=frag) as e:
            pkg.validate_record(rec)
        said[pkg] = str(e.value)
    assert said[PP] == said[JP]


def test_validate_names_the_ports_version_keys():
    rec = _rec(PP, 1.0)
    del rec["fingerprint"]["torch_version"]
    with pytest.raises(ValueError, match="torch_version"):
        PP.validate_record(rec)
    # a JAX row is not a port row: its fingerprint lacks the port's keys
    with pytest.raises(ValueError, match="cuda_version"):
        PP.validate_record(_rec(JP, 1.0))


def test_append_refuses_invalid(tmp_path):
    for pkg in (JP, PP):
        rec = _rec(pkg, 1.0)
        rec["metrics"]["txn_s"]["direction"] = "bogus"
        path = tmp_path / f"{pkg.__name__}.jsonl"
        with pytest.raises(ValueError):
            pkg.append(rec, path=str(path))
        assert not path.exists()


def test_load_history_strict_on_corruption(tmp_path):
    path = tmp_path / "h.jsonl"
    path.write_text('{"ok": 1}\nnot json\n')
    said = {}
    for pkg in (JP, PP):
        with pytest.raises(ValueError, match="malformed") as e:
            pkg.load_history(str(path))
        said[pkg] = str(e.value)
    assert said[PP] == said[JP]
    assert PP.load_history(str(tmp_path / "absent.jsonl")) == []


def test_emit_honors_ledger_env(tmp_path, monkeypatch):
    rows = {}
    for pkg in (JP, PP):
        path = str(tmp_path / f"{pkg.__name__}.jsonl")
        monkeypatch.setenv("FDBTPU_PERF_LEDGER", path)
        rec = pkg.emit("t", {"m": pkg.metric(1, "count", "higher")},
                       workload={"w": 2}, knobs={"k": 3})
        assert pkg.load_history(path) == [rec]
        assert rec["timestamp"] is not None and rec["git_sha"]
        rows[pkg] = rec
    for rec in rows.values():
        rec["timestamp"] = None
    # the live fingerprints differ in their device count (JAX's virtual
    # CPU mesh) besides the version keys
    for rec in rows.values():
        rec["fingerprint"].pop("device_count")
    _same_records([rows[JP]], [rows[PP]])
    # FDBTPU_PERF_DIR moves the directory when no file is named
    monkeypatch.delenv("FDBTPU_PERF_LEDGER")
    monkeypatch.setenv("FDBTPU_PERF_DIR", str(tmp_path / "dir"))
    for pkg in (JP, PP):
        assert pkg.history_path() == str(tmp_path / "dir" / "history.jsonl")


def test_default_ledger_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("FDBTPU_PERF_LEDGER", raising=False)
    monkeypatch.delenv("FDBTPU_PERF_DIR", raising=False)
    path = Path(PP.history_path())
    assert path == REPO / "foundationdb_tpu_torch" / "perf" / "history.jsonl"
    assert path != Path(JP.history_path())
    ignored = (REPO / ".gitignore").read_text().split()
    assert "foundationdb_tpu_torch/perf/" in ignored


# ---------------------------------------------------------------------------
# Fingerprint matching + baseline selection.


def _windows(pkg):
    cand = _rec(pkg, 100.0)
    rows = [
        _rec(pkg, 90.0),
        _rec(pkg, 10.0, fp=_fp(pkg, device_kind="NVIDIA H100",
                               backend="cuda")),
        _rec(pkg, 10.0, fp=_fp(pkg, **{HW_VERSION[pkg]: "9.9"})),
        _rec(pkg, 10.0, workload={"shape": 2}),
        _rec(pkg, 10.0, knobs={"k": 2}),
        dict(_rec(pkg, 95.0), experiment="search-1"),
    ]
    return rows, {tier: pkg.baseline_window(rows, cand, tier=tier)
                  for tier in ("hardware", "structural")}


def test_hardware_baseline_ignores_mismatched_fingerprints():
    (jrows, jwin), (prows, pwin) = _windows(JP), _windows(PP)
    for tier in ("hardware", "structural"):
        assert [prows.index(r) for r in pwin[tier]] == [
            jrows.index(r) for r in jwin[tier]]
    # hardware: the same device identity only; structural crosses hosts
    # but keys on workload and knobs; trials never
    assert [prows.index(r) for r in pwin["hardware"]] == [0]
    assert [prows.index(r) for r in pwin["structural"]] == [0, 1, 2]


def test_comparator_skips_mismatched_rows_entirely():
    reps = []
    for pkg in (JP, PP):
        foreign = _rec(pkg, 1000.0, fp=_fp(pkg, device_kind="NVIDIA H100",
                                           backend="cuda"))
        reps.append(pkg.compare(_rec(pkg, 10.0), [foreign],
                                tier="hardware"))
    assert reps[1] == reps[0]
    assert reps[1]["baseline_rows"] == 0
    assert reps[1]["metrics"]["txn_s"]["status"] == "new"
    assert reps[1]["regressions"] == []


# ---------------------------------------------------------------------------
# The comparator, both directions.


def _compare_both(values, cand, **kw):
    tier = kw.pop("tier", "hardware")
    out = []
    for pkg in (JP, PP):
        base = [_rec(pkg, v, tier=tier, **kw) for v in values]
        out.append(pkg.compare(_rec(pkg, cand, tier=tier, **kw), base,
                               tier=tier))
    assert out[1] == out[0]
    return out[1]


def test_within_band_noise_passes():
    rep = _compare_both((95.0, 100.0, 103.0, 98.0, 101.0), 93.0)
    assert rep["metrics"]["txn_s"]["status"] == "ok"
    assert rep["regressions"] == []


def test_regression_outside_band_fails_higher_is_better():
    before = PPROBES.snapshot().get("perf.regression_gate_tripped", 0)
    rep = _compare_both((95.0, 100.0, 103.0, 98.0, 101.0), 50.0)
    assert rep["metrics"]["txn_s"]["status"] == "regression"
    assert rep["regressions"] == ["txn_s"]
    # the port's own probe registry records the tripped gate
    assert PPROBES.snapshot()["perf.regression_gate_tripped"] == before + 1


def test_regression_lower_is_better_direction():
    kw = dict(direction="lower", name="p99_ms")
    base = (10.0, 11.0, 10.5)
    assert _compare_both(base, 10.4, **kw)["regressions"] == []
    assert _compare_both(base, 30.0, **kw)["regressions"] == ["p99_ms"]
    better = _compare_both(base, 2.0, **kw)
    assert better["metrics"]["p99_ms"]["status"] == "improved"
    assert better["regressions"] == []


def test_structural_tier_is_exact():
    kw = dict(tier="structural", direction="lower", name="merge_rows")
    assert _compare_both((121396,) * 3, 121396, **kw)["regressions"] == []
    assert _compare_both((121396,) * 3, 242792, **kw)["regressions"] == [
        "merge_rows"]
    # structural compares across hosts: a candidate from another machine
    reps = []
    for pkg in (JP, PP):
        base = [_rec(pkg, 121396, **kw) for _ in range(3)]
        cross = _rec(pkg, 242792, fp=_fp(pkg, machine="arm64"), **kw)
        reps.append(pkg.compare(cross, base, tier="structural"))
    assert reps[1] == reps[0]
    assert reps[1]["regressions"] == ["merge_rows"]


def test_compare_only_reads_requested_tier():
    reps = []
    for pkg in (JP, PP):
        rec = pkg.make_record(
            "t",
            {"rate": pkg.metric(10.0, "txn/s", "higher", tier="hardware"),
             "rows": pkg.metric(5, "rows", "lower", tier="structural")},
            workload={"shape": 1}, knobs={}, fingerprint=_fp(pkg),
            git_sha="d", timestamp=0.0,
        )
        base = json.loads(json.dumps(rec))
        base["metrics"]["rate"]["value"] = 1000.0  # a hardware collapse
        reps.append(pkg.compare(rec, [base], tier="structural"))
    assert reps[1] == reps[0]
    assert set(reps[1]["metrics"]) == {"rows"}
    assert reps[1]["regressions"] == []


# ---------------------------------------------------------------------------
# Converters and the soak drill's row.


def test_saturation_converter_is_structural():
    reports = [json.loads(line) for line in
               (REPO / "SATURATION_r08.json").read_text().splitlines()]
    for fingerprint in (None, "host"):
        jrecs, precs = [], []
        for rep in reports:
            jrecs.append(JP.saturation_report_to_record(
                rep, fingerprint=fingerprint and _fp(JP)))
            precs.append(PP.saturation_report_to_record(
                rep, fingerprint=fingerprint and _fp(PP)))
        for r in jrecs + precs:
            r["git_sha"] = r["timestamp"] = None
        _same_records(jrecs, precs)
    rec = precs[0]
    PP.validate_record(rec)
    assert all(m["tier"] == "structural" for m in rec["metrics"].values())
    assert rec["metrics"]["peak_goodput_tps"]["value"] == pytest.approx(
        221.0)
    assert rec["workload"]["admission"] is True


@pytest.mark.parametrize("direction", ["zipf", "uniform"])
def test_hotspot_converter_is_structural(direction):
    rep = {"spec": "hotspot", "seed": 3, "path": "sim",
           "direction": direction, "committed": 812,
           "sampling": {"sample_keys": 31, "sampled_bytes": 24_576,
                        "byte_sample_writes": 900, "tag_counter_tags": 4,
                        "tag_notes": 812, "tag_bytes_noted": 52_000,
                        "resolver_key_sample_keys": 17},
           "attribution": {"attributed": direction == "zipf"},
           "config": {"txns": 812, "value_bytes": 64, "tenants": 8}}
    j = JP.hotspot_report_to_record(rep, imported_from="leg.json")
    p = PP.hotspot_report_to_record(rep, imported_from="leg.json")
    _same_records([j], [p])
    assert p["imported_from"] == "leg.json" and p["timestamp"] is None
    assert all(m["tier"] == "structural" for m in p["metrics"].values())
    assert p["metrics"]["attributed"]["direction"] == (
        "higher" if direction == "zipf" else "lower")


def _jax_soak_script():
    spec = importlib.util.spec_from_file_location(
        "jax_soak_cli", REPO / "scripts" / "soak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_soak_emitter_and_signature_metrics(tmp_path, monkeypatch):
    from foundationdb_tpu.testing.soak import signature_metrics as jsm
    from foundationdb_tpu_torch.drills import soak as soak_drill
    from foundationdb_tpu_torch.testing.soak import signature_metrics as psm

    sig = (7, 12, 3, 40, 1.25, 2, ("a",), None, "ff00", 9)
    assert psm(sig) == jsm(sig)
    assert psm(sig[:8]) == jsm(sig[:8])
    assert "traced_commits" not in psm(sig[:8])

    totals = {"committed": 30, "aborted": 2, "read_checks": 99,
              "api_acked": 4}
    jpath, ppath = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    monkeypatch.setenv("FDBTPU_PERF_LEDGER", jpath)
    _jax_soak_script()._emit_perf_row("default", [0, 1, 2], 1, totals, 17)
    # the port's drill takes the ledger as an argument as well
    soak_drill._emit_perf_row("default", [0, 1, 2], 1, totals, 17,
                              ledger=ppath)
    jrows, prows = JP.load_history(jpath), PP.load_history(ppath)
    for r in jrows + prows:
        r["timestamp"] = None
        r["fingerprint"].pop("device_count")
    _same_records(jrows, prows)
    assert prows[0]["source"] == "soak"
    assert prows[0]["metrics"]["traced_commits"]["value"] == 17
    assert prows[0]["workload"] == {
        "spec": "default", "seeds": [0, 2], "n_seeds": 3, "perturb": 1,
    }


# ---------------------------------------------------------------------------
# Profiling hooks.


def test_profile_trace_noop_without_dir():
    for d in (None, ""):
        with PP.profile_trace(d):
            pass
        with JP.profile_trace(d):
            pass


def test_profile_trace_captures(tmp_path):
    d = tmp_path / "prof"
    with PP.profile_trace(str(d)):
        torch.ones(4).add(1).sum().item()
    traces = list(d.glob("trace-*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in
             json.loads(traces[0].read_text())["traceEvents"]}
    assert "aten::sum" in names and "aten::add" in names


def test_device_memory_stats_shape():
    # no card here: the contract is "empty dict, no error", as JAX's
    # XLA:CPU gives
    assert PP.device_memory_stats() == {}
    assert PP.device_memory_stats("cpu") == {}
    jstats = JP.device_memory_stats()
    assert all(isinstance(v, int) for v in jstats.values())
    assert set(jstats) <= {"bytes_in_use", "peak_bytes_in_use",
                           "bytes_limit", "largest_alloc_size",
                           "num_allocs"}
