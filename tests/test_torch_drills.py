"""The port's drills on the CPU (`--device cpu`, the plain versions).

* the soak drill sweeps two smoke seeds in a spawned worker pool, one a
  determinism pair, and reports them; its probe accounting declares the
  port's manifest;
* the hotspot drill's one-leg mode passes on the sim cluster;
* `--perf-ledger` and `--profile-dir` write through utils/perf.py: the
  soak drill's traced sweep appends its structural row and
  `--profile-dir` leaves a chrome trace; the saturation and hotspot
  drills append one row a report (their runs stubbed with reports of the
  drills' own shape: the runs themselves are tests/
  test_torch_saturation_hotspot.py's).
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from foundationdb_tpu_torch.drills import hotspot as hot_drill
from foundationdb_tpu_torch.drills import saturation as sat_drill
from foundationdb_tpu_torch.drills import soak as soak_drill
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import perf, probes

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()


def test_soak_drill_sweeps_seeds_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    before = probes.snapshot()
    try:
        rc = soak_drill.main(["--device", "cpu", "--spec", "smoke",
                              "--seeds", "2", "--jobs", "1"])
        out = capsys.readouterr().out
        assert rc == 0, out
        assert "[smoke] 2/2 seeds passed" in out
        assert "[determinism OK]" in out and "device cpu" in out
        assert set(soak_drill.load_manifest()) <= set(probes.snapshot())
    finally:
        probes.reset()
        probes.merge(before)


def test_hotspot_drill_once(capsys):
    assert hot_drill.main(["--once", "--json", "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["path"] == "sim"
    assert rep["attribution"]["hot_tag"]["tag"] == "tenant0"


REPO = Path(__file__).resolve().parents[1]


def _stub_runs(monkeypatch):
    """The saturation and hotspot runs replaced by reports of their
    shape: the JAX package's recorded saturation ramp (SATURATION_r08.json,
    one line a direction) and a one-leg hotspot report."""
    from foundationdb_tpu_torch.testing import hotspot as PH
    from foundationdb_tpu_torch.testing import saturation as PS

    sat = [json.loads(line) for line in
           (REPO / "SATURATION_r08.json").read_text().splitlines()]
    monkeypatch.setattr(
        PS, "run_saturation",
        lambda admission, **kw: next(r for r in sat
                                     if r["admission"] == admission))

    def leg(seed, skewed, **kw):
        return {"spec": "hotspot", "seed": seed, "path": "sim",
                "direction": "zipf" if skewed else "uniform", "ok": True,
                "committed": 40, "failed": 0, "why": "stub",
                "sampling": {"sample_keys": 7, "sampled_bytes": 900},
                "attribution": {"attributed": skewed},
                "config": {"txns": 40, "value_bytes": 64}}

    monkeypatch.setattr(PH, "run_hotspot_sim", leg)


@pytest.mark.parametrize("drill,argv", [
    (soak_drill, ["--device", "cpu", "--spec", "smoke", "--seeds", "1",
                  "--jobs", "1", "--trace", "--perf-ledger", "x.jsonl"]),
    (soak_drill, ["--device", "cpu", "--spec", "smoke", "--seeds", "1",
                  "--profile-dir", "prof"]),
    (sat_drill, ["--smoke", "--device", "cpu", "--perf-ledger",
                 "x.jsonl"]),
    (hot_drill, ["--sim", "--device", "cpu", "--perf-ledger", "x.jsonl"]),
], ids=["soak-ledger", "soak-profile", "saturation", "hotspot"])
def test_perf_options_raise_until_ported(drill, argv, tmp_path, capsys,
                                         monkeypatch):
    """The soak, saturation and hotspot drills' `--perf-ledger` options
    write valid ledger rows and `--profile-dir` writes one chrome trace.
    The name is from when these options raised, before `utils/perf.py`
    was ported; it is kept so that the test's record stays one."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("FDBTPU_PERF_LEDGER", raising=False)
    _stub_runs(monkeypatch)
    argv = [str(tmp_path / a) if a in ("x.jsonl", "prof") else a
            for a in argv]
    before = probes.snapshot()
    try:
        assert drill.main(argv) == 0, capsys.readouterr().out
    finally:
        probes.reset()
        probes.merge(before)
    if "--profile-dir" in argv:
        traces = list((tmp_path / "prof").glob("trace-*.json"))
        assert len(traces) == 1
        assert "traceEvents" in json.loads(traces[0].read_text())
        return
    rows = perf.load_history(str(tmp_path / "x.jsonl"))
    source = {soak_drill: "soak", sat_drill: "saturation",
              hot_drill: "hotspot"}[drill]
    assert [r["source"] for r in rows] == [source] * (1 if drill is
                                                      soak_drill else 2)
    for r in rows:
        perf.validate_record(r)
        assert r["fingerprint"]["backend"] == "cpu"
        assert all(m["tier"] == "structural" for m in r["metrics"].values())
    if drill is soak_drill:
        assert rows[0]["workload"] == {"spec": "smoke", "seeds": [0, 0],
                                       "n_seeds": 1, "perturb": 0}
        assert rows[0]["metrics"]["traced_commits"]["value"] > 0
