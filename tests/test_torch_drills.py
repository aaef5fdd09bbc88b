"""The port's drills on the CPU (`--device cpu`, the plain versions).

* the soak drill sweeps two smoke seeds in a spawned worker pool, one a
  determinism pair, and reports them; its probe accounting declares the
  port's manifest;
* the hotspot drill's one-leg mode passes on the sim cluster;
* `--perf-ledger` and `--profile-dir` raise until utils/perf.py is
  ported.
"""

from __future__ import annotations

import json

import pytest

from foundationdb_tpu_torch.drills import hotspot as hot_drill
from foundationdb_tpu_torch.drills import saturation as sat_drill
from foundationdb_tpu_torch.drills import soak as soak_drill
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from foundationdb_tpu_torch.utils import probes

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


@pytest.mark.parametrize("drill,argv", [
    (soak_drill, ["--perf-ledger", "x.jsonl"]),
    (soak_drill, ["--profile-dir", "prof"]),
    (sat_drill, ["--perf-ledger", "x.jsonl"]),
    (hot_drill, ["--perf-ledger", "x.jsonl"]),
], ids=["soak-ledger", "soak-profile", "saturation", "hotspot"])
def test_perf_options_raise_until_ported(drill, argv):
    with pytest.raises(NotImplementedError, match="utils/perf is not "
                                                  "ported yet"):
        drill.main(argv)
