"""Saturation ramp drill: the overload-survival SLO gate as a command
(the port's analog of the JAX package's `scripts/saturation.py`).

    python -m foundationdb_tpu_torch.drills.saturation --smoke
    python -m foundationdb_tpu_torch.drills.saturation --full
    python -m foundationdb_tpu_torch.drills.saturation --full --json-out r.json

Runs testing/saturation.run_saturation (the `[saturation]` table of
testing/specs/saturation.toml) in BOTH directions:

* admission ON  — the gate MUST pass: offered load ramped past the
  modeled capacity keeps commit p99 inside the band and goodput >=
  min_goodput_frac of peak (graceful degradation).
* admission OFF — the SAME ramp with the ratekeeper disconnected MUST
  violate the gate; an OFF run that passes means the ramp is not
  saturating and the gate is vacuous.

The cluster's resolver is the port's conflict set on the card, or its
plain PyTorch versions with `--device cpu`. The exit status is nonzero
if either direction lands wrong. Each direction appends one structural
perf-ledger row (`utils/perf.saturation_report_to_record`) to
`--perf-ledger`, or the default ledger; a `--smoke` run with no ledger
named (and no FDBTPU_PERF_LEDGER) writes to a temporary file, so a smoke
run leaves the history as it was. `--no-perf` skips the rows.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="quick ramp (spec quick_ramp), both directions")
    ap.add_argument("--full", action="store_true",
                    help="full ramp (spec ramp), both directions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spec", default="saturation")
    ap.add_argument("--device", default=None, choices=("cpu",),
                    help="the plain PyTorch versions on the CPU "
                         "(default: the card)")
    ap.add_argument("--json-out", default=None,
                    help="append both reports as JSON lines")
    ap.add_argument("--perf-ledger", default=None,
                    help="append the perf-ledger rows here (default: "
                         "utils/perf.history_path())")
    ap.add_argument("--no-perf", action="store_true",
                    help="skip the perf-ledger append")
    args = ap.parse_args(argv)
    quick = not args.full

    from foundationdb_tpu_torch.testing.saturation import run_saturation

    rc = 0
    reports = []
    for admission in (True, False):
        t0 = time.perf_counter()
        rep = run_saturation(
            admission=admission, seed=args.seed, quick=quick,
            spec_name=args.spec, device=args.device,
        )
        wall = time.perf_counter() - t0
        reports.append(rep)
        label = "ON " if admission else "OFF"
        print(f"== admission {label}: capacity {rep['capacity_tps']} tps, "
              f"ramp x{rep['ramp']} @ {rep['step_seconds']}s "
              f"(wall {wall:.2f}s) ==")
        for s in rep["steps"]:
            print(
                f"  {s['multiplier']:>4}x  offered {s['offered']:>6} "
                f"admitted {s['admitted']:>6} committed {s['committed']:>6} "
                f"shed {s['shed']:>6} too_old {s['too_old']:>5}  "
                f"goodput {s['goodput_tps']:>7} tps  "
                f"p50 {s['commit_p50_s'] * 1e3:7.1f}ms  "
                f"p99 {s['commit_p99_s'] * 1e3:7.1f}ms"
            )
        slo = rep["slo"]
        print(f"  peak goodput {rep['peak_goodput_tps']} tps; "
              f"SLO {'PASSED' if slo['passed'] else 'VIOLATED'}"
              + (f": {slo['violations']}" if slo["violations"] else ""))
        if admission and not slo["passed"]:
            print("saturation: admission-ON ramp VIOLATED the SLO gate",
                  file=sys.stderr)
            rc = 1
        if not admission and slo["passed"]:
            print("saturation: admission-OFF ramp PASSED the gate — the "
                  "ramp is not saturating; the SLO is vacuous",
                  file=sys.stderr)
            rc = 1
    if args.json_out:
        with open(args.json_out, "a") as f:
            for rep in reports:
                f.write(json.dumps(rep) + "\n")
    if not args.no_perf:
        # one ledger row a direction; the ramp runs on the virtual clock,
        # so every metric is structural
        from foundationdb_tpu_torch.utils import perf

        if (quick and not args.perf_ledger
                and "FDBTPU_PERF_LEDGER" not in os.environ):
            import tempfile

            args.perf_ledger = os.path.join(
                tempfile.mkdtemp(prefix="saturation_perf_"),
                "history.jsonl",
            )
        host_fp = perf.device_fingerprint()
        for rep in reports:
            rec = perf.saturation_report_to_record(rep, fingerprint=host_fp)
            path = perf.append(rec, path=args.perf_ledger)
        print(f"[perf] {len(reports)} ledger row(s) appended to {path}")
    print("saturation gate ok" if rc == 0 else "saturation gate FAILED")
    return rc


if __name__ == "__main__":
    sys.exit(main())
