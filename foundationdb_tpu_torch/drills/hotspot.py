"""Hotspot drill: the keyspace-skew attribution gate as a command
(the port's analog of the JAX package's `scripts/hotspot.py`).

    python -m foundationdb_tpu_torch.drills.hotspot --smoke
    python -m foundationdb_tpu_torch.drills.hotspot --full
    python -m foundationdb_tpu_torch.drills.hotspot --once --json
    python -m foundationdb_tpu_torch.drills.hotspot --watch

Runs testing/hotspot.run_hotspot_gate (the `[hotspot]` table of
testing/specs/hotspot.toml) in BOTH directions on BOTH paths:

* zipf direction    — a seeded zipf tenant mix MUST be attributed to
  the injected hot tenant top-1 (cluster.busiest_tags / hot_ranges).
* uniform direction — the SAME drill with a flat mix must NOT flag.

and both against the in-sim cluster (deterministic virtual clock) and
real role processes over Unix sockets (wall clock, ratio-robust
verdict). The resolver runs on the card, or its plain PyTorch versions
with `--device cpu` (the wire leg's resolver process too). The exit
status is nonzero if ANY leg lands wrong. Each sim leg appends one
structural perf-ledger row (`utils/perf.hotspot_report_to_record`; the
wire legs' sampling seeds come from the wall clock, so they stay out) to
`--perf-ledger`, or the default ledger; a `--smoke` run with no ledger
named (and no FDBTPU_PERF_LEDGER) writes to a temporary file. `--no-perf`
skips the rows.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _heat_lines(rep: dict) -> list[str]:
    """The keyspace heatmap for one leg, fdbtop-style."""
    ticks = "▁▂▃▄▅▆▇█"
    lines = []
    ranges = rep.get("hot_ranges") or []
    if ranges:
        peak = max(r.get("frac", 0.0) for r in ranges) or 1.0
        bar = "".join(
            ticks[min(7, int(r.get("frac", 0.0) / peak * 7))]
            for r in ranges
        )
        labels = "  ".join(
            f"{r.get('range', '?')}:{r.get('frac', 0.0) * 100:.0f}%"
            for r in ranges[:6]
        )
        lines.append(f"  keyspace  {bar}  {labels}")
    tags = rep.get("busiest_tags") or []
    if tags:
        lines.append("  busiest tags: " + "  ".join(
            f"{t.get('tag', '?')} {t.get('frac', 0.0) * 100:.0f}%"
            for t in tags[:4]
        ))
    return lines


def _print_leg(rep: dict, wall: float = None) -> None:
    mark = "ok " if rep["ok"] else "BAD"
    print(f"== {rep['path']:>4}/{rep['direction']:<7} [{mark}] "
          f"committed {rep['committed']} failed {rep['failed']}  "
          f"— {rep['why']}"
          + (f"  (wall {wall:.2f}s)" if wall is not None else ""))
    for line in _heat_lines(rep):
        print(line)
    attr = rep.get("attribution") or {}
    ht, hr = attr.get("hot_tag"), attr.get("hot_range")
    if ht or hr:
        parts = []
        if ht:
            parts.append(f"tag {ht['tag']} @ {ht['frac']:.2f}")
        if hr:
            parts.append(f"range {hr['range']} @ {hr['frac']:.2f}")
        print("  attributed: " + ", ".join(parts))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="quick drill (spec quick_txns), all four legs")
    ap.add_argument("--full", action="store_true",
                    help="full drill (spec txns), all four legs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spec", default="hotspot")
    ap.add_argument("--device", default=None, choices=("cpu",),
                    help="the plain PyTorch versions on the CPU "
                         "(default: the card)")
    ap.add_argument("--sim", action="store_true",
                    help="sim path only (deterministic virtual clock)")
    ap.add_argument("--wire", action="store_true",
                    help="wire path only (real role processes)")
    ap.add_argument("--once", action="store_true",
                    help="one zipf sim leg, print and exit (with --json: "
                         "dump the full leg report as JSON)")
    ap.add_argument("--watch", action="store_true",
                    help="loop zipf sim legs over rolling seeds, "
                         "redrawing the heatmap")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="--watch redraw interval (seconds)")
    ap.add_argument("--json", action="store_true",
                    help="with --once: emit the leg report as JSON")
    ap.add_argument("--json-out", default=None,
                    help="append all leg reports as JSON lines")
    ap.add_argument("--perf-ledger", default=None,
                    help="append the perf-ledger rows here (default: "
                         "utils/perf.history_path())")
    ap.add_argument("--no-perf", action="store_true",
                    help="skip the perf-ledger append")
    args = ap.parse_args(argv)
    quick = not args.full

    from foundationdb_tpu_torch.testing.hotspot import (
        run_hotspot_wire,
        run_hotspot_sim,
    )

    if args.once:
        rep = run_hotspot_sim(seed=args.seed, skewed=True, quick=True,
                              spec_name=args.spec, device=args.device)
        if args.json:
            print(json.dumps(rep, indent=2))
        else:
            _print_leg(rep)
        return 0 if rep["ok"] else 1

    if args.watch:
        seed = args.seed
        try:
            while True:
                rep = run_hotspot_sim(seed=seed, skewed=True, quick=True,
                                      spec_name=args.spec,
                                      device=args.device)
                print(f"\x1b[2J\x1b[Hhotspot --watch  seed {seed}  "
                      f"{time.strftime('%H:%M:%S')}")
                _print_leg(rep)
                seed += 1
                time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0

    if args.sim == args.wire:
        paths = ("sim", "wire")
    else:
        paths = ("sim",) if args.sim else ("wire",)
    runners = {"sim": run_hotspot_sim, "wire": run_hotspot_wire}
    # the legs of run_hotspot_gate, one at a time so each is timed
    legs = []
    t_all = time.perf_counter()
    for path in paths:
        for skewed in (True, False):
            t0 = time.perf_counter()
            rep = runners[path](seed=args.seed, skewed=skewed, quick=quick,
                                spec_name=args.spec, device=args.device)
            legs.append(rep)
            _print_leg(rep, time.perf_counter() - t0)
    rc = 0 if all(leg["ok"] for leg in legs) else 1
    print(f"{len(legs)} legs in {time.perf_counter() - t_all:.2f}s")
    if args.json_out:
        with open(args.json_out, "a") as f:
            for rep in legs:
                f.write(json.dumps(rep) + "\n")
    sim_legs = [r for r in legs if r["path"] == "sim"]
    if sim_legs and not args.no_perf:
        from foundationdb_tpu_torch.utils import perf

        if (quick and not args.perf_ledger
                and "FDBTPU_PERF_LEDGER" not in os.environ):
            import tempfile

            args.perf_ledger = os.path.join(
                tempfile.mkdtemp(prefix="hotspot_perf_"), "history.jsonl")
        host_fp = perf.device_fingerprint()
        for rep in sim_legs:
            rec = perf.hotspot_report_to_record(rep, fingerprint=host_fp)
            path = perf.append(rec, path=args.perf_ledger)
        print(f"[perf] {len(sim_legs)} ledger row(s) appended to {path}")
    print("hotspot gate ok" if rc == 0 else "hotspot gate FAILED")
    return rc


if __name__ == "__main__":
    sys.exit(main())
