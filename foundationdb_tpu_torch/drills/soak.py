"""Spec-driven seed-sweeping soak runner (the port's analog of the JAX
package's `scripts/soak.py`).

    python -m foundationdb_tpu_torch.drills.soak --seeds 100
    python -m foundationdb_tpu_torch.drills.soak --spec api_correctness \\
        --seeds 32 --jobs 4
    python -m foundationdb_tpu_torch.drills.soak --smoke   # 1 seed a spec
    python -m foundationdb_tpu_torch.drills.soak --device cpu --seeds 4

The Joshua-ensemble runner (contrib/TestHarness2/test_harness/run.py's
role): N seeds, each a deterministic simulated-cluster run whose shape,
knobs, fault mix and workload set come from a named spec
(foundationdb_tpu_torch/testing/specs/*.toml), run across worker
processes. Every K-th seed (the spec's determinism_every) runs twice and
the signatures are compared: the unseed determinism check
(contrib/debug_determinism/). A failure names the seed and the spec.

Seeds that draw the "cuda" backend resolve on the card (the kernels are
built once, in this process, before the workers start) unless
`--device cpu` runs the kernels' plain PyTorch versions. The workers are
started with the "spawn" method, each with its own CUDA context: a fork
of a process that has touched CUDA breaks.

Probe accounting: the port's whole probe manifest
(testing/probe_manifest.json) is declared up front; after the sweep the
spec's `[probes].expected` list is reported, and with `--probe-gate` an
expected-but-never-hit probe fails the run.

Perf ledger: a traced sweep (`--trace`) with no failure appends one
structural row (outcome totals over the fixed spec, seed set and
perturbation count) through `utils/perf.py`, to `--perf-ledger` or the
default ledger. `--profile-dir` captures a `torch.profiler` trace of the
run there; it runs the seeds in this process (one job), since a worker
pool's device work is invisible to the parent's profiler.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from pathlib import Path

MANIFEST = (Path(__file__).resolve().parents[1] / "testing"
            / "probe_manifest.json")

#: a fresh pool every this many seeds bounds a worker's lifetime (a
#: worker's heap grows across seeds; the backup workload builds a second
#: cluster a seed)
CHUNK = 400


def load_manifest() -> dict:
    """probe name -> declaring file, for every probe the port declares."""
    return json.loads(MANIFEST.read_text(encoding="utf-8"))["probes"]


def _launches() -> dict:
    from foundationdb_tpu_torch import kernels

    return kernels.counts()


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] - before.get(k, 0)}


def _perturbed_rerun(seed, spec, pid, spec_label, device, trace=False,
                     status_probe=False):
    """One perturbed re-run with the (seed, perturb) pair named in any
    failure: run_seed's own asserts only know the seed."""
    from foundationdb_tpu_torch.testing import soak

    try:
        return soak.run_seed(seed, spec=spec, perturb=pid, trace=trace,
                             status_probe=status_probe, device=device)
    except Exception as e:
        raise AssertionError(
            f"seed {seed} perturb {pid} (spec {spec_label}): {e}"
        ) from e


def _one(args):
    (seed, spec_name, check_determinism, perturb, trace, status_probe,
     device, threads) = args
    import torch

    from foundationdb_tpu_torch.testing import soak

    # the workers share the host's cores (torch's pool defaults to all)
    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    before = _launches()
    sig, hits = soak.run_seed(
        seed, spec=spec_name, collect_probes=True, trace=trace,
        status_probe=status_probe, device=device,
    )
    launches = _delta(_launches(), before)
    if check_determinism:
        sig2 = soak.run_seed(seed, spec=spec_name, trace=trace,
                             status_probe=status_probe, device=device)
        if sig != sig2:
            raise AssertionError(
                f"seed {seed} (spec {spec_name}): NONDETERMINISTIC\n"
                f"  run1: {sig}\n  run2: {sig2}"
            )
    # each perturbation id reruns the seed under seeded randomized
    # tie-breaking among equally-runnable actors: a legal schedule, so
    # every gate must pass; on determinism-cadence seeds each (seed,
    # perturb) pair runs twice and must match
    for pid in range(1, perturb + 1):
        psig = _perturbed_rerun(seed, spec_name, pid, spec_name, device,
                                trace=trace, status_probe=status_probe)
        if check_determinism:
            psig2 = soak.run_seed(
                seed, spec=spec_name, perturb=pid, trace=trace,
                status_probe=status_probe, device=device,
            )
            if psig != psig2:
                raise AssertionError(
                    f"seed {seed} perturb {pid} (spec {spec_name}): "
                    f"NONDETERMINISTIC\n  run1: {psig}\n  run2: {psig2}"
                )
    return (seed, sig, time.perf_counter() - t0, check_determinism, hits,
            launches)


def _emit_perf_row(spec_name: str, seeds: list, perturb: int,
                   totals: dict, traced_commits: int,
                   ledger: str = None) -> None:
    """One perf-ledger row for a traced sweep (utils/perf.py): outcome
    totals over a fixed (spec, seed set, perturb) plan are deterministic,
    so they land in the structural tier and compare exactly."""
    from foundationdb_tpu_torch.utils import perf

    metrics = {
        name: perf.metric(v, "count", direction, tier="structural")
        for name, v, direction in (
            ("committed", totals["committed"], "higher"),
            ("aborted", totals["aborted"], "lower"),
            ("read_checks", totals["read_checks"], "higher"),
            ("api_acked", totals["api_acked"], "higher"),
            ("traced_commits", traced_commits, "higher"),
        )
    }
    rec = perf.emit(
        "soak", metrics,
        workload={
            "spec": spec_name,
            "seeds": [seeds[0], seeds[-1]] if seeds else [],
            "n_seeds": len(seeds),
            "perturb": perturb,
        },
        ledger=ledger,
    )
    print(f"[perf] soak ledger row appended "
          f"(committed={rec['metrics']['committed']['value']})")


class _InlineFuture:
    """One work item run in this process (`--profile-dir`: a worker
    pool's device work is invisible to the parent's profiler), with a
    pool future's `result()`."""

    def __init__(self, w):
        try:
            self._result, self._err = _one(w), None
        except Exception as e:  # surfaced by result(), as from a pool
            self._result, self._err = None, e

    def result(self):
        if self._err is not None:
            raise self._err
        return self._result


def sweep(spec_name: str, seeds: list, jobs: int, probe_gate: bool,
          perturb: int = 0, trace: bool = False,
          status_probe: bool = False, device=None, inline: bool = False,
          ledger: str = None) -> int:
    """Run one spec's seed sweep; returns the number of failures.
    `inline` runs the seeds one by one in this process."""
    from foundationdb_tpu_torch.testing.soak import (
        plan_for_seed,
        signature_metrics,
    )
    from foundationdb_tpu_torch.testing.spec import load_spec
    from foundationdb_tpu_torch.utils import probes as _probes

    spec = load_spec(spec_name)
    det_every = spec.policy["determinism_every"]
    threads = max(1, (os.cpu_count() or 1) // jobs)
    work = [
        (s, spec_name, i % det_every == 0, perturb, trace, status_probe,
         device, threads)
        for i, s in enumerate(seeds)
    ]
    t0 = time.perf_counter()
    failures = []
    done = 0
    committed = aborted = rechecks = det_checked = 0
    api_acked = api_reads = traced_commits = 0
    device_seeds = 0
    # per-seed probe snapshots aggregate here, and fold into this
    # process's registry once, after the last seed
    probe_agg: dict = {}
    ctx = multiprocessing.get_context("spawn")
    for lo in range(0, len(work), CHUNK):
        with (contextlib.nullcontext() if inline else
              ProcessPoolExecutor(max_workers=jobs, mp_context=ctx)) as pool:
            if inline:
                # lazily: each seed runs as the loop reaches it
                pairs = ((_InlineFuture(w), w[0])
                         for w in work[lo:lo + CHUNK])
            else:
                futs = {pool.submit(_one, w): w[0]
                        for w in work[lo:lo + CHUNK]}
                pairs = ((f, futs[f]) for f in as_completed(futs))
            for fut, seed in pairs:
                try:
                    s, sig, dt, det, hits, launches = fut.result()
                    sm = signature_metrics(sig)
                    for k, v in hits.items():
                        probe_agg[k] = probe_agg.get(k, 0) + v
                    done += 1
                    committed += sm["committed"]
                    aborted += sm["aborted"]
                    rechecks += sm["read_checks"]
                    traced_commits += sm.get("traced_commits", 0)
                    det_checked += int(det)
                    api_sig = sm["api"]
                    if api_sig is not None:
                        api_acked += api_sig[0]
                        api_reads += api_sig[7]
                    backend = plan_for_seed(s, spec).resolver_backend
                    device_seeds += backend == "cuda"
                    print(
                        f"seed {s:5d} ok in {dt:6.2f}s  {backend:4s} "
                        f"committed={sig[1]:3d} "
                        f"aborted={sig[2]:3d} epoch={sig[5]}"
                        + (
                            f"  api(acked={api_sig[0]},"
                            f"checked={api_sig[7]})"
                            if api_sig is not None else ""
                        )
                        + ("  [determinism OK]" if det else "")
                        + (f"  launches={sum(launches.values())}"
                           f" {sorted(launches)}" if launches else ""),
                        flush=True,
                    )
                except Exception as e:
                    failures.append((seed, repr(e)))
                    print(f"seed {seed:5d} FAILED: {e!r}", flush=True)
    wall = time.perf_counter() - t0
    _probes.reset()
    _probes.merge(probe_agg)
    print(
        f"\n[{spec_name}] {done}/{len(seeds)} seeds passed in {wall:.1f}s "
        f"({jobs} jobs, {perturb} perturbation(s)/seed, {device_seeds} "
        f"seed(s) on the cuda backend, device "
        f"{device if device is not None else 'cuda'}); "
        f"committed={committed} aborted={aborted} "
        f"read_checks={rechecks} api_acked={api_acked} "
        f"api_reads_checked={api_reads} determinism_checked={det_checked}"
    )
    # ensemble CODE_PROBE coverage: a declared probe no seed hit means
    # the randomization never reaches that rare path
    fired = {k: v for k, v in _probes.snapshot().items() if v}
    print(f"CODE_PROBEs fired ({len(fired)}):")
    for k in sorted(fired):
        print(f"  {k}: {fired[k]}")
    missed = _probes.missed()
    if missed:
        print(f"CODE_PROBEs NEVER HIT ({len(missed)}): {missed}")
    expected_missed = sorted(set(spec.expected_probes) & set(missed))
    if expected_missed:
        print(
            f"[{spec_name}] spec-EXPECTED probes never hit: "
            f"{expected_missed}"
        )
        # a budgeted rare probe only gates once the sweep is big enough
        # that its budget predicts >= PROBE_GATE_MIN_EXPECTED hits
        gated = spec.gated_probes(len(seeds))
        under_budget = sorted(set(expected_missed) - gated)
        gated_missed = sorted(set(expected_missed) & gated)
        if under_budget:
            print(
                f"[{spec_name}] missed-but-under-budget at "
                f"{len(seeds)} seed(s) (not gated): {under_budget}"
            )
        if probe_gate and gated_missed:
            failures.append(("probe-gate", repr(gated_missed)))
    if failures:
        print(f"[{spec_name}] FAILURES:")
        for s, e in failures:
            tag = f"seed {s}" if isinstance(s, int) else s
            print(f"  {tag}: {e}")
    elif trace:
        # a traced sweep is a perf run of record: its outcome totals and
        # traced commits land in the ledger's structural tier
        _emit_perf_row(
            spec_name, seeds, perturb,
            {"committed": committed, "aborted": aborted,
             "read_checks": rechecks, "api_acked": api_acked},
            traced_commits, ledger=ledger,
        )
    return len(failures)


def smoke(start: int, perturb: int, trace: bool, status_probe: bool,
          device) -> int:
    """One short seed per checked-in spec, in this process, with the api
    workload forced on: every spec loads, plans, runs and verifies."""
    from foundationdb_tpu_torch.testing import soak
    from foundationdb_tpu_torch.testing.spec import list_specs, load_spec

    failures = []
    for name in list_specs():
        spec = load_spec(name).with_overrides(
            rounds=(6, 9), api_rounds=6, api=1.0
        )
        t0 = time.perf_counter()
        try:
            sig = soak.run_seed(start, spec=spec, trace=trace,
                                status_probe=status_probe, device=device)
            for pid in range(1, perturb + 1):
                _perturbed_rerun(start, spec, pid, name, device,
                                 trace=trace, status_probe=status_probe)
            print(
                f"spec {name:16s} seed {start} ok in "
                f"{time.perf_counter() - t0:4.1f}s  "
                f"committed={sig[1]} api={sig[7]}"
                + (f"  [perturb x{perturb} OK]" if perturb else ""),
                flush=True,
            )
        except Exception as e:
            failures.append((name, repr(e)))
            print(f"spec {name:16s} FAILED: {e!r}", flush=True)
    return len(failures)


def main(argv=None) -> int:
    from foundationdb_tpu_torch.testing.spec import list_specs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument(
        "--spec", default="default", choices=list_specs(),
        help="named ensemble spec (foundationdb_tpu_torch/testing/specs/)",
    )
    ap.add_argument(
        "--device", default=None, choices=("cpu",),
        help="run the cuda backend's plain PyTorch versions on the CPU "
             "(default: the card)",
    )
    ap.add_argument(
        "--smoke", action="store_true",
        help="run ONE short seed per checked-in spec, in process",
    )
    ap.add_argument(
        "--probe-gate", action="store_true",
        help="fail the sweep if a spec-expected probe never fires",
    )
    ap.add_argument(
        "--perturb", type=int, default=0, metavar="K",
        help="re-run each seed K extra times under seeded randomized "
             "tie-breaking among equally-runnable actors",
    )
    ap.add_argument(
        "--status-probe", action="store_true",
        help="sample the full cluster_status() document during every "
             "seed (with --trace the digest proves the sensors leave "
             "traces bit-identical)",
    )
    ap.add_argument(
        "--trace", action="store_true",
        help="run every seed with commit-path telemetry on: the "
             "span-chain gate arms and the trace digest joins the "
             "determinism signature",
    )
    ap.add_argument("--perf-ledger", default=None,
                    help="the ledger a traced sweep appends its row to "
                         "(default: utils/perf.history_path())")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of the run "
                         "(runs the seeds in this process, one job)")
    args = ap.parse_args(argv)
    if args.profile_dir:
        # the profiler sees this process only; a worker pool would give
        # an empty trace that looks like a measurement
        args.jobs = 1

    from foundationdb_tpu_torch.utils import perf as _perf
    from foundationdb_tpu_torch.utils import probes as _probes

    # declare every probe the port declares, so one no seed reached shows
    # up as NEVER HIT even when its module was never imported here
    _probes.declare(*load_manifest())
    if args.device is None:
        from foundationdb_tpu_torch import kernels

        # once, here: the workers load the built libraries
        kernels.build_all()
    with _perf.profile_trace(args.profile_dir):
        if args.smoke:
            failed = smoke(args.start, args.perturb, args.trace,
                           args.status_probe, args.device)
        else:
            seeds = list(range(args.start, args.start + args.seeds))
            failed = sweep(
                args.spec, seeds, args.jobs, args.probe_gate, args.perturb,
                trace=args.trace, status_probe=args.status_probe,
                device=args.device, inline=bool(args.profile_dir),
                ledger=args.perf_ledger,
            )
    if args.profile_dir:
        print(f"[perf] torch.profiler trace captured in {args.profile_dir}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
