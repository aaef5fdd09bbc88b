"""The perf ledger: one canonical run-record schema (the port's own copy
of the core of foundationdb_tpu.utils.perf).

The port's drills (soak `--trace`, saturation, hotspot, chaos,
elasticity) emit their headline numbers through `emit()` / `append()`
into one append-only JSONL ledger. A row is self-describing:

* `schema_version` — bump on any incompatible shape change.
* `source` — which drill produced it ("soak", "saturation", "hotspot",
  "chaos_pipeline", "elasticity_drill").
* `git_sha` / `timestamp` — provenance (imported rows carry `timestamp:
  null` and `imported_from`).
* `fingerprint` — the host and device identity a comparator needs so a
  CPU structural run is never compared with a run on the card: backend,
  device kind and count, torch and CUDA versions, python, machine.
* `workload` — the shapes that make two runs comparable.
* `knobs` — the knob fingerprint: a knob change is a different
  experiment, not noise.
* `experiment` — optional: the search this row is a trial of. Trial rows
  never enter a baseline window.
* `metrics` — a flat name -> {value, unit, direction, tier} map.
  direction is "higher" | "lower" (which way is better); tier is
  "structural" (deterministic on any host, compared exactly) or
  "hardware" (wall clock, compared inside a median + MAD band, only
  between rows whose fingerprints match).

`compare()` selects the baseline window by fingerprint key, applies the
median + MAD band a metric, and names the regressions; the
`perf.regression_gate_tripped` probe fires on any.

The default ledger is `foundationdb_tpu_torch/perf/history.jsonl`
(git-ignored), never the JAX package's `perf/history.jsonl`.
`FDBTPU_PERF_DIR` moves the directory and `FDBTPU_PERF_LEDGER` names
the file, as in the JAX package.

Against the JAX module: the fingerprint carries `torch_version` and
`cuda_version` where JAX's carries `jax_version` and `jaxlib_version`
(`HARDWARE_FP_KEYS` names `torch_version`); `profile_trace` is a
`torch.profiler` session that writes a chrome trace; and
`device_memory_stats` reads `torch.cuda.memory_stats` under JAX's key
names.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Optional

from foundationdb_tpu_torch.utils.probes import code_probe, declare

declare("perf.regression_gate_tripped")

SCHEMA_VERSION = 1

#: metrics directions: which way is better
DIRECTIONS = ("higher", "lower")
#: structural = deterministic on any host (exact compare);
#: hardware = wall clock (noise-banded, fingerprint-gated)
TIERS = ("structural", "hardware")

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)

#: fingerprint fields that make hardware-tier rows comparable: another
#: device kind or count, or another torch, is another experiment
HARDWARE_FP_KEYS = ("backend", "device_kind", "device_count",
                    "torch_version")
#: the fingerprint keys every row carries
FINGERPRINT_KEYS = ("backend", "device_kind", "device_count",
                    "torch_version", "cuda_version")


def perf_dir() -> str:
    return os.environ.get("FDBTPU_PERF_DIR", os.path.join(_PKG_ROOT, "perf"))


def history_path() -> str:
    """The ledger file. `FDBTPU_PERF_LEDGER` redirects every emitter at
    once (a smoke run points it at a temporary file)."""
    return os.environ.get(
        "FDBTPU_PERF_LEDGER", os.path.join(perf_dir(), "history.jsonl")
    )


# ---------------------------------------------------------------------------
# Fingerprints.


def device_fingerprint() -> dict:
    """The host and device identity for a ledger row, from
    `device.fingerprint`: on the card its name and the card count, else
    the CPU. Never raises: a host where torch fails still gets a row
    (backend "none")."""
    import platform

    fp = {
        "backend": "none",
        "device_kind": None,
        "device_count": 0,
        "torch_version": None,
        "cuda_version": None,
        "python_version": platform.python_version(),
        "machine": platform.machine(),
    }
    try:
        import torch

        from foundationdb_tpu_torch import device as devmod

        fp["torch_version"] = torch.__version__
        fp["cuda_version"] = torch.version.cuda
        on_card = torch.cuda.is_available()
        dev = devmod.fingerprint(None if on_card else "cpu")
        fp["backend"] = "cuda" if on_card else "cpu"
        fp["device_count"] = torch.cuda.device_count() if on_card else 1
        fp["device_kind"] = dev["name"]
    except Exception:
        pass
    return fp


def _git_sha() -> Optional[str]:
    try:
        import subprocess

        return subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=_REPO_ROOT,
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or None
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Records.


def metric(value, unit: str, direction: str = "lower",
           tier: str = "hardware") -> dict:
    """One metrics-map entry; validated again at append time."""
    if direction not in DIRECTIONS:
        raise ValueError(f"direction must be one of {DIRECTIONS}")
    if tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}")
    return {"value": value, "unit": unit, "direction": direction,
            "tier": tier}


_NOW = object()  # sentinel: stamp at build time


def make_record(source: str, metrics: dict, *, workload: dict = None,
                knobs: dict = None, fingerprint: dict = None,
                timestamp=_NOW, git_sha=None,
                imported_from: str = None, extra: dict = None,
                experiment: str = None) -> dict:
    """Assemble one schema-valid ledger row. Imported rows carry
    `timestamp: null` / `git_sha: null` (unless given), so an import is
    byte-stable. `experiment` marks the row a trial."""
    rec = {
        "schema_version": SCHEMA_VERSION,
        "source": source,
        "git_sha": git_sha if (git_sha or imported_from) else _git_sha(),
        "timestamp": (
            None if imported_from
            else (round(time.time(), 3) if timestamp is _NOW
                  else timestamp)
        ),
        "fingerprint": (
            fingerprint if fingerprint is not None else device_fingerprint()
        ),
        "workload": workload or {},
        "knobs": knobs or {},
        "metrics": metrics,
    }
    if imported_from:
        rec["imported_from"] = imported_from
    if experiment:
        rec["experiment"] = experiment
    if extra:
        rec["extra"] = extra
    validate_record(rec)
    return rec


def validate_record(rec: dict) -> None:
    """Raise ValueError (naming every problem) unless `rec` is a
    schema-valid ledger row."""
    problems = []
    if rec.get("schema_version") != SCHEMA_VERSION:
        problems.append(
            f"schema_version must be {SCHEMA_VERSION}, "
            f"got {rec.get('schema_version')!r}"
        )
    if not rec.get("source") or not isinstance(rec.get("source"), str):
        problems.append("source must be a non-empty string")
    fp = rec.get("fingerprint")
    if not isinstance(fp, dict):
        problems.append("fingerprint must be a dict")
    else:
        for key in FINGERPRINT_KEYS:
            if key not in fp:
                problems.append(f"fingerprint missing {key!r}")
    for key in ("workload", "knobs"):
        if not isinstance(rec.get(key), dict):
            problems.append(f"{key} must be a dict")
    if "experiment" in rec and not (
        isinstance(rec["experiment"], str) and rec["experiment"]
    ):
        problems.append("experiment must be a non-empty string when present")
    metrics = rec.get("metrics")
    if not isinstance(metrics, dict) or not metrics:
        problems.append("metrics must be a non-empty dict")
    else:
        for name, m in metrics.items():
            if not isinstance(m, dict):
                problems.append(f"metric {name!r} must be a dict")
                continue
            if not isinstance(m.get("value"), (int, float)) or isinstance(
                m.get("value"), bool
            ):
                problems.append(f"metric {name!r} value must be a number")
            if m.get("direction") not in DIRECTIONS:
                problems.append(
                    f"metric {name!r} direction must be one of {DIRECTIONS}"
                )
            if m.get("tier") not in TIERS:
                problems.append(
                    f"metric {name!r} tier must be one of {TIERS}"
                )
            if "unit" not in m:
                problems.append(f"metric {name!r} missing unit")
    if problems:
        raise ValueError(
            "invalid perf record: " + "; ".join(problems)
        )


def append(rec: dict, path: str = None) -> str:
    """Validate + append one row to the ledger; returns the path."""
    validate_record(rec)
    path = path or history_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")
    return path


def emit(source: str, metrics: dict, *, workload: dict = None,
         knobs: dict = None, ledger: str = None, extra: dict = None,
         experiment: str = None) -> dict:
    """The one call every drill makes: build a row for this host and
    append it to the ledger (or `ledger` / $FDBTPU_PERF_LEDGER)."""
    rec = make_record(source, metrics, workload=workload, knobs=knobs,
                      extra=extra, experiment=experiment)
    append(rec, path=ledger)
    return rec


def load_history(path: str = None) -> list[dict]:
    """All ledger rows, oldest first. Strict: a malformed line is a
    corrupted ledger, not noise to skip."""
    path = path or history_path()
    if not os.path.exists(path):
        return []
    rows = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: malformed ledger line "
                                 f"({e})") from e
    return rows


# ---------------------------------------------------------------------------
# Baseline selection + the noise-aware comparator.


def fingerprint_key(rec: dict, tier: str) -> tuple:
    """The comparability key for baseline selection: (source, workload,
    knobs), and for the hardware tier the device identity too (wall-clock
    rates compare only within one backend, device kind and count and
    torch version)."""
    key = (
        rec.get("source"),
        json.dumps(rec.get("workload", {}), sort_keys=True),
        json.dumps(rec.get("knobs", {}), sort_keys=True),
    )
    if tier == "hardware":
        fp = rec.get("fingerprint", {})
        key += tuple(fp.get(k) for k in HARDWARE_FP_KEYS)
    return key


def baseline_window(history: list[dict], candidate: dict, *, tier: str,
                    window: int = 8) -> list[dict]:
    """The most recent `window` ledger rows comparable to `candidate` at
    `tier` (matching fingerprint key, same schema). Rows with another
    fingerprint are ignored, never "close enough"; experiment rows are
    never baselines."""
    want = fingerprint_key(candidate, tier)
    matched = [
        r for r in history
        if r.get("schema_version") == candidate.get("schema_version")
        and not r.get("experiment")
        and fingerprint_key(r, tier) == want
    ]
    return matched[-window:]


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def _mad(xs: list[float], med: float) -> float:
    return _median([abs(x - med) for x in xs])


def compare(candidate: dict, history: list[dict], *, tier: str,
            window: int = 8, k_mad: float = 4.0,
            rel_floor: float = None) -> dict:
    """Noise-aware regression check of one candidate row against the
    ledger.

    A metric of `candidate` at `tier` regresses when it lands outside
    median +/- max(k_mad * 1.4826 * MAD, rel_floor * |median|) of its
    matching-fingerprint baseline window, in the worse direction
    (improvements never fail). Defaults: structural rel_floor 0.0
    (deterministic values compare exactly), hardware 0.05.

    Returns {"tier", "baseline_rows", "metrics": {name: {...}},
    "regressions": [names]}; fires perf.regression_gate_tripped on any
    regression. A candidate with no comparable baseline reports every
    metric "new" and passes.
    """
    if rel_floor is None:
        rel_floor = 0.0 if tier == "structural" else 0.05
    base = baseline_window(history, candidate, tier=tier, window=window)
    out: dict[str, Any] = {
        "tier": tier,
        "baseline_rows": len(base),
        "metrics": {},
        "regressions": [],
    }
    for name, m in sorted(candidate.get("metrics", {}).items()):
        if m.get("tier") != tier:
            continue
        samples = [
            float(r["metrics"][name]["value"]) for r in base
            if name in r.get("metrics", {})
        ]
        entry: dict[str, Any] = {
            "value": float(m["value"]),
            "unit": m.get("unit"),
            "direction": m.get("direction"),
            "n_baseline": len(samples),
        }
        if not samples:
            entry["status"] = "new"
            out["metrics"][name] = entry
            continue
        med = _median(samples)
        band = max(
            k_mad * 1.4826 * _mad(samples, med), rel_floor * abs(med)
        )
        entry.update(baseline_median=med, band=band)
        value = float(m["value"])
        worse = (
            value < med - band if m.get("direction") == "higher"
            else value > med + band
        )
        better = (
            value > med + band if m.get("direction") == "higher"
            else value < med - band
        )
        entry["status"] = (
            "regression" if worse else "improved" if better else "ok"
        )
        if worse:
            out["regressions"].append(name)
        out["metrics"][name] = entry
    code_probe(out["regressions"], "perf.regression_gate_tripped")
    return out


# ---------------------------------------------------------------------------
# Device profiling hooks.


@contextlib.contextmanager
def _torch_trace(profile_dir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # no shapes, memory or stacks recorded: the session keeps no tensor
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def profile_trace(profile_dir: Optional[str]):
    """Context manager: a `torch.profiler` session over the block (CPU,
    and CUDA where there is a card) that writes a chrome trace into
    `profile_dir`; a no-op when no directory is given."""
    if not profile_dir:
        return contextlib.nullcontext()
    return _torch_trace(profile_dir)


def device_memory_stats(device=None) -> dict:
    """Live and peak device memory of one card, under the JAX module's
    key names ({"bytes_in_use", "peak_bytes_in_use", "bytes_limit",
    "num_allocs"}). Empty on the CPU: samplers treat empty as "nothing
    to record", never an error."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    out = {"bytes_limit": int(
        torch.cuda.get_device_properties(device).total_memory)}
    for key, src in (("bytes_in_use", "allocated_bytes.all.current"),
                     ("peak_bytes_in_use", "allocated_bytes.all.peak"),
                     ("num_allocs", "allocation.all.allocated")):
        if src in stats:
            out[key] = int(stats[src])
    return out


# ---------------------------------------------------------------------------
# Converters: one row shape a drill.


def _cpu_fingerprint() -> dict:
    return {
        "backend": "cpu", "device_kind": None, "device_count": 0,
        "torch_version": None, "cuda_version": None,
        "python_version": None, "machine": None,
    }


def saturation_report_to_record(rep: dict, *, imported_from: str = None,
                                fingerprint: dict = None) -> dict:
    """testing/saturation report (one direction) -> ledger record.
    Everything is structural: the ramp runs on the deterministic virtual
    clock, so p99s and shed counts are exact a seed."""
    if fingerprint is None:
        fingerprint = _cpu_fingerprint()
    steps = rep.get("steps") or []
    worst_p99 = max((s.get("commit_p99_s", 0.0) for s in steps),
                    default=0.0)
    metrics = {
        "peak_goodput_tps": metric(rep.get("peak_goodput_tps", 0.0), "tps",
                                   "higher", tier="structural"),
        "worst_commit_p99_s": metric(worst_p99, "s", "lower",
                                     tier="structural"),
        "shed_total": metric(sum(s.get("shed", 0) for s in steps), "txns",
                             "lower", tier="structural"),
        "too_old_total": metric(
            sum(s.get("too_old", 0) for s in steps), "txns", "lower",
            tier="structural",
        ),
        "committed_total": metric(
            sum(s.get("committed", 0) for s in steps), "txns", "higher",
            tier="structural",
        ),
        "slo_passed": metric(
            int(bool((rep.get("slo") or {}).get("passed"))), "bool",
            # the OFF direction is supposed to violate; the direction is
            # meaningful only a leg, which the workload names
            "higher" if rep.get("admission") else "lower",
            tier="structural",
        ),
    }
    return make_record(
        "saturation", metrics,
        workload={
            "spec": rep.get("spec"),
            "seed": rep.get("seed"),
            "admission": bool(rep.get("admission")),
            "ramp": rep.get("ramp"),
            "step_seconds": rep.get("step_seconds"),
        },
        knobs=rep.get("config") or {},
        fingerprint=fingerprint, imported_from=imported_from,
    )


def hotspot_report_to_record(rep: dict, *, imported_from: str = None,
                             fingerprint: dict = None) -> dict:
    """testing/hotspot report (one leg) -> ledger record: the sampling
    overhead envelope. Only the sim legs are structural (the byte sample
    is a pure function of seed, key and size, and the tag counters run
    on the virtual clock); wire legs use wall-entropy sampling seeds."""
    if fingerprint is None:
        fingerprint = _cpu_fingerprint()
    samp = rep.get("sampling") or {}
    skewed = rep.get("direction") == "zipf"
    metrics = {
        "sample_keys": metric(samp.get("sample_keys", 0), "keys", "lower",
                              tier="structural"),
        "sampled_bytes": metric(samp.get("sampled_bytes", 0), "bytes",
                                "lower", tier="structural"),
        "committed": metric(rep.get("committed", 0), "txns", "higher",
                            tier="structural"),
        # the verdict itself: the zipf leg is supposed to attribute, the
        # uniform leg to stay quiet
        "attributed": metric(
            int(bool((rep.get("attribution") or {}).get("attributed"))),
            "bool", "higher" if skewed else "lower", tier="structural",
        ),
    }
    for name, unit in (
        ("byte_sample_writes", "writes"),
        ("tag_counter_tags", "tags"),
        ("tag_notes", "notes"),
        ("tag_bytes_noted", "bytes"),
        ("resolver_key_sample_keys", "keys"),
    ):
        if name in samp:
            metrics[name] = metric(samp[name], unit, "lower",
                                   tier="structural")
    cfg = rep.get("config") or {}
    return make_record(
        "hotspot", metrics,
        workload={
            "spec": rep.get("spec", "hotspot"),
            "seed": rep.get("seed"),
            "path": rep.get("path"),
            "direction": rep.get("direction"),
            "txns": cfg.get("txns"),
            "value_bytes": cfg.get("value_bytes"),
        },
        knobs=cfg,
        fingerprint=fingerprint, imported_from=imported_from,
    )
