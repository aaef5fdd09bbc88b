"""Named, declarative soak specs: the TOML-test analog (the port's own
copy of foundationdb_tpu.testing.spec, with its spec files under
`testing/specs/`).

The port reads the files with the standard library's `tomllib`, and its
specs spell the device backend "cuda" (the conflict kernels on the card,
or their plain PyTorch versions where a run asks for the CPU) where the
JAX package's spell "tpu-force". The plan a seed draws from a spec is
the JAX package's draw for draw.

The reference drives its correctness ensembles from checked-in TOML
specs (`fdbserver/tester.actor.cpp:2162` readTOMLTests_impl; the files
under `tests/`): a test names its topology knobs, workloads and fault
mix, and Joshua sweeps seeds through it. Here the same contract replaces
what used to be hardcoded probabilities in `plan_for_seed`
(testing/soak.py:83-119 pre-spec): every ensemble run names a spec, the
spec is a reviewable file, and a fault-mix change is a diff to a spec —
never an edit to the derivation code.

A spec declares:

* `[topology]` — inclusive integer ranges the seed draws the cluster
  shape from (proxies, resolvers, storage, replication, tlogs, rounds).
* `[policy]`   — knob randomization / MVCC-window probabilities, the
  resolver backends the ensemble alternates through (so the conflict
  kernels run INSIDE the fault ensemble, not just in packed-batch parity
  suites), and the determinism-pair cadence.
* `[faults]`   — per-fault-class probabilities (the BUGGIFY mix).
* `[workloads]` — auxiliary workload probabilities, including the
  full-client ApiCorrectness workload (testing/api_workload.py).
* `[probes].expected` — CODE_PROBE names this spec exists to reach;
  declared in testing/probe_manifest.json and reported by the soak
  drill's coverage accounting (drills/soak.py).
* `[probes.budgets]` — OPTIONAL per-probe expected occurrence rates
  (probe name -> expected hits per seed, e.g. 0.02 for a probe that
  fires ~2 times per 100 seeds). The `--probe-gate` only FAILS on a
  missed expected probe once the sweep is big enough that the budget
  predicts >= PROBE_GATE_MIN_EXPECTED occurrences — so a short smoke
  sweep can't false-fail on a statistically rare probe, while a full
  sweep still gates it. A probe without a budget gates at any sweep
  size (the pre-budget behavior).

Derivation is order-pinned: `plan_for_seed` draws one value per field
in a single canonical order, so two specs that differ only in numbers
produce comparable plans and a spec edit never reshuffles unrelated
draws for the same seed.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

SPEC_DIR = Path(__file__).resolve().parent / "specs"

#: canonical fault-class draw order (== SeedPlan field order; frozen —
#: append only, a reorder re-randomizes every existing seed's plan)
FAULT_FIELDS = (
    "kill_proxy",
    "kill_tlog",
    "kill_coordinator",
    "clog",
    "reboot_storage",
    "move_shard",
    "duplicate_resolve",
    "coordinator_outage",
    "usurper",
    "laggard_txn",
    "state_squeeze",
    "crash_tlog",
    "slow_storage",
    "tag_quota",
    "silent_kill",
    "tlog_spill",
    "knob_quorum",
    # admission-control fault classes (append-only: new draws land
    # after the existing fault draws)
    "ratekeeper_restart",
    "sensor_dropout",
    "overload_burst",
)

#: canonical auxiliary-workload draw order
WORKLOAD_FIELDS = (
    "sideband",
    "random_clogging",
    "atomic_ops",
    "backup_restore",
    "api",
)

#: topology ranges every spec must pin, in draw order
TOPOLOGY_FIELDS = (
    "storage",
    "replication",
    "commit_proxies",
    "resolvers",
    "tlogs",
    "rounds",
)

#: "cpu" is the host oracle, "cuda" the port's conflict set (ungated: a
#: soak batch is far under RESOLVER_CUDA_MIN_BATCH)
VALID_BACKENDS = ("cpu", "cuda")

#: a budgeted expected probe only gates a sweep once the budget predicts
#: at least this many occurrences across the swept seeds (below that, a
#: miss is statistically unremarkable — e.g. a 0.02/seed probe over the
#: 1-seed smoke lane predicts 0.02 hits, and failing on its absence
#: would be pure noise)
PROBE_GATE_MIN_EXPECTED = 3.0


class SpecError(ValueError):
    """A spec file is malformed: missing/unknown fields, bad types, or
    probe names outside the canonical manifest."""


@dataclasses.dataclass(frozen=True)
class SoakSpec:
    """One named ensemble spec (immutable once loaded)."""

    name: str
    description: str
    # field -> (lo, hi) inclusive
    topology: dict
    # randomize_knobs / small_window probabilities, resolver_backends
    # tuple, determinism_every int
    policy: dict
    # fault field -> probability
    faults: dict
    # workload field -> probability, plus api_actors / api_rounds ints
    workloads: dict
    expected_probes: tuple = ()
    # probe name -> expected occurrences per seed (see PROBE_GATE_MIN_
    # EXPECTED); () == no budgets, every expected probe gates any sweep
    probe_budgets: tuple = ()

    def gated_probes(self, n_seeds: int) -> set:
        """The expected probes the `--probe-gate` may FAIL on for a
        sweep of n_seeds: unbudgeted probes always gate; a budgeted
        probe gates only once n_seeds * budget >= the minimum expected
        occurrence count."""
        budgets = dict(self.probe_budgets)
        return {
            p for p in self.expected_probes
            if p not in budgets
            or n_seeds * budgets[p] >= PROBE_GATE_MIN_EXPECTED
        }

    # -- schema -----------------------------------------------------------

    def validate(self) -> "SoakSpec":
        for f in TOPOLOGY_FIELDS:
            rng = self.topology.get(f)
            if (
                not isinstance(rng, (list, tuple))
                or len(rng) != 2
                or not all(isinstance(v, int) for v in rng)
                or rng[0] > rng[1]
                or rng[0] < 1
            ):
                raise SpecError(
                    f"spec {self.name!r}: topology.{f} must be an "
                    f"inclusive [lo, hi] int range with 1 <= lo <= hi, "
                    f"got {rng!r}"
                )
        unknown = set(self.topology) - set(TOPOLOGY_FIELDS)
        if unknown:
            raise SpecError(
                f"spec {self.name!r}: unknown topology fields {sorted(unknown)}"
            )
        for f in FAULT_FIELDS:
            p = self.faults.get(f)
            if not isinstance(p, (int, float)) or not 0.0 <= p <= 1.0:
                raise SpecError(
                    f"spec {self.name!r}: faults.{f} must be a "
                    f"probability in [0, 1], got {p!r}"
                )
        unknown = set(self.faults) - set(FAULT_FIELDS)
        if unknown:
            raise SpecError(
                f"spec {self.name!r}: unknown fault classes {sorted(unknown)}"
            )
        for f in WORKLOAD_FIELDS:
            p = self.workloads.get(f)
            if not isinstance(p, (int, float)) or not 0.0 <= p <= 1.0:
                raise SpecError(
                    f"spec {self.name!r}: workloads.{f} must be a "
                    f"probability in [0, 1], got {p!r}"
                )
        for f in ("api_actors", "api_rounds"):
            v = self.workloads.get(f)
            if not isinstance(v, int) or v < 1:
                raise SpecError(
                    f"spec {self.name!r}: workloads.{f} must be a "
                    f"positive int, got {v!r}"
                )
        # OPTIONAL workloads (append-only: drawn AFTER every
        # pre-existing field, from the tail of the rng stream, so specs
        # without the key keep byte-identical plans)
        if "ycsb_d" in self.workloads:
            p = self.workloads["ycsb_d"]
            if not isinstance(p, (int, float)) or not 0.0 <= p <= 1.0:
                raise SpecError(
                    f"spec {self.name!r}: workloads.ycsb_d must be a "
                    f"probability in [0, 1], got {p!r}"
                )
        unknown = set(self.workloads) - set(WORKLOAD_FIELDS) - {
            "api_actors", "api_rounds", "ycsb_d"
        }
        if unknown:
            raise SpecError(
                f"spec {self.name!r}: unknown workload fields {sorted(unknown)}"
            )
        for f in ("randomize_knobs", "small_window"):
            p = self.policy.get(f)
            if not isinstance(p, (int, float)) or not 0.0 <= p <= 1.0:
                raise SpecError(
                    f"spec {self.name!r}: policy.{f} must be a "
                    f"probability in [0, 1], got {p!r}"
                )
        backends = self.policy.get("resolver_backends")
        if (
            not isinstance(backends, (list, tuple))
            or not backends
            or not all(b in VALID_BACKENDS for b in backends)
        ):
            raise SpecError(
                f"spec {self.name!r}: policy.resolver_backends must be a "
                f"non-empty list from {VALID_BACKENDS}, got {backends!r}"
            )
        de = self.policy.get("determinism_every")
        if not isinstance(de, int) or de < 1:
            raise SpecError(
                f"spec {self.name!r}: policy.determinism_every must be a "
                f"positive int, got {de!r}"
            )
        audit = self.policy.get("audit")
        if not isinstance(audit, bool):
            raise SpecError(
                f"spec {self.name!r}: policy.audit must be a bool (the "
                f"interleaving-auditor knob), got {audit!r}"
            )
        sweep = self.policy.get("kernel_range_sweep", False)
        if not isinstance(sweep, bool):
            raise SpecError(
                f"spec {self.name!r}: policy.kernel_range_sweep must be "
                f"a bool (cuda seeds arm the sorted-endpoint sweep + "
                f"spill-and-compact kernel instead of the dedup probe), "
                f"got {sweep!r}"
            )
        unknown = set(self.policy) - {
            "randomize_knobs", "small_window", "resolver_backends",
            "determinism_every", "audit", "kernel_range_sweep",
        }
        if unknown:
            raise SpecError(
                f"spec {self.name!r}: unknown policy fields {sorted(unknown)}"
            )
        if not all(isinstance(p, str) for p in self.expected_probes):
            raise SpecError(
                f"spec {self.name!r}: probes.expected must be strings"
            )
        for p, rate in self.probe_budgets:
            if p not in self.expected_probes:
                raise SpecError(
                    f"spec {self.name!r}: probes.budgets names {p!r} "
                    f"which is not in probes.expected"
                )
            if not isinstance(rate, (int, float)) or not 0.0 < rate <= 1.0:
                raise SpecError(
                    f"spec {self.name!r}: probes.budgets.{p} must be an "
                    f"expected per-seed rate in (0, 1], got {rate!r}"
                )
        return self

    # -- (de)serialization ------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "description": self.description,
            "topology": {k: list(v) for k, v in sorted(self.topology.items())},
            "policy": {
                k: (list(v) if isinstance(v, (list, tuple)) else v)
                for k, v in sorted(self.policy.items())
            },
            "faults": dict(sorted(self.faults.items())),
            "workloads": dict(sorted(self.workloads.items())),
            "probes": {
                "expected": sorted(self.expected_probes),
                **(
                    {"budgets": dict(sorted(self.probe_budgets))}
                    if self.probe_budgets else {}
                ),
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SoakSpec":
        try:
            spec = cls(
                name=d["name"],
                description=d.get("description", ""),
                topology={k: tuple(v) for k, v in d["topology"].items()},
                policy={
                    k: (tuple(v) if isinstance(v, list) else v)
                    for k, v in d["policy"].items()
                },
                faults=dict(d["faults"]),
                workloads=dict(d["workloads"]),
                expected_probes=tuple(
                    sorted(d.get("probes", {}).get("expected", ()))
                ),
                probe_budgets=tuple(
                    sorted(
                        d.get("probes", {}).get("budgets", {}).items()
                    )
                ),
            )
        except (KeyError, TypeError, AttributeError) as e:
            raise SpecError(f"malformed spec dict: {e!r}")
        return spec.validate()

    def with_overrides(self, *, rounds: tuple = None,
                       api_rounds: int = None,
                       api: float = None) -> "SoakSpec":
        """A shallow variant (the smoke lane shortens runs and forces
        the api workload on without forking spec files)."""
        topology = dict(self.topology)
        if rounds is not None:
            topology["rounds"] = tuple(rounds)
        workloads = dict(self.workloads)
        if api_rounds is not None:
            workloads["api_rounds"] = api_rounds
        if api is not None:
            workloads["api"] = api
        return dataclasses.replace(
            self, topology=topology, workloads=workloads
        ).validate()


def list_specs() -> list[str]:
    """Names of every checked-in spec (testing/specs/*.toml)."""
    return sorted(p.stem for p in SPEC_DIR.glob("*.toml"))


def load_spec(name) -> SoakSpec:
    """Load a named spec (or pass a SoakSpec through unchanged)."""
    if isinstance(name, SoakSpec):
        return name
    import tomllib

    path = SPEC_DIR / f"{name}.toml"
    if not path.exists():
        raise SpecError(
            f"no such spec {name!r}; checked in: {list_specs()}"
        )
    with open(path, "rb") as f:
        d = tomllib.load(f)
    if d.get("name") != name:
        raise SpecError(
            f"spec file {path.name} declares name={d.get('name')!r}; "
            f"the name must match the file stem"
        )
    return SoakSpec.from_dict(d)


def derive_plan_fields(seed: int, spec: SoakSpec) -> dict:
    """Everything a seed decides, derived from (seed, spec) in the
    canonical draw order. Returns kwargs for testing.soak.SeedPlan.

    Draw discipline: exactly one rng draw per field, in a frozen order,
    regardless of the spec's values — so a probability edit in a spec
    changes only its own field's outcome for any given seed.
    """
    r = np.random.default_rng(seed ^ 0x5EED)
    t = spec.topology

    def draw_int(lo_hi) -> int:
        lo, hi = lo_hi
        return int(r.integers(lo, hi + 1))

    n_storage = draw_int(t["storage"])
    rep_lo, rep_hi = t["replication"]
    replication = min(draw_int((rep_lo, rep_hi)), n_storage)
    fields = {
        "n_storage": n_storage,
        "replication": replication,
        "n_commit_proxies": draw_int(t["commit_proxies"]),
        "n_resolvers": draw_int(t["resolvers"]),
        "n_tlogs": draw_int(t["tlogs"]),
        "rounds": draw_int(t["rounds"]),
    }
    for f in FAULT_FIELDS:
        fields[f] = bool(r.random() < spec.faults[f])
    fields["randomize_knobs"] = bool(
        r.random() < spec.policy["randomize_knobs"]
    )
    fields["small_window"] = bool(r.random() < spec.policy["small_window"])
    for f in WORKLOAD_FIELDS:
        fields[f] = bool(r.random() < spec.workloads[f])
    backends = spec.policy["resolver_backends"]
    # always one draw, even for a single-backend spec (order pinning)
    fields["resolver_backend"] = backends[int(r.integers(0, len(backends)))]
    fields["api_actors"] = int(spec.workloads["api_actors"])
    fields["api_rounds"] = int(spec.workloads["api_rounds"])
    fields["spec_name"] = spec.name
    # OPTIONAL draws come LAST (one draw each, unconditionally —
    # the draw-order discipline): every pre-existing field above reads
    # the identical rng stream, so old specs' plans are byte-stable
    fields["ycsb_d"] = bool(r.random() < spec.workloads.get("ycsb_d", 0.0))
    return fields
