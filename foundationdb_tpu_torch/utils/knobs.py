"""Knobs: named, typed runtime constants (the port's own copy of the
server knobs that the Resolver role, the conflict-set factory, the
stream router, the wire commit path and the simulated cluster read, from
foundationdb_tpu.utils.knobs).

Behavioral mirror of the reference's knob system (`flow/Knobs.cpp`,
`fdbclient/ServerKnobs.cpp`): every tunable is a named constant whose
type is its default's; `set` is `--knob_<name>=<value>`, and
`apply_env_overrides` reads FDBTPU_KNOB_OVERRIDES in a role process.

The port's spelling of the device: `RESOLVER_BACKEND` takes "cuda" (the
card, gated by `RESOLVER_CUDA_MIN_BATCH`) or "cpu" (the host oracle);
`RESOLVER_CUDA_MIN_BATCH` is the JAX package's `RESOLVER_TPU_MIN_BATCH`,
with the same default. Every other default is the JAX package's.

Under simulation a seeded share of the knobs take random values
(`randomize_under_test`, the reference's `randomize && BUGGIFY`). The
knobs that randomize, their choices and their order are the JAX
package's, so a seed draws the same values in both packages; the two
transaction-life knobs are defined only for that (the sequencer keeps
its own constant, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional

import numpy as np


@dataclasses.dataclass
class _KnobDef:
    name: str
    default: Any
    ktype: type
    randomize: Optional[Callable[[np.random.Generator], Any]] = None


class Knobs:
    """A named knob collection (the SERVER_KNOBS shape)."""

    def __init__(self, name: str):
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_defs", {})
        object.__setattr__(self, "_values", {})

    def define(self, name: str, default, *, randomize=None) -> None:
        self._defs[name] = _KnobDef(name, default, type(default), randomize)
        self._values[name] = default

    def __getattr__(self, name: str):
        try:
            return object.__getattribute__(self, "_values")[name]
        except KeyError:
            raise AttributeError(f"unknown knob {name!r}") from None

    def __setattr__(self, name: str, value) -> None:
        self.set(name, value)

    def set(self, name: str, value) -> None:
        """--knob_<name>=<value> (type-checked against the default)."""
        if name not in self._defs:
            raise KeyError(f"unknown knob {name!r}")
        d = self._defs[name]
        if not isinstance(value, d.ktype):
            value = d.ktype(value)
        self._values[name] = value

    def reset(self) -> None:
        for n, d in self._defs.items():
            self._values[n] = d.default

    def randomize_under_test(self, rng: np.random.Generator,
                             prob: float = 0.5) -> dict:
        """Seeded knob randomization: each knob with a randomizer, in
        definition order, takes a random value with probability `prob`.
        Returns {name: value} of what was chosen."""
        chosen = {}
        for n, d in self._defs.items():
            if d.randomize is not None and rng.random() < prob:
                self._values[n] = chosen[n] = d.randomize(rng)
        return chosen

    def as_dict(self) -> dict:
        return dict(self._values)

    def apply_env_overrides(self, env_var: str = None) -> dict:
        """Apply `NAME=value;NAME=value` overrides from an environment
        variable (default FDBTPU_KNOB_OVERRIDES): how a launcher's knob
        settings reach a role process, a fresh interpreter with the
        defaults. Values are coerced by set()'s type check; a boolean
        takes true/false/1/0/yes/no/on/off and anything else raises.
        Returns {name: value} of what was applied."""
        raw = os.environ.get(env_var or "FDBTPU_KNOB_OVERRIDES", "")
        applied = {}
        for part in raw.split(";"):
            part = part.strip()
            if not part:
                continue
            name, _, value = part.partition("=")
            name, value = name.strip(), value.strip()
            d = self._defs.get(name)
            if d is not None and d.ktype is bool:
                # bool("False") is True: an env string needs parsing,
                # and an unknown spelling is a config error
                lowered = value.lower()
                if lowered in ("1", "true", "yes", "on"):
                    parsed = True
                elif lowered in ("0", "false", "no", "off"):
                    parsed = False
                else:
                    raise ValueError(
                        f"knob {name!r}: {value!r} is not a boolean "
                        "(use true/false/1/0)"
                    )
                self.set(name, parsed)
            else:
                self.set(name, value)
            applied[name] = self._values[name]
        return applied


def make_server_knobs() -> Knobs:
    """The knobs the Resolver role, the wire commit path and the simulated
    cluster's roles read, with
    the reference's defaults (fdbclient/ServerKnobs.cpp)."""
    k = Knobs("ServerKnobs")
    # the MVCC window's versions (ServerKnobs.cpp:43-44); read by nothing
    # here, defined so that randomize_under_test draws as the JAX
    # package's does
    k.define(
        "MAX_READ_TRANSACTION_LIFE_VERSIONS", 5_000_000,
        randomize=lambda r: int(r.choice([1_000_000, 2_000_000, 5_000_000])),
    )
    k.define(
        "MAX_WRITE_TRANSACTION_LIFE_VERSIONS", 5_000_000,
        randomize=lambda r: int(r.choice([1_000_000, 2_000_000, 5_000_000])),
    )
    # state-transaction bytes a resolver holds before it delays new
    # batches (Resolver.actor.cpp:254-268)
    k.define("RESOLVER_STATE_MEMORY_LIMIT", 1_000_000)
    # the resolver_backend knob: "cuda" | "cpu"
    k.define("RESOLVER_BACKEND", "cuda")
    # below this batch capacity the knob's "cuda" serves the CPU backend
    # instead (make_conflict_set's gate, route_stream): the JAX
    # package's measured single-dispatch crossover, kept as its default
    k.define("RESOLVER_CUDA_MIN_BATCH", 65536)
    # encryption at rest (fdbclient/ServerKnobs.cpp ENABLE_ENCRYPTION,
    # fdbserver/EncryptKeyProxy.actor.cpp): the storage WAL, checkpoint
    # and LSM values and the tlog's records are AES-256-CTR sealed under
    # keys the EncryptKeyProxy serves. spawn_role turns it into a role
    # process's --encrypt; not randomized (the sim's storage has no disk)
    k.define("ENABLE_ENCRYPTION", False)
    # encryption keys re-derive under a fresh salt after this many
    # seconds (ServerKnobs ENCRYPT_KEY_REFRESH_INTERVAL)
    k.define("ENCRYPT_KEY_REFRESH_INTERVAL", 600.0)
    # version-vector unicast: replies carry tpcvMap + writtenTags
    # (ResolverInterface.h:140-151); off, as in the reference
    k.define("ENABLE_VERSION_VECTOR_TLOG_UNICAST", False)
    # Adaptive commit batching (the reference's dynamic commitBatcher,
    # fdbserver/CommitProxyServer.actor.cpp:361 + ServerKnobs
    # COMMIT_TRANSACTION_BATCH_*): the ProxyPipeline's interval shrinks
    # while batches fill early and relaxes when they go out underfull;
    # the count and bytes targets follow the measured resolve + log
    # stage latency. These bound every movement.
    k.define(
        "COMMIT_TRANSACTION_BATCH_INTERVAL_MIN", 0.001,
        randomize=lambda r: float(r.choice([0.001, 0.005, 0.01])),
    )
    k.define(
        "COMMIT_TRANSACTION_BATCH_INTERVAL_MAX", 0.020,
        randomize=lambda r: float(r.choice([0.010, 0.020, 0.050])),
    )
    k.define("COMMIT_TRANSACTION_BATCH_INTERVAL_SMOOTHER_ALPHA", 0.1)
    # the interval tracks this fraction of the smoothed resolve + log
    # stage latency: a slow stage earns a longer window (bigger batches
    # amortize a fixed cost a dispatch), a fast one shrinks toward MIN
    k.define("COMMIT_TRANSACTION_BATCH_INTERVAL_LATENCY_FRACTION", 0.1)
    k.define("COMMIT_TRANSACTION_BATCH_COUNT_MAX", 32768)
    k.define("COMMIT_TRANSACTION_BATCH_BYTES_MAX", 8 << 20)
    # the resolve + log seconds a batch may take while its count and
    # bytes targets still grow
    k.define("COMMIT_BATCH_STAGE_LATENCY_BUDGET", 0.100)
    # the bounded GRV front-door queue (START_TRANSACTION_MAX_QUEUE_SIZE):
    # read-version requests past this depth are shed with the retryable
    # GrvThrottledError instead of queueing without bound
    k.define("GRV_PROXY_MAX_QUEUE", 8192)
    # commit batches in flight at once through resolve -> tlog push ->
    # reply, ordered only at the version-chain hand-offs
    k.define("MAX_PIPELINED_COMMIT_BATCHES", 16)
    # GRV batching follows the same controller (GrvProxyServer's
    # START_TRANSACTION_BATCH_* discipline)
    k.define("START_TRANSACTION_BATCH_INTERVAL_MIN", 0.0005)
    k.define(
        "START_TRANSACTION_BATCH_INTERVAL_MAX", 0.010,
        randomize=lambda r: float(r.choice([0.005, 0.010, 0.020])),
    )
    k.define("START_TRANSACTION_BATCH_INTERVAL_SMOOTHER_ALPHA", 0.1)
    k.define("START_TRANSACTION_BATCH_COUNT_MAX", 65536)
    # retained in-memory tlog bytes past which a log spills its oldest
    # entries to its simulated disk (TLogServer's spill discipline)
    k.define(
        "TLOG_SPILL_THRESHOLD", 1_000_000,
        randomize=lambda r: int(r.choice([20, 100, 1_000, 1_000_000])),
    )
    # a commit proxy replays a recent resolve request as a duplicate
    # (the resolver must answer it from its reply cache)
    k.define("BUGGIFY_DUPLICATE_RESOLVE", False)
    # resolver-generated private mutations and the resolver-side
    # txnStateStore (ServerKnobs.cpp:549-550); off by default, randomized
    # under test there too
    k.define(
        "PROXY_USE_RESOLVER_PRIVATE_MUTATIONS", False,
        randomize=lambda r: bool(r.integers(0, 2)),
    )
    return k


SERVER_KNOBS = make_server_knobs()
