"""CODE_PROBE: rare-path coverage marks (the port's own registry, a copy
of foundationdb_tpu.utils.probes).

The reference marks rare-but-important code paths with
`CODE_PROBE(cond, "msg")` (flow/include/flow/CodeProbe.h), and an
ensemble asserts that every probe fires somewhere. Same contract here:

* `declare(name)` registers a probe when its module is imported, so a
  probe whose code never runs still shows up as a miss.
* `code_probe(cond, name)` marks a hit when cond is truthy (and
  registers an undeclared name).
* `snapshot()` reads the counts, `missed()` names the declared probes
  that never fired, `reset()` zeroes every count (the soak resets per
  seed) and `merge(counts)` folds a worker's snapshot in (the soak
  drill's process pool).

The registry is this package's: the JAX package keeps its own, and
neither reads the other.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
#: probe name -> hits; a declared probe that never fired is at 0
_hits: dict[str, int] = {}


def declare(*names: str) -> None:
    with _lock:
        for n in names:
            _hits.setdefault(n, 0)


def code_probe(cond, name: str) -> bool:
    """Record a hit when cond is truthy; returns bool(cond) for inlining
    into existing conditionals."""
    ok = bool(cond)
    if ok:
        with _lock:
            _hits[name] = _hits.get(name, 0) + 1
    return ok


def snapshot() -> dict[str, int]:
    with _lock:
        return dict(_hits)


def missed() -> list[str]:
    with _lock:
        return sorted(n for n, c in _hits.items() if not c)


def reset() -> None:
    with _lock:
        for n in _hits:
            _hits[n] = 0


def merge(other: dict[str, int]) -> None:
    """Fold a child run's snapshot into this process's counts."""
    with _lock:
        for n, c in other.items():
            _hits[n] = _hits.get(n, 0) + c
