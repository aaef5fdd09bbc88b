"""Per-signature warm-up seconds (the port's own copy of `record_compile`
and `stats` from foundationdb_tpu.utils.compile_cache).

The JAX package records XLA compiles here. The port compiles nothing
at run time: its kernels are built by `nvcc` into a cache of shared
libraries (`kernels.build_stats()` counts those loads and builds). What
lands here is what a code path knows it warmed, by signature: the wire
ResolverRole's kernel loads and throwaway resolve at start-up
(`resolver_warm/<backend>/txns=<max_txns>`).
"""

from __future__ import annotations

import threading

_stats_lock = threading.Lock()
_signatures: dict[str, float] = {}


def record_compile(signature: str, seconds: float) -> None:
    """Seconds of one warm-up, by signature (the latest one kept)."""
    with _stats_lock:
        _signatures[signature] = float(seconds)


def stats() -> dict:
    """One snapshot: the kernel libraries' build cache (hits, misses,
    the last build's seconds; process-wide) and the per-signature
    warm-up seconds."""
    from foundationdb_tpu_torch import kernels

    with _stats_lock:
        out = dict(kernels.build_stats())
        out["per_signature_compile_seconds"] = dict(_signatures)
    return out
