"""The key-sample sensor block the Resolver role reports (the port's own
copy of `printable` and `key_sample_qos` from
foundationdb_tpu.cluster.sampling)."""

from __future__ import annotations


def printable(key: bytes) -> str:
    """JSON/terminal-safe rendering of a key: ascii stays, everything
    else escapes."""
    return "".join(
        chr(c) if 32 <= c < 127 else "\\x%02x" % c for c in key
    )


def key_sample_qos(sample: dict, top_n: int = 4) -> dict:
    """The key-sample sensor block: sample width plus the top
    conflict-range begin keys by touch count (printable, bounded)."""
    top = sorted(sample.items(), key=lambda kv: (-kv[1], kv[0]))[:top_n]
    return {
        "keys": len(sample),
        "top": [{"key": printable(k), "count": c} for k, c in top],
    }
