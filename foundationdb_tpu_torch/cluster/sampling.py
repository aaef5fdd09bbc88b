"""The key-sample sensor block the Resolver roles report (the port's own
copy of `KEY_SAMPLE_LIMIT`, `decay_key_sample`, `printable` and
`key_sample_qos` from foundationdb_tpu.cluster.sampling)."""

from __future__ import annotations

#: key-sample capacity before decay
KEY_SAMPLE_LIMIT = 4096


def decay_key_sample(sample: dict, limit: int = KEY_SAMPLE_LIMIT) -> None:
    """In place: halve every count, dropping zeros; if the key set is
    still too wide, keep the heaviest half. Hot boundaries survive the
    decay while memory stays O(limit)."""
    kept = {k: c // 2 for k, c in sample.items() if c // 2 > 0}
    if len(kept) > limit:
        top = sorted(kept.items(), key=lambda kv: -kv[1])
        kept = dict(top[: limit // 2])
    sample.clear()
    sample.update(kept)


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
