"""Atomic mutation semantics (MutationRef::Type).

Behavioral mirror of the reference's atomic operations
(fdbclient/include/fdbclient/CommitTransaction.h:32-71 MutationRef types;
apply semantics in fdbserver/storageserver.actor.cpp applyMutation /
fdbclient/AtomicOps.h... doAdd/doAnd/...): little-endian arithmetic over
byte strings, zero-extension to the operand length, saturating/wrapping
exactly as the reference does.

The port's own copy of foundationdb_tpu.utils.atomic.
"""

from __future__ import annotations

from typing import Optional

ATOMIC_OPS = (
    "add", "bit_and", "bit_or", "bit_xor", "max", "min",
    "byte_min", "byte_max", "append_if_fits", "compare_and_clear",
)

VALUE_SIZE_LIMIT = 100_000  # CLIENT_KNOBS->VALUE_SIZE_LIMIT


def _le_int(b: bytes) -> int:
    return int.from_bytes(b, "little")


def _pad(b: bytes, n: int) -> bytes:
    return b[:n] + b"\x00" * max(0, n - len(b))


def apply_atomic(op: str, old: Optional[bytes], param: bytes) -> Optional[bytes]:
    """new_value = op(old_value, param); None means 'key absent'."""
    if op == "add":
        # doLittleEndianAdd: absent -> param; wraps modulo 2^(8*len(param))
        if old is None:
            return param
        n = len(param)
        if n == 0:
            return b""
        total = (_le_int(_pad(old, n)) + _le_int(param)) % (1 << (8 * n))
        return total.to_bytes(n, "little")
    if op == "bit_and":
        # doAndV2: absent behaves as zeros
        if old is None:
            return b"\x00" * len(param)
        return bytes(a & b for a, b in zip(_pad(old, len(param)), param))
    if op == "bit_or":
        if old is None:
            return param
        return bytes(a | b for a, b in zip(_pad(old, len(param)), param))
    if op == "bit_xor":
        if old is None:
            return param
        return bytes(a ^ b for a, b in zip(_pad(old, len(param)), param))
    if op == "max":
        # doMax: little-endian unsigned compare at param length
        if old is None or not old:
            return param
        n = len(param)
        return param if _le_int(param) > _le_int(_pad(old, n)) else _pad(old, n)
    if op == "min":
        # doMinV2: absent -> param (sets)
        if old is None:
            return param
        n = len(param)
        return param if _le_int(param) < _le_int(_pad(old, n)) else _pad(old, n)
    if op == "byte_min":
        if old is None:
            return param
        return min(old, param)
    if op == "byte_max":
        if old is None:
            return param
        return max(old, param)
    if op == "append_if_fits":
        base = old or b""
        return base + param if len(base) + len(param) <= VALUE_SIZE_LIMIT else base
    if op == "compare_and_clear":
        # clears the key iff the value equals param
        return None if old == param else old
    raise ValueError(f"unknown atomic op {op!r}")
