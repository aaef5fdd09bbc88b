"""The tuple layer: order-preserving typed key encoding.

Behavioral mirror of the reference's tuple layer (every binding ships
one — e.g. bindings/python/fdb/tuple.py, design/tuple.md): typed values
encode to byte strings whose lexicographic order equals the natural
order of the tuples. Type codes and byte layouts follow the tuple spec
so keys are wire-compatible with the reference's bindings:

  0x00 null          0x01 bytes (0x00 escaped as 0x00 0xFF)
  0x02 unicode       0x05 nested tuple
  0x0b..0x1d ints    (0x14 = zero; negatives length-complemented)
  0x21 double        (IEEE bits sign-flipped for ordering)
  0x26 false  0x27 true
  0x30 uuid (16 bytes)

The port's own copy of foundationdb_tpu.layers.tuple.
"""

from __future__ import annotations

import math
import struct
import uuid as _uuid
from typing import Any, Iterable

NULL_CODE = 0x00
BYTES_CODE = 0x01
STRING_CODE = 0x02
NESTED_CODE = 0x05
INT_ZERO_CODE = 0x14
DOUBLE_CODE = 0x21
FALSE_CODE = 0x26
TRUE_CODE = 0x27
UUID_CODE = 0x30

_size_limits = [(1 << (i * 8)) - 1 for i in range(9)]


def _encode_bytes(code: int, value: bytes) -> bytes:
    return bytes([code]) + value.replace(b"\x00", b"\x00\xff") + b"\x00"


def _encode_int(v: int) -> bytes:
    if v == 0:
        return bytes([INT_ZERO_CODE])
    if v > 0:
        n = (v.bit_length() + 7) // 8
        if n > 8:
            raise ValueError("int too large for tuple encoding")
        return bytes([INT_ZERO_CODE + n]) + v.to_bytes(n, "big")
    n = ((-v).bit_length() + 7) // 8
    if n > 8:
        raise ValueError("int too small for tuple encoding")
    return bytes([INT_ZERO_CODE - n]) + (v + _size_limits[n]).to_bytes(n, "big")


def _encode_double(v: float) -> bytes:
    b = struct.pack(">d", v)
    if b[0] & 0x80:  # negative: flip all bits
        b = bytes(x ^ 0xFF for x in b)
    else:            # positive: flip sign bit
        b = bytes([b[0] ^ 0x80]) + b[1:]
    return bytes([DOUBLE_CODE]) + b


def _encode_one(v: Any, *, nested: bool) -> bytes:
    if v is None:
        return bytes([NULL_CODE, 0xFF]) if nested else bytes([NULL_CODE])
    if isinstance(v, bool):  # before int: bool is an int subclass
        return bytes([TRUE_CODE if v else FALSE_CODE])
    if isinstance(v, bytes):
        return _encode_bytes(BYTES_CODE, v)
    if isinstance(v, str):
        return _encode_bytes(STRING_CODE, v.encode("utf-8"))
    if isinstance(v, int):
        return _encode_int(v)
    if isinstance(v, float):
        return _encode_double(v)
    if isinstance(v, _uuid.UUID):
        return bytes([UUID_CODE]) + v.bytes
    if isinstance(v, (tuple, list)):
        return (
            bytes([NESTED_CODE])
            + b"".join(_encode_one(x, nested=True) for x in v)
            + b"\x00"
        )
    raise TypeError(f"cannot encode {type(v).__name__} in tuple layer")


def pack(t: Iterable[Any]) -> bytes:
    """Encode a tuple of values to an order-preserving byte key."""
    return b"".join(_encode_one(v, nested=False) for v in t)


def _decode_terminated(b: bytes, pos: int) -> tuple[bytes, int]:
    out = bytearray()
    while True:
        i = b.index(b"\x00", pos)
        if i + 1 < len(b) and b[i + 1] == 0xFF:
            out += b[pos:i] + b"\x00"
            pos = i + 2
        else:
            out += b[pos:i]
            return bytes(out), i + 1


def _decode_one(b: bytes, pos: int, *, nested: bool):
    code = b[pos]
    if code == NULL_CODE:
        if nested and pos + 1 < len(b) and b[pos + 1] == 0xFF:
            return None, pos + 2
        return None, pos + 1
    if code == BYTES_CODE:
        return _decode_terminated(b, pos + 1)
    if code == STRING_CODE:
        raw, p = _decode_terminated(b, pos + 1)
        return raw.decode("utf-8"), p
    if code == NESTED_CODE:
        out = []
        pos += 1
        while True:
            if b[pos] == 0x00 and not (pos + 1 < len(b) and b[pos + 1] == 0xFF):
                return tuple(out), pos + 1
            v, pos = _decode_one(b, pos, nested=True)
            out.append(v)
    if INT_ZERO_CODE - 8 <= code <= INT_ZERO_CODE + 8:
        n = code - INT_ZERO_CODE
        if n == 0:
            return 0, pos + 1
        if n > 0:
            return int.from_bytes(b[pos + 1 : pos + 1 + n], "big"), pos + 1 + n
        n = -n
        return (
            int.from_bytes(b[pos + 1 : pos + 1 + n], "big") - _size_limits[n],
            pos + 1 + n,
        )
    if code == DOUBLE_CODE:
        raw = b[pos + 1 : pos + 9]
        if raw[0] & 0x80:
            raw = bytes([raw[0] ^ 0x80]) + raw[1:]
        else:
            raw = bytes(x ^ 0xFF for x in raw)
        return struct.unpack(">d", raw)[0], pos + 9
    if code == FALSE_CODE:
        return False, pos + 1
    if code == TRUE_CODE:
        return True, pos + 1
    if code == UUID_CODE:
        return _uuid.UUID(bytes=b[pos + 1 : pos + 17]), pos + 17
    raise ValueError(f"unknown tuple type code {code:#x} at {pos}")


def unpack(b: bytes) -> tuple:
    """Decode a packed key back to the tuple of values."""
    out = []
    pos = 0
    while pos < len(b):
        v, pos = _decode_one(b, pos, nested=False)
        out.append(v)
    return tuple(out)


def range_of(t: Iterable[Any]) -> tuple[bytes, bytes]:
    """(begin, end) covering every key with tuple `t` as a prefix
    (the bindings' fdb.tuple.range())."""
    p = pack(t)
    return p + b"\x00", p + b"\xff"


class Subspace:
    """Key-prefix namespace (the bindings' Subspace class)."""

    def __init__(self, prefix_tuple: tuple = (), raw_prefix: bytes = b""):
        self._prefix = raw_prefix + pack(prefix_tuple)

    @property
    def key(self) -> bytes:
        return self._prefix

    def pack(self, t: tuple = ()) -> bytes:
        return self._prefix + pack(t)

    def unpack(self, key: bytes) -> tuple:
        if not key.startswith(self._prefix):
            raise ValueError("key is not in subspace")
        return unpack(key[len(self._prefix):])

    def range(self, t: tuple = ()) -> tuple[bytes, bytes]:
        p = self.pack(t)
        return p + b"\x00", p + b"\xff"

    def contains(self, key: bytes) -> bool:
        return key.startswith(self._prefix)

    def __getitem__(self, item) -> "Subspace":
        return Subspace((item,), self._prefix)
