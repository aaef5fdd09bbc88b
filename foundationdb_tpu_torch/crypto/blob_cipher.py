"""The encrypted-record header sniff (the port's own copy of
`ENCRYPT_HEADER_MAGIC`, `HEADER_BYTES` and `is_encrypted` from
foundationdb_tpu.crypto.blob_cipher).

A record sealed by the JAX package's BlobCipher (fdbclient/BlobCipher.cpp)
starts with a fixed-size header: the magic, a version, the text and
header cipher identities (domain, base id, salt each), the IV, then a
32-byte auth token. The port's roles use the sniff as defence in depth
behind a store's ENCRYPTION_MODE marker, so that sealed bytes are never
served as data. The cipher itself (and the `cryptography` package it
needs) waits for the at-rest encryption slice.
"""

from __future__ import annotations

import struct

ENCRYPT_HEADER_MAGIC = b"FDBE"
#: magic, version, domain, base id, header domain, header base id, salt,
#: header salt, IV
_HEADER = struct.Struct("<4sBqqqq16s16s16s")
AUTH_TOKEN_BYTES = 32
HEADER_BYTES = _HEADER.size + AUTH_TOKEN_BYTES


def is_encrypted(blob: bytes) -> bool:
    """Cheap header sniff (the storage read path must accept records
    written before encryption was enabled)."""
    return blob[:4] == ENCRYPT_HEADER_MAGIC and len(blob) >= HEADER_BYTES
