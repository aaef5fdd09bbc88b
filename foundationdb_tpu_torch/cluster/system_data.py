"""System keyspace schema: keyServers / serverKeys encodings.

Capability match for fdbclient/SystemData.cpp's shard-location schema:
the reference persists, in the database itself,

* `\\xff/keyServers/<key>`  -> encoded (src team, dest team) — which
  servers own the shard beginning at <key> (dest non-empty only while
  a move is in flight), and
* `\\xff/serverKeys/<server>/<key>` -> ownership marker — the inverse
  map each storage server consults for its own ranges.

This build's authoritative map is the coordinated ShardMap object, so
the schema is served as a MATERIALIZED VIEW through the transaction
read path (the reference's readers — fdbcli `locate`, DD audits,
consistency checkers — see the same shape; the storage medium differs
and is documented here). Values use the repo's typed codec rather than
the reference's BinaryWriter bytes: byte-level parity would be format
translation, the capability is the queryable schema.

The port's own copy of foundationdb_tpu.cluster.system_data.
"""

from __future__ import annotations

import struct

KEY_SERVERS_PREFIX = b"\xff/keyServers/"
KEY_SERVERS_END = b"\xff/keyServers0"
SERVER_KEYS_PREFIX = b"\xff/serverKeys/"
SERVER_KEYS_END = b"\xff/serverKeys0"

_VAL_VERSION = 1


def key_servers_key(key: bytes) -> bytes:
    """keyServersKey(k): the schema key for the shard beginning at k."""
    return KEY_SERVERS_PREFIX + key


def key_servers_value(src: list[int], dest: list[int] = ()) -> bytes:
    """keyServersValue(src, dest): encoded source/destination teams."""
    out = [struct.pack("<BHH", _VAL_VERSION, len(src), len(dest))]
    for s in list(src) + list(dest):
        out.append(struct.pack("<q", s))
    return b"".join(out)


def decode_key_servers_value(value: bytes) -> tuple[list[int], list[int]]:
    if not value:
        return [], []
    ver, n_src, n_dest = struct.unpack_from("<BHH", value, 0)
    if ver != _VAL_VERSION:
        raise ValueError(f"unknown keyServers value version {ver}")
    ids = [
        struct.unpack_from("<q", value, 5 + 8 * i)[0]
        for i in range(n_src + n_dest)
    ]
    return ids[:n_src], ids[n_src:]


def server_keys_key(server: int, key: bytes) -> bytes:
    """serverKeysKey(serverID, k)."""
    return SERVER_KEYS_PREFIX + b"%d/" % server + key


SERVER_KEYS_TRUE = b"1"   # serverKeysTrue: the server owns from here
SERVER_KEYS_FALSE = b"0"  # serverKeysFalse: ownership ends here


def decode_server_keys_key(schema_key: bytes) -> tuple[int, bytes]:
    rest = schema_key[len(SERVER_KEYS_PREFIX):]
    sid, _, key = rest.partition(b"/")
    return int(sid), key


def materialize_key_servers(shard_map, begin: bytes = b"",
                            end: bytes = b"\xff") -> list[tuple[bytes, bytes]]:
    """The keyServers rows for shards intersecting [begin, end): one
    row per shard boundary, exactly the reference's layout (a row's
    key is the shard's begin key; its value names the owning team and
    any in-flight destination).

    Range-read contract: every returned schema key lies inside the
    requested [begin, end) — the shard STRADDLING `begin` is clamped to
    a row AT `begin` (krmGetRanges' alignment discipline,
    fdbclient/KeyRangeMap) rather than leaking a key below the bound,
    which would hand `get_range` callers rows outside their scan."""
    rows = []
    bounds = [b""] + list(shard_map.boundaries)
    for i, b in enumerate(bounds):
        shard_end = (
            shard_map.boundaries[i]
            if i < len(shard_map.boundaries) else b"\xff"
        )
        if shard_end <= begin or b >= end:
            continue
        b = max(b, begin)
        src = sorted(shard_map.owners[i])
        # in-flight destinations: the dual-tag window MoveKeys opens
        # while a shard streams to its new team (ShardMap.
        # extra_tag_ranges) — exactly the dest the reference's DD
        # audits read this schema for
        dest = sorted(
            tag
            for rb, re_, tag in getattr(shard_map, "extra_tag_ranges", [])
            if rb < shard_end and b < re_ and tag not in src
        )
        rows.append((key_servers_key(b), key_servers_value(src, dest)))
    return rows


def materialize_server_keys(shard_map, server: int) -> list[tuple[bytes, bytes]]:
    """The serverKeys rows for one server: boundary markers flipping
    TRUE at every owned range's begin and FALSE at its end (coalesced,
    the reference's run-length discipline)."""
    bounds = [b""] + list(shard_map.boundaries)
    rows = []
    owned_prev = False
    for i, b in enumerate(bounds):
        owned = server in shard_map.owners[i]
        if owned != owned_prev:
            rows.append((
                server_keys_key(server, b),
                SERVER_KEYS_TRUE if owned else SERVER_KEYS_FALSE,
            ))
            owned_prev = owned
    if owned_prev:
        rows.append((server_keys_key(server, b"\xff"), SERVER_KEYS_FALSE))
    return rows


def materialize_all_server_keys(shard_map) -> list[tuple[bytes, bytes]]:
    """serverKeys rows for EVERY server (the audit-style full scan) —
    sorted by schema key, i.e. by (server id as text, key)."""
    servers = sorted({s for team in shard_map.owners for s in team})
    rows = []
    for s in sorted(servers, key=lambda x: str(x)):
        rows.extend(materialize_server_keys(shard_map, s))
    return rows
