"""The wire commit path: roles as OS processes over the serialized wire
(the port's own copy of foundationdb_tpu.cluster.multiprocess's roles,
messages, launcher and ProxyPipeline).

The reference runs every role in its own `fdbserver` process connected
by FlowTransport (fdbserver/worker.actor.cpp:2305-2811 spawns the role
actors). Here

    python -m foundationdb_tpu_torch.cluster.multiprocess \\
        --role {resolver,tlog,storage,sequencer,ratekeeper,worker,controller} \\
        --address /path/x.sock [--backend cuda] [--device cpu] \\
        [--data-dir DIR] [--storage-engine lsm] [--encrypt] \\
        [--tlog-address /path/tlog0.sock] [--trace-file x.jsonl] \\
        [--controller /path/controller0.sock] [--worker-id w0] \\
        [--cluster-conf conf.json] [--state-file state.json]

serves one role over wire.transport on a Unix socket, `spawn_role` /
`connect` launch and reach it from a parent, and `ProxyPipeline` in the
parent runs the commit pipeline against them:

    client -> GRV (in the proxy, or the sequencer's live committed
    version) -> commit batching -> version allocation (local, or a
    GetCommitVersion grant) -> the resolve frame to every resolver
    (prev_version chain, Resolver.actor.cpp:269-290; verdicts
    min-combined) -> TLog push -> client reply -> ordered storage apply

The frames, tokens and message ids are the JAX package's, so a JAX
ProxyPipeline commits through port roles and a port ProxyPipeline
through JAX ones, and the on-disk formats (the TLog's DiskQueue, the
Storage role's mutation log, checkpoint and versioned LSM) are the JAX
package's too: a data dir one package writes, the other opens.

The resolver's backends, against the JAX package's:

| port | JAX | what it builds |
|---|---|---|
| "cuda" (the default) | "tpu-force" | TorchConflictSet on `device` (the card unless `--device cpu`) |
| None (CLI `knob`) | "tpu" | `make_conflict_set(kcfg, None)`: the knob's backend, gated by RESOLVER_CUDA_MIN_BATCH |
| "cpu" | "cpu" | the host oracle (CpuConflictSet) |
| "native" | "native" (JAX's default) | the C++ skip list (native.NativeSkipListConflictSet) |

The kernel configuration is `RESOLVER_KERNEL` from the environment (an
expression in `KernelConfig`, evaluated with only that name in scope),
else the wire role's default (classic, 1,024 txns, 4,096 reads and
writes, 16-byte keys, a 65,536-row tier). With `n_shards > 1` the shards
are a tensor axis on the one device. The TLog, Storage and Sequencer
roles touch no device, in the JAX package either.

A role built on a TorchConflictSet warms up before its socket binds:
it loads the built kernel libraries (on the card), runs one throwaway
resolve on a scratch set of the same config (its constructor runs K20's
self-check) and records the seconds (`ResolverWarmCompile`). A "cuda"
role without a card fails there, before it binds, and exits non-zero.
`connect(address, proc=...)` fails as soon as the child has exited
instead of spending its retries.

The wire cluster under a controller: a `WorkerRole` process hosts
whatever role the `ClusterControllerRole` recruits onto it (resolver,
tlog, storage, sequencer, ratekeeper, or the commit and GRV proxy as a
`ProxyRole` behind the client front door), the controller heartbeats
them and recovers the transaction system into a newer generation when
one dies, and a `ClusterClient` finds the proxies of the live
generation through the controller's topology. `cluster/monitor.py`
starts and restarts the processes, as fdbmonitor does. Against the JAX
module: the controller's conf `backend` defaults to "cuda" (JAX:
"native") and takes the port's names, a conf `device` and a worker's
`device` reach the resolvers it builds (None: the card, where a host
without one fails the recruit), and the status of a process serving a
resolver (alone or in a worker) adds the port's own keys
(`ResolverRole.process_status`): the conflict set's class and device,
the process's kernel launches and those of the role's own resolves.

Encryption at rest, as in the JAX package: a TLogRole or StorageRole
given an `encryption` (crypto/at_rest.StorageEncryption) seals what it
writes under the EncryptKeyProxy's keys (the tlog whole records, the
storage every SET value once, in the executor, before the WAL, the
store or a checkpoint sees it) and opens it on recovery and read; the
data dir's ENCRYPTION_MODE marker refuses a store written sealed when it
is opened without encryption. `spawn_role(..., encrypt=True)` (or the
ENABLE_ENCRYPTION knob) starts a role process with `--encrypt`, whose
keys come from the REST KMS at FDB_TPU_KMS, else the deterministic sim
KMS. A sealed store never falls back to plaintext: without the
`cryptography` package, or with a KMS that does not answer, asking for
encryption raises before the role serves. With FDB_TPU_TLS_DIR set,
every role and connection speaks mutual TLS (`_tls_from_env`).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np

from foundationdb_tpu_torch.cluster.grv_proxy import (  # noqa: F401
    GrvThrottledError,
)
from foundationdb_tpu_torch.models.types import (
    CommitTransaction,
    ResolveTransactionBatchReply,
    ResolveTransactionBatchRequest,
    TransactionResult,
)
from foundationdb_tpu_torch.utils.probes import code_probe, declare
from foundationdb_tpu_torch.wire import codec, transport

declare("controller.elastic_recruit")
declare("controller.elastic_scale_down")

# ---------------------------------------------------------------------------
# Well-known endpoint tokens (the WellKnownEndpoints.h analog).

TOKEN_RESOLVE = 0x0101
TOKEN_RESOLVER_VERSION = 0x0102
TOKEN_TLOG_PUSH = 0x0201
TOKEN_TLOG_PEEK = 0x0202
TOKEN_TLOG_VERSION = 0x0203
TOKEN_TLOG_PEEK_BATCH = 0x0204
TOKEN_TLOG_LOCK = 0x0205
TOKEN_TLOG_POP = 0x0206
TOKEN_STORAGE_APPLY = 0x0301
TOKEN_STORAGE_GET = 0x0302
TOKEN_STORAGE_SNAPSHOT = 0x0303
TOKEN_STORAGE_VERSION = 0x0304
TOKEN_STORAGE_GET_BATCH = 0x0305
TOKEN_STORAGE_APPLY_BATCH = 0x0306
TOKEN_STORAGE_CATCHUP = 0x0307
TOKEN_PING = 0x0401
TOKEN_STATUS = 0x0501
TOKEN_GET_RATE_INFO = 0x0502
# the lifecycle control plane
TOKEN_REGISTER_WORKER = 0x0601
TOKEN_INIT_ROLE = 0x0602
TOKEN_TOPOLOGY = 0x0603
TOKEN_WORKER_DEATH = 0x0604
TOKEN_RATE_UPDATE = 0x0605
# the client front door (a worker hosting the proxy)
TOKEN_CLIENT_GRV = 0x0701
TOKEN_CLIENT_COMMIT = 0x0702
TOKEN_CLIENT_READ = 0x0703
# the sequencer role (version-batch allotment)
TOKEN_GET_COMMIT_VERSION = 0x0801
TOKEN_REPORT_COMMITTED = 0x0802
TOKEN_SEQUENCER_VERSION = 0x0803

# ---------------------------------------------------------------------------
# Small wire messages, declared field by field (explicit layouts, stable
# ids).

_WRITERS = {
    "u8": codec.w_u8,
    "u32": codec.w_u32,
    "i64": codec.w_i64,
    "bytes": codec.w_bytes,
    "str": codec.w_str,
    "bool": codec.w_bool,
}
_READERS = {
    "u8": codec.r_u8,
    "u32": codec.r_u32,
    "i64": codec.r_i64,
    "bytes": codec.r_bytes,
    "str": codec.r_str,
    "bool": codec.r_bool,
}


def _w_mutlist(out, ms):
    codec.w_u32(out, len(ms))
    for m in ms:
        codec.w_mutation(out, m)


def _r_mutlist(buf, off):
    n, off = codec.r_u32(buf, off)
    ms = []
    for _ in range(n):
        m, off = codec.r_mutation(buf, off)
        ms.append(m)
    return ms, off


def _w_optbytes(out, v):
    codec.w_bool(out, v is not None)
    codec.w_bytes(out, v or b"")


def _r_optbytes(buf, off):
    present, off = codec.r_bool(buf, off)
    v, off = codec.r_bytes(buf, off)
    return (v if present else None), off


def _w_kvlist(out, kvs):
    codec.w_u32(out, len(kvs))
    for k, v in kvs:
        codec.w_bytes(out, k)
        codec.w_bytes(out, v)


def _r_kvlist(buf, off):
    n, off = codec.r_u32(buf, off)
    kvs = []
    for _ in range(n):
        k, off = codec.r_bytes(buf, off)
        v, off = codec.r_bytes(buf, off)
        kvs.append((k, v))
    return kvs, off


def _w_i64list(out, vs):
    codec.w_u32(out, len(vs))
    for v in vs:
        codec.w_i64(out, v)


def _r_i64list(buf, off):
    n, off = codec.r_u32(buf, off)
    vs = []
    for _ in range(n):
        v, off = codec.r_i64(buf, off)
        vs.append(v)
    return vs, off


def _w_mutgroups(out, gs):
    codec.w_u32(out, len(gs))
    for g in gs:
        _w_mutlist(out, g)


def _r_mutgroups(buf, off):
    n, off = codec.r_u32(buf, off)
    gs = []
    for _ in range(n):
        g, off = _r_mutlist(buf, off)
        gs.append(g)
    return gs, off


def _w_byteslist(out, bs):
    codec.w_u32(out, len(bs))
    for b in bs:
        codec.w_bytes(out, b)


def _r_byteslist(buf, off):
    n, off = codec.r_u32(buf, off)
    bs = []
    for _ in range(n):
        b, off = codec.r_bytes(buf, off)
        bs.append(b)
    return bs, off


def _w_optbyteslist(out, vs):
    codec.w_u32(out, len(vs))
    for v in vs:
        _w_optbytes(out, v)


def _r_optbyteslist(buf, off):
    n, off = codec.r_u32(buf, off)
    vs = []
    for _ in range(n):
        v, off = _r_optbytes(buf, off)
        vs.append(v)
    return vs, off


def _w_strlist(out, vs):
    codec.w_u32(out, len(vs))
    for v in vs:
        codec.w_str(out, v)


def _r_strlist(buf, off):
    n, off = codec.r_u32(buf, off)
    vs = []
    for _ in range(n):
        v, off = codec.r_str(buf, off)
        vs.append(v)
    return vs, off


for _kind, _w, _r in (
    ("mutlist", _w_mutlist, _r_mutlist),
    ("optbytes", _w_optbytes, _r_optbytes),
    ("kvlist", _w_kvlist, _r_kvlist),
    ("i64list", _w_i64list, _r_i64list),
    ("mutgroups", _w_mutgroups, _r_mutgroups),
    ("byteslist", _w_byteslist, _r_byteslist),
    ("optbyteslist", _w_optbyteslist, _r_optbyteslist),
    ("strlist", _w_strlist, _r_strlist),
):
    _WRITERS[_kind] = _w
    _READERS[_kind] = _r


def _message(type_id: int, name: str, fields: list[tuple]):
    # a field is (name, kind) or (name, kind, default); the wire layout is
    # the field order either way (a default lets a caller leave out a
    # field appended to an existing message, e.g. TLogPush.epoch). A
    # sequence default is spelled as a tuple (dataclasses refuse mutable
    # defaults) and made a list, so a message built with it equals its
    # decode: every list kind reads back a list.
    def _spec(f):
        if len(f) == 2:
            return f[0]
        default = f[2]
        if isinstance(default, (tuple, list)):
            return (f[0], "object",
                    dataclasses.field(
                        default_factory=lambda d=default: list(d)))
        return (f[0], "object", default)

    cls = dataclasses.make_dataclass(name, [_spec(f) for f in fields])
    kinds = [(f[0], f[1]) for f in fields]

    def enc(out, m, _fields=kinds):
        for f, kind in _fields:
            _WRITERS[kind](out, getattr(m, f))

    def dec(buf, off, _fields=kinds, _cls=cls):
        vals = []
        for _f, kind in _fields:
            v, off = _READERS[kind](buf, off)
            vals.append(v)
        return _cls(*vals), off

    codec.register(type_id, cls, enc, dec)
    return cls


Ping = _message(0x0201, "Ping", [("payload", "bytes")])
Pong = _message(0x0202, "Pong", [("payload", "bytes")])
TLogPush = _message(
    0x0210,
    "TLogPush",
    # epoch (0 = unfenced): after a recovery locks the log at epoch E, a
    # push of an older epoch is refused with the retryable stale-epoch
    # error (the reference's tlog epoch lock); appended with a default,
    # so records of a single-generation log replay unchanged
    [("version", "i64"), ("prev_version", "i64"), ("mutations", "mutlist"),
     ("epoch", "i64", 0)],
)
TLogPushReply = _message(0x0211, "TLogPushReply", [("durable_version", "i64")])
TLogPeek = _message(0x0212, "TLogPeek", [("after_version", "i64")])
TLogPeekReply = _message(
    0x0213, "TLogPeekReply", [("version", "i64"), ("mutations", "mutlist")]
)
TLogPeekBatchReq = _message(
    0x0214, "TLogPeekBatchReq",
    [("after_version", "i64"), ("max_entries", "u32")],
)
TLogPeekBatchReply = _message(
    0x0215, "TLogPeekBatchReply",
    [("versions", "i64list"), ("groups", "mutgroups")],
)
StorageApply = _message(
    0x0220, "StorageApply", [("version", "i64"), ("mutations", "mutlist")]
)
StorageApplyReply = _message(
    0x0221, "StorageApplyReply",
    # durable=1 only when the store write-ahead-logs its applies (it has
    # a data dir): the proxy's applier pops the tlog only on a durable
    # ack, since popping against a memory-only store would erase the one
    # durable copy of committed mutations
    [("durable_version", "i64"), ("durable", "u8", 0)],
)
StorageGet = _message(
    0x0222, "StorageGet", [("key", "bytes"), ("version", "i64")]
)
StorageGetReply = _message(0x0223, "StorageGetReply", [("value", "optbytes")])
StorageSnapshotReq = _message(
    0x0224, "StorageSnapshotReq", [("version", "i64")]
)
StorageSnapshotReply = _message(
    0x0225, "StorageSnapshotReply", [("version", "i64"), ("kvs", "kvlist")]
)
# Batched storage reads: the reads the proxy coalesces in one event-loop
# turn ride one round trip (keys[i] is served at versions[i], exact MVCC
# per key; the server waits once, for max(versions)).
StorageGetBatch = _message(
    0x0226, "StorageGetBatch",
    [("versions", "i64list"), ("keys", "byteslist")],
)
StorageGetBatchReply = _message(
    0x0227, "StorageGetBatchReply", [("values", "optbyteslist")]
)
# Batched version-ordered applies: the applier drains its queue in one
# call (one WAL group fsync when persistent), so the storage version
# stays close behind the committed version.
StorageApplyBatch = _message(
    0x0228, "StorageApplyBatch",
    # prev_versions (as long as versions, or empty): the global version
    # chain under several proxies; the apply of versions[i] waits until
    # the store has applied prev_versions[i], so interleaved appliers
    # land in grant order. Empty: one proxy, whose queue order is
    # version order. The frame is wire-only (the WAL persists
    # StorageApply records).
    [("versions", "i64list"), ("groups", "mutgroups"),
     ("prev_versions", "i64list", ())],
)
RoleVersionReq = _message(0x0230, "RoleVersionReq", [("pad", "u8")])
RoleVersionReply = _message(0x0231, "RoleVersionReply", [("version", "i64")])
# saturation telemetry: every role answers StatusRequest with its status
# block as a JSON document (the reference's status JSON)
StatusRequest = _message(0x0240, "StatusRequest", [("pad", "u8")])
StatusReply = _message(0x0241, "StatusReply", [("payload", "str")])
# admission control over the wire (Ratekeeper.actor.cpp:475
# GetRateInfoRequest): the ProxyPipeline's GRV front door fetches its
# transactions-a-second budget as a JSON document
GetRateInfoRequest = _message(0x0242, "GetRateInfoRequest", [("pad", "u8")])
GetRateInfoReply = _message(0x0243, "GetRateInfoReply", [("payload", "str")])
# recovery -> tlog: lock the log at a new epoch. Phase one (no
# recovery_version) bumps the epoch and reports the durable version;
# phase two re-locks at the same epoch with the recovery version,
# advancing the floor past the old generation so parked per-tag chain
# waiters drain instead of wedging. `partitioned` turns the per-tag
# chain wait on. Never persisted.
TLogLock = _message(
    0x0256, "TLogLock",
    [("epoch", "i64"), ("recovery_version", "i64", -1),
     ("partitioned", "u32", 0)],
)
TLogLockReply = _message(
    0x0257, "TLogLockReply",
    [("epoch", "i64"), ("durable_version", "i64")],
)
# recovery -> storage: replay the locked tlogs' tails above the durable
# version before the new generation opens (tlog_addresses: more tlogs
# of a tag-partitioned log, merged by version); then advance the floor
# to recovery_version (-1: leave it)
StorageCatchUp = _message(
    0x025E, "StorageCatchUp",
    [("tlog_address", "str"), ("tlog_addresses", "strlist", ()),
     ("recovery_version", "i64", -1)],
)
StorageCatchUpReply = _message(
    0x025F, "StorageCatchUpReply", [("version", "i64")]
)
# the proxy's applier -> tlog: storage holds everything at or below
# `version` durably, so that prefix of the log is popped
TLogPop = _message(
    0x0260, "TLogPop", [("version", "i64"), ("epoch", "i64", 0)]
)
TLogPopReply = _message(
    0x0261, "TLogPopReply", [("durable_version", "i64")]
)
# proxy -> sequencer (the MasterInterface shape): each grant carries
# (prev_version, version) for the resolvers' chain, and `tag_prevs` the
# previous version of each declared tag, so each tag-partitioned tlog
# sees a gapless chain. Proxies number requests from 1; duplicates
# replay the cached grant.
GetCommitVersionRequest = _message(
    0x0266, "GetCommitVersionRequest",
    [("proxy_id", "str"), ("request_num", "u32"),
     ("most_recent_processed", "u32"), ("epoch", "i64"),
     ("tags", "i64list", ())],
)
GetCommitVersionReply = _message(
    0x0267, "GetCommitVersionReply",
    [("version", "i64"), ("prev_version", "i64"), ("request_num", "u32"),
     ("tag_prevs", "i64list", ())],
)
# proxy -> sequencer: report a committed version before acking the
# client, so a later GRV from any proxy observes it; version -1 only
# reads the live committed version
ReportRawCommittedVersionRequest = _message(
    0x0268, "ReportRawCommittedVersionRequest",
    [("version", "i64"), ("epoch", "i64")],
)
ReportRawCommittedVersionReply = _message(
    0x0269, "ReportRawCommittedVersionReply", [("live_version", "i64")]
)

# The lifecycle frames (the worker / cluster-controller shape:
# fdbserver/worker.actor.cpp's RegisterWorkerRequest and the
# Initialize*Request streams). Their payloads are JSON documents, as
# StatusReply's is: topology and recruitment descriptors are status-schema
# slices, not hot-path messages.

_WRITERS["txn"] = codec.w_commit_transaction
_READERS["txn"] = codec.r_commit_transaction

# worker -> controller: "I exist, here is my socket", sent again on a
# cadence (the worker's liveness beacon)
RegisterWorker = _message(
    0x0250, "RegisterWorker", [("payload", "str")]
)
RegisterWorkerReply = _message(
    0x0251, "RegisterWorkerReply", [("payload", "str")]
)
# controller -> worker: host this role at this generation (the
# Initialize*Request analog; kind, epoch and config in the payload)
InitializeRole = _message(0x0252, "InitializeRole", [("payload", "str")])
InitializeRoleReply = _message(
    0x0253, "InitializeRoleReply", [("payload", "str")]
)
# anyone -> controller: the current generation's topology (epoch,
# recovery state, role -> worker socket map)
TopologyRequest = _message(0x0254, "TopologyRequest", [("pad", "u8")])
TopologyReply = _message(0x0255, "TopologyReply", [("payload", "str")])
# client -> proxy worker (the NativeAPI front door over the wire): GRV,
# a versioned point read and a commit, so the proxies are killable
# processes like every other role
ClientGrvRequest = _message(0x0258, "ClientGrvRequest", [("pad", "u8")])
ClientGrvReply = _message(0x0259, "ClientGrvReply", [("version", "i64")])
ClientCommitRequest = _message(
    0x025A, "ClientCommitRequest", [("txn", "txn")]
)
ClientCommitReply = _message(
    0x025B, "ClientCommitReply", [("version", "i64")]
)
ClientReadRequest = _message(
    0x025C, "ClientReadRequest", [("key", "bytes"), ("version", "i64")]
)
ClientReadReply = _message(
    0x025D, "ClientReadReply", [("value", "optbytes")]
)
# monitor -> controller: push-on-death. The monitor reaps a dead worker
# and tells the controller at once, so detecting the death costs one
# supervision pass, not HEARTBEAT_MISSES status polls; heartbeats stay
# the backstop for deaths the monitor cannot see
WorkerDeath = _message(0x0262, "WorkerDeath", [("payload", "str")])
WorkerDeathReply = _message(
    0x0263, "WorkerDeathReply", [("payload", "str")]
)
# ratekeeper -> proxy: a push of the fresh GetRateInfo payload when a
# control cycle moves the budget past the push hysteresis (or flips the
# binding limiter); the proxies' polling stays the backstop
RateUpdate = _message(0x0264, "RateUpdate", [("payload", "str")])
RateUpdateReply = _message(0x0265, "RateUpdateReply", [("payload", "str")])


# ---------------------------------------------------------------------------
# The resolver role.


def _fence_epoch(req, role) -> None:
    """Generation fencing: unless the request carries `role`'s exact
    epoch, count the reject and raise the retryable stale-epoch error
    (cluster/generation.py). A request without an epoch fences as epoch
    0, which an unfenced role matches."""
    req_epoch = getattr(req, "epoch", 0)
    if req_epoch != role.epoch:
        from foundationdb_tpu_torch.cluster.generation import (
            stale_epoch_message,
        )

        role.stale_epoch_rejects += 1
        raise transport.RemoteError(
            stale_epoch_message(req_epoch, role.epoch)
        )


def default_resolver_boundaries(n: int) -> list[bytes]:
    """Even byte-prefix keyspace split for n resolvers: the n - 1
    interior boundary keys (the formula of
    parallel/sharding.default_boundaries)."""
    if not 1 <= n <= 256:
        raise ValueError(f"resolver count must be in [1, 256], got {n}")
    return [bytes([(256 * (i + 1)) // n]) for i in range(n - 1)]


def resolver_key_ranges(boundaries: list[bytes]) -> list[tuple]:
    """[(lo, hi_or_None)] partitions from n - 1 interior split keys:
    resolver i owns [lo_i, hi_i), the last one unbounded above."""
    lows = [b""] + list(boundaries)
    highs = list(boundaries) + [None]
    return list(zip(lows, highs))


def clip_transactions(txns, lo: bytes, hi) -> list:
    """The multi-resolver split: each resolver sees only the conflict
    range pieces inside its key partition (the reference's
    ResolutionRequestBuilder, CommitProxyServer.actor.cpp:105-261; the
    clip testing/oracle.MultiResolverOracle models). Every transaction
    keeps its slot, so the verdicts min-combine slot by slot; a txn with
    no local reads is a local blind write and votes committed."""

    def clip(ranges):
        out = []
        for b, e in ranges:
            cb = b if b > lo else lo
            ce = e if hi is None or e < hi else hi
            if cb < ce:
                out.append((cb, ce))
        return out

    return [
        CommitTransaction(
            read_conflict_ranges=clip(t.read_conflict_ranges),
            write_conflict_ranges=clip(t.write_conflict_ranges),
            read_snapshot=t.read_snapshot,
            report_conflicting_keys=t.report_conflicting_keys,
            debug_id=t.debug_id,
        )
        for t in txns
    ]


def _decode_alloc_count(txns) -> int:
    """The Python objects a per-transaction frame decode makes for a
    batch (codec.r_commit_transaction's allocations): per txn the
    CommitTransaction and its two range lists, per conflict range the
    tuple and two keys, per mutation the Mutation and two params."""
    n = 0
    for t in txns:
        n += 3 + 3 * (
            len(t.read_conflict_ranges) + len(t.write_conflict_ranges)
        ) + 3 * len(t.mutations)
    return n


def _default_kernel_config(window: int):
    from foundationdb_tpu_torch.config import KernelConfig

    cfg_env = os.environ.get("RESOLVER_KERNEL", "")
    if cfg_env:
        # an operator-supplied expression, with KernelConfig its only name
        return eval(cfg_env, {"__builtins__": {}},  # noqa: S307
                    {"KernelConfig": KernelConfig})
    return KernelConfig(
        max_key_bytes=16,
        max_txns=1024,
        max_reads=4096,
        max_writes=4096,
        history_capacity=1 << 16,
        window_versions=window,
    )


class ResolverRole:
    """Wire-served resolver: version-chained conflict resolution.

    The resolveBatch ordering contract (fdbserver/Resolver.actor.cpp:
    269-290,496): a request waits until the resolver's version reaches
    its prev_version, resolves, then advances the version to its own, so
    requests from concurrent proxies are served in the global commit
    order. A duplicate (same version) replays the recorded reply
    (:515-530).
    """

    def __init__(self, backend: Optional[str] = "cuda",
                 window: int = 5_000_000, epoch: int = 0,
                 compute_cost_per_txn: float = 0.0, device=None):
        from foundationdb_tpu_torch.models.conflict_set import (
            KernelStageMetrics,
            make_conflict_set,
        )
        from foundationdb_tpu_torch.utils.metrics import (
            LatencySample,
            TimerSmoother,
        )

        self.version = -1
        self.window = window
        #: modelled compute seconds a transaction (the wire twin of the
        #: sim Resolver.sim_compute_cost_per_txn): awaited a batch after
        #: the real resolve, times the transactions with local conflict
        #: work, so under the multi-resolver split each resolver pays for
        #: its own partition's rows. 0.0 (the default) is a strict no-op.
        self.compute_cost_per_txn = float(compute_cost_per_txn or 0.0)
        #: generation fencing: a batch carrying any other epoch is
        #: rejected retryably; 0 = unfenced
        self.epoch = epoch
        self.stale_epoch_rejects = 0
        self._cond: asyncio.Condition | None = None
        self._replies: dict[int, ResolveTransactionBatchReply] = {}
        self._backend = backend
        self._waiting = 0  # requests parked on the version chain
        #: frame accounting: `copies` counts full materializations of the
        #: key data between the frame payload and the conflict backend's
        #: input, `decode_allocs` the per-transaction Python objects the
        #: decode made (each site says where it counts)
        self.path_stats = {
            "columnar_batches": 0,
            "object_batches": 0,
            "txns": 0,
            "copies": 0,
            "decode_allocs": 0,
        }
        #: conflict-range begin keys by touch count, decayed at
        #: sampling.KEY_SAMPLE_LIMIT
        self._key_sample: dict[bytes, int] = {}
        # the reference resolver's four distributions, on the wall clock
        self.queue_depth = LatencySample("queueDepth")
        self.queue_wait_latency = LatencySample("queueWaitLatency")
        self.compute_time = LatencySample("computeTime")
        self.resolver_latency = LatencySample("resolverLatency")
        #: busy fraction: compute seconds as a decayed rate (~1.0 when
        #: every wall second is spent resolving)
        self.occupancy = TimerSmoother(2.0)
        if backend == "native":
            from foundationdb_tpu_torch.native import (
                NativeSkipListConflictSet,
            )

            self._cs = NativeSkipListConflictSet(window=window)
            # the skip list has no stage split: its seconds land in the
            # kernel stage of a role-owned block
            self._kernel_metrics = KernelStageMetrics()
        elif backend in ("cuda", "cpu", None):
            kcfg = _default_kernel_config(window)
            self._cs = make_conflict_set(kcfg, backend, device=device)
            self._kernel_metrics = (
                getattr(self._cs, "metrics", None) or KernelStageMetrics()
            )
            self._warm_compile(kcfg, backend, device)
        else:
            raise ValueError(f"unknown resolver backend {backend!r}")
        #: the kernel launches of this role's own resolves: a worker
        #: builds a new role on each recruit, and a replaced role may
        #: still finish a batch of its generation after that
        self.role_launches: dict[str, int] = {}

    def _warm_compile(self, kcfg, backend, device) -> None:
        """Warm the resolve path at start-up, not in the first request:
        on the card, load every built kernel library (kernels.load_all);
        then one throwaway resolve on a scratch set of the same config,
        freed after. The seconds land in the set's `compile` sample,
        `warmCompiles`, compile_cache.record_compile and a
        ResolverWarmCompile event."""
        import torch

        from foundationdb_tpu_torch import kernels
        from foundationdb_tpu_torch.models.conflict_set import (
            make_conflict_set,
        )
        from foundationdb_tpu_torch.utils import compile_cache as _cc
        from foundationdb_tpu_torch.utils.trace import SEV_INFO, TraceEvent

        t0 = time.perf_counter()
        on_card = getattr(self._cs, "device", None) is not None and (
            self._cs.device.type == "cuda")
        if on_card:
            kernels.load_all()
        scratch = make_conflict_set(kcfg, backend, device=device)
        scratch.resolve(
            [
                CommitTransaction(
                    read_conflict_ranges=[(b"\x00warm", b"\x00warm\x00")],
                    write_conflict_ranges=[(b"\x00warm", b"\x00warm\x00")],
                    read_snapshot=0,
                )
            ],
            1,
        )
        del scratch
        if on_card:
            torch.cuda.synchronize(self._cs.device)
        dt = time.perf_counter() - t0
        metrics = getattr(self._cs, "metrics", None)
        if metrics is not None:
            metrics.compile.sample(dt)
            metrics.add("warmCompiles")
        label = "knob" if backend is None else backend
        _cc.record_compile(f"resolver_warm/{label}/txns={kcfg.max_txns}", dt)
        TraceEvent("ResolverWarmCompile", severity=SEV_INFO).detail(
            "Backend", label
        ).detail("Seconds", round(dt, 3)).log()

    def _cond_lazy(self) -> asyncio.Condition:
        if self._cond is None:
            self._cond = asyncio.Condition()
        return self._cond

    async def resolve(self, req):
        """TOKEN_RESOLVE: a ResolveTransactionBatchRequest or a
        ResolveBatchColumnar, answered with its reply."""
        # the fence first, before the version-chain wait: a batch of a
        # stale generation bounces at once, never parks
        _fence_epoch(req, self)
        # the span context crossed the process boundary in the frame;
        # this role's span chains to it
        span = None
        if req.span is not None:
            from foundationdb_tpu_torch.utils.spans import Span, SpanContext

            span = Span(
                "Resolver.resolveBatch", parent=SpanContext(*req.span)
            ).attribute("Version", req.version)
        if req.debug_id is not None:
            from foundationdb_tpu_torch.utils import commit_debug as _cdbg
            from foundationdb_tpu_torch.utils import trace as _tr

            _tr.g_trace_batch.add_event(
                "CommitDebug", req.debug_id, _cdbg.RESOLVER_BEFORE
            )
        try:
            return await self._resolve_ordered(req)
        finally:
            if req.debug_id is not None:
                _tr.g_trace_batch.add_event(
                    "CommitDebug", req.debug_id, _cdbg.RESOLVER_AFTER
                )
            if span is not None:
                span.finish()

    async def _resolve_ordered(self, req):
        t_arrive = time.perf_counter()
        cond = self._cond_lazy()
        async with cond:
            self._waiting += 1
            self.queue_depth.sample(self._waiting)
            try:
                await cond.wait_for(
                    lambda: self.version >= req.prev_version
                )
            finally:
                self._waiting -= 1
            self.queue_wait_latency.sample(time.perf_counter() - t_arrive)
            if req.version <= self.version:
                # duplicate (a proxy's retry): replay the recorded reply
                reply = self._replies.get(req.version)
                if reply is None:
                    raise transport.RemoteError(
                        f"version {req.version} already resolved and expired"
                    )
                return reply
            if req.debug_id is not None:
                from foundationdb_tpu_torch.utils import commit_debug as _cdbg
                from foundationdb_tpu_torch.utils import trace as _tr

                # past the version-chain wait: the next mark is
                # ColumnarDecode, so the pair brackets the decode
                _tr.g_trace_batch.add_event(
                    "CommitDebug", req.debug_id, _cdbg.RESOLVER_AFTER_ORDERER
                )
            t_compute = time.perf_counter()
            reply = self._resolve_counted(req)
            if self.compute_cost_per_txn > 0.0:
                # modelled compute rides the version chain as real
                # compute does (successors wait on the condition), but as
                # an await, so the process keeps answering status polls;
                # occupancy and compute_time take it in below
                await asyncio.sleep(
                    self.compute_cost_per_txn * self._local_txns(req)
                )
            dt_compute = time.perf_counter() - t_compute
            self.compute_time.sample(dt_compute)
            self.occupancy.add_delta(dt_compute)
            self.resolver_latency.sample(time.perf_counter() - t_arrive)
            self._replies[req.version] = reply
            # keep a bounded replay window
            floor = req.version - self.window
            self._replies = {
                v: r for v, r in self._replies.items() if v >= floor
            }
            self.version = req.version
            cond.notify_all()
            return reply

    def _resolve_counted(self, req) -> ResolveTransactionBatchReply:
        """_resolve_now, with the kernel launches it makes (it runs on
        the event loop without a break, so they are all this role's)
        added to role_launches."""
        from foundationdb_tpu_torch import kernels

        before = kernels.counts()
        try:
            return self._resolve_now(req)
        finally:
            for k, n in kernels.counts().items():
                if n != before.get(k, 0):
                    self.role_launches[k] = (self.role_launches.get(k, 0)
                                             + n - before.get(k, 0))

    def _local_txns(self, req) -> int:
        """The transactions of this batch with local conflict work, the
        modelled compute's multiplier. Under the proxy's multi-resolver
        split a foreign partition's transactions arrive with no ranges
        (slot-aligned blind writes) and cost nothing."""
        if isinstance(req, codec.ResolveBatchColumnar):
            cols = req.cols
            return sum(
                1 for i in range(cols.n_txns)
                if int(cols.read_counts[i]) + int(cols.write_counts[i]) > 0
            )
        return sum(
            1 for t in req.transactions
            if t.read_conflict_ranges or t.write_conflict_ranges
        )

    def _trace_columnar_decode(self, req) -> None:
        """The Resolver.resolveBatch.ColumnarDecode mark: the columnar
        frame has become the backend's input (kernel arrays, or rebuilt
        objects on the object fallback)."""
        if req.debug_id is None:
            return
        from foundationdb_tpu_torch.utils import commit_debug as _cdbg
        from foundationdb_tpu_torch.utils import trace as _tr

        _tr.g_trace_batch.add_event(
            "CommitDebug", req.debug_id, _cdbg.RESOLVER_COLUMNAR_DECODE
        )

    def _columnar_to_objects(self, req) -> list:
        """The object fallback of every backend that takes byte keys
        (the skip list, the host oracle): exact transactions rebuilt from
        the blob, one blob -> objects copy, every allocation counted."""
        from foundationdb_tpu_torch.utils import packing as _packing

        txns = _packing.columnar_to_transactions(req.cols)
        self.path_stats["copies"] += 1
        self.path_stats["decode_allocs"] += _decode_alloc_count(txns)
        self._trace_columnar_decode(req)
        return txns

    def _note_key_sample(self, req) -> None:
        """Feed the key sample from both frame kinds without making
        transactions: the blob's key order (read begins, read ends,
        write begins, write ends) puts the begin keys at known offsets."""
        from foundationdb_tpu_torch.cluster import sampling as _sampling

        sample = self._key_sample
        if isinstance(req, codec.ResolveBatchColumnar):
            cols = req.cols
            if len(cols.key_lens) == 0:
                return
            offs = np.concatenate(
                ([0], np.cumsum(cols.key_lens, dtype=np.int64))
            )
            blob = bytes(cols.key_blob)
            nr, nw = cols.n_reads, cols.n_writes
            for i in (*range(nr), *range(2 * nr, 2 * nr + nw)):
                b = blob[offs[i]:offs[i + 1]]
                sample[b] = sample.get(b, 0) + 1
        else:
            for t in req.transactions:
                for b, _e in t.read_conflict_ranges + t.write_conflict_ranges:
                    sample[b] = sample.get(b, 0) + 1
        if len(sample) > _sampling.KEY_SAMPLE_LIMIT:
            _sampling.decay_key_sample(sample)

    def _resolve_now(self, req) -> ResolveTransactionBatchReply:
        columnar = isinstance(req, codec.ResolveBatchColumnar)
        stats = self.path_stats
        self._note_key_sample(req)
        if columnar:
            stats["columnar_batches"] += 1
            stats["txns"] += req.cols.n_txns
        else:
            stats["object_batches"] += 1
            stats["txns"] += len(req.transactions)
            # the object frame's decode (in the transport's dispatch)
            # already made per-txn objects: one payload -> objects copy
            stats["copies"] += 1
            stats["decode_allocs"] += _decode_alloc_count(req.transactions)
        if self._backend == "native":
            txns = (
                self._columnar_to_objects(req) if columnar
                else req.transactions
            )
            t0 = time.perf_counter()
            verdicts = self._cs.resolve(txns, req.version)
            self._kernel_metrics.kernel.sample(time.perf_counter() - t0)
            self._kernel_metrics.add("resolveBatches")
            committed = [TransactionResult(int(v)) for v in verdicts]
            ckr: dict[int, list[int]] = {}
        else:
            kernel_set = hasattr(self._cs, "pack_columnar_batch")
            if columnar and kernel_set:
                # frame -> kernel arrays in two copies: the blob -> padded
                # array scatter (pack_columnar_batch) and the transfer to
                # the device inside the dispatch; no per-txn objects
                batch = self._cs.pack_columnar_batch(req.cols, req.version)
                self._trace_columnar_decode(req)
                stats["copies"] += 2
                res = self._cs.resolve_columnar_packed(req.cols, batch)
            elif columnar:
                # the host oracle takes objects
                res = self._cs.resolve(
                    self._columnar_to_objects(req), req.version
                )
            else:
                if kernel_set:
                    # the object path on a kernel set: pack_batch
                    # flattens the decoded objects (+1) and the dispatch
                    # transfers them (+1), after the decode's copy
                    stats["copies"] += 2
                res = self._cs.resolve(req.transactions, req.version)
            committed = res.verdicts
            ckr = res.conflicting_key_ranges
        return ResolveTransactionBatchReply(
            committed=committed,
            conflicting_key_range_map=ckr,
            state_mutations=[],
            debug_id=req.debug_id,
        )

    def status(self) -> dict:
        """The StatusRequest payload: role kind, version, backend, epoch
        and the qos sensors (the four reference distributions, the
        kernel panel, the frame accounting, the key sample): the JAX
        role's keys, and `kernel_stages`, the port's own."""
        from foundationdb_tpu_torch.cluster import sampling as _sampling

        qos = {
            "queue_depth": self._waiting,
            "occupancy": self.occupancy.smooth_rate(),
            "queue_depth_dist": self.queue_depth.as_dict(),
            "queue_wait_dist": self.queue_wait_latency.as_dict(),
            "compute_time_dist": self.compute_time.as_dict(),
            "resolver_latency_dist": self.resolver_latency.as_dict(),
            # always present: a kernel set's stage metrics, or the
            # skip list's role-owned block
            "kernel": self._kernel_metrics.qos(),
            # the port's own: the whole stage block (counters such as
            # columnarBatches and warmCompiles, each stage's sample)
            "kernel_stages": self._kernel_metrics.as_dict(),
            "resolve_path": dict(self.path_stats),
            "stale_epoch_rejects": self.stale_epoch_rejects,
            "key_sample": _sampling.key_sample_qos(self._key_sample),
        }
        return {
            "role": "resolver",
            "version": self.version,
            "backend": self._backend,
            "epoch": self.epoch,
            "qos": qos,
        }

    def process_status(self) -> dict:
        """The port's own keys of the status of a process serving this
        role: what resolves (the conflict set's class, and its device
        where it has one), the process's kernel launches and those of
        this role's own resolves."""
        from foundationdb_tpu_torch import kernels

        cs_device = getattr(self._cs, "device", None)
        return {
            "conflict_set": {
                "class": type(self._cs).__name__,
                "device": None if cs_device is None else str(cs_device),
            },
            "kernel_launches": kernels.counts(),
            "role_kernel_launches": dict(self.role_launches),
        }


# ---------------------------------------------------------------------------
# The log, sequencer and storage roles.


def _looks_sealed(blob: bytes) -> bool:
    """A sealed record (the header sniff: defence in depth behind the
    ENCRYPTION_MODE marker)."""
    from foundationdb_tpu_torch.crypto.blob_cipher import is_encrypted

    return is_encrypted(blob)


def _check_encryption_marker(data_dir: str, encryption) -> None:
    """The persisted encryption mode (the reference persists
    encryptionAtRestMode and refuses mode flips, DatabaseConfiguration.h):
    a store written encrypted is never opened unencrypted, or sealed
    bytes would be served as data. With encryption the marker is written
    (and fsynced, file and directory) before any record; without, its
    presence raises. The marker is deterministic where a record sniff
    alone could mistake user bytes for a header."""
    marker = os.path.join(data_dir, "ENCRYPTION_MODE")
    if encryption is not None:
        if not os.path.exists(marker):
            # the records are fsynced, so the marker must be at least as
            # durable: a power loss that kept sealed records and dropped
            # the marker would downgrade the store silently
            with open(marker, "w") as f:
                f.write("aes-256-ctr\n")
                f.flush()
                os.fsync(f.fileno())
            dfd = os.open(data_dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
    elif os.path.exists(marker):
        raise RuntimeError(
            f"{data_dir} was written with encryption-at-rest; "
            "restart the role with --encrypt (and the same KMS)"
        )


def _encryption_status(encryption) -> dict:
    """A sealed store's status block: its seal and open counts and
    seconds and its KMS fetches (a port addition, only when encryption
    is on)."""
    return {} if encryption is None else {"encryption": encryption.stats()}


def _decode_tlog_record(blob: bytes):
    """Decode one tlog WAL record, accepting the pre-epoch layout.

    The wire is guarded by the PROTOCOL_VERSION handshake, disk records
    are not: a data dir written before the epoch field (protocol 0007)
    holds 3-field TLogPush frames, and a newer build must open them.
    Such records replay at epoch 0; the recovery lock fences the log
    again before any push of a new generation."""
    try:
        return codec.decode(blob)
    except codec.CodecError:
        buf = memoryview(blob)
        tid, off = codec.r_u16(buf, 0)
        if tid != 0x0210:
            raise
        version, off = codec.r_i64(buf, off)
        prev, off = codec.r_i64(buf, off)
        muts, off = _r_mutlist(buf, off)
        if off != len(buf):
            raise
        return TLogPush(
            version=version, prev_version=prev, mutations=muts, epoch=0
        )


def _mutation_bytes(mutations) -> int:
    return sum(8 + len(m.param1) + len(m.param2) for m in mutations)


class TLogRole:
    """Wire-served transaction log: version-ordered append and peek.

    With a data dir, every push rides the native DiskQueue
    (native/diskqueue.cpp, the fdbserver/DiskQueue.actor.cpp role):
    frames are fsynced before the push is acked (the tLogCommit
    discipline, TLogServer.actor.cpp:2311), and a restart recovers
    exactly the acked entries through the crc-checked recovery scan.
    """

    def __init__(self, data_dir: str | None = None, encryption=None,
                 epoch: int = 0, partitioned: bool = False):
        from foundationdb_tpu_torch.utils.metrics import TimerSmoother

        self.entries: list[tuple[int, list]] = []  # (version, mutations)
        self.version = -1
        self._dq = None
        #: tag-partitioned mode: this tlog owns a key-range tag and sees
        #: only the versions that touch it, pushed by several proxies at
        #: once; a push whose per-tag prev_version is ahead of us parks
        #: on the chain condition until its predecessor lands (or a
        #: recovery advances the floor)
        self.partitioned = partitioned
        self._chain_cond: asyncio.Condition | None = None
        self._chain_waiters = 0
        #: generation fencing (the reference's tlog epoch lock): after
        #: lock(E), pushes at an older epoch are refused retryably;
        #: 0 = unfenced
        self.epoch = epoch
        self.stale_epoch_rejects = 0
        # saturation sensors (the Ratekeeper's TLogQueueInfo inputs):
        # retained queue bytes through a wall-clock smoother
        self._queue_bytes = 0
        self.smoothed_queue_bytes = TimerSmoother(1.0)
        self.smoothed_input_bytes = TimerSmoother(1.0)
        # the tlog persists the mutation bytes the storage seals: its
        # disk is sealed too, whole records (tlog frames have no order
        # constraint, unlike the LSM's keys)
        self._enc = encryption if data_dir else None
        #: disk-queue seq a pushed version: the pop boundary lookup
        self._seq_by_version: list[tuple[int, int]] = []
        self._data_dir = data_dir
        if data_dir:
            from foundationdb_tpu_torch.native import DiskQueue

            if self._enc is not None:
                # both cipher identities before anything is written: the
                # first push must not wait on the KMS, and a KMS that
                # does not answer fails the role here
                self._enc.prefetch()
            os.makedirs(data_dir, exist_ok=True)
            _check_encryption_marker(data_dir, self._enc)
            self._dq = DiskQueue(os.path.join(data_dir, "tlog"))
            for seq, blob in self._dq.recovered:
                if self._enc is not None:
                    blob = self._enc.open(blob)
                elif _looks_sealed(blob):
                    raise RuntimeError(
                        "sealed tlog record but encryption is disabled"
                    )
                rec = _decode_tlog_record(blob)
                self.entries.append((rec.version, list(rec.mutations)))
                self.version = max(self.version, rec.version)
                self._seq_by_version.append((rec.version, seq))
            # the popped-version marker: a fully popped log still
            # restarts at its durable head version (the recovery version
            # derives from it, and a regressed one would let a new
            # generation allocate versions below committed data)
            self.version = max(self.version, self._read_popped_marker())
            self._queue_bytes = sum(
                _mutation_bytes(ms) for _v, ms in self.entries
            )
            self.smoothed_queue_bytes.set_total(self._queue_bytes)

    async def lock(self, req: TLogLock) -> TLogLockReply:
        """The recovery lock (the coordinated-state and tlog epoch lock):
        advance to the new generation, fencing every push still carrying
        an older epoch, and return the durable version the recovery
        version derives from."""
        if req.epoch < self.epoch:
            from foundationdb_tpu_torch.cluster.generation import (
                stale_epoch_message,
            )

            raise transport.RemoteError(
                stale_epoch_message(req.epoch, self.epoch)
            )
        self.epoch = req.epoch
        if req.partitioned:
            # scale-out recovery onto a surviving tlog: the lock turns the
            # per-tag chain wait on
            self.partitioned = True
        durable = self.version
        if req.recovery_version >= 0:
            # phase two: advance the floor past the old generation so the
            # new generation's first push finds its predecessor, and wake
            # parked chain waiters (they re-check the epoch and drain as
            # stale)
            self.version = max(self.version, req.recovery_version)
        await self._chain_wake()
        return TLogLockReply(epoch=self.epoch, durable_version=durable)

    def _chain(self) -> asyncio.Condition:
        if self._chain_cond is None:
            self._chain_cond = asyncio.Condition()
        return self._chain_cond

    async def _chain_wake(self) -> None:
        if self._chain_cond is not None:
            async with self._chain_cond:
                self._chain_cond.notify_all()

    async def push(self, req: TLogPush) -> TLogPushReply:
        # generation fence: a locked log refuses the old generation's
        # pushes (and a not-yet-locked log a future generation's)
        _fence_epoch(req, self)
        if self.partitioned and req.prev_version > self.version:
            # tag-partitioned chain wait: this tag's predecessor version
            # has not landed (another proxy owns it). Park until it does
            # or a recovery bumps the epoch or the floor, bounded so a
            # dead predecessor surfaces as a retryable stall
            cond = self._chain()
            epoch0 = self.epoch
            self._chain_waiters += 1
            try:
                async with cond:
                    await asyncio.wait_for(
                        cond.wait_for(
                            lambda: self.version >= req.prev_version
                            or self.epoch != epoch0
                        ),
                        timeout=10.0,
                    )
            except asyncio.TimeoutError:
                raise transport.RemoteError(
                    "tlog chain stall: prev_version "
                    f"{req.prev_version} never arrived (retryable)"
                )
            finally:
                self._chain_waiters -= 1
            _fence_epoch(req, self)
        if req.version <= self.version:
            # a duplicate push: an idempotent ack (a proxy's retry after a
            # lost reply; partitioned, also a push overtaken by the
            # recovery floor)
            return TLogPushReply(durable_version=self.version)
        # Forward version skips are legal: failed batches and recovery
        # consume versions. Only regressions are refused (above).
        if self._dq is not None:
            blob = codec.encode(req)
            if self._enc is not None:
                blob = self._enc.seal(blob)
            seq = self._dq.push(blob)
            if self._dq.commit() is None:
                # fsync or pwrite failed: not durable, so no ack
                raise transport.RemoteError("tlog disk commit failed")
            self._seq_by_version.append((req.version, seq))
        self.entries.append((req.version, list(req.mutations)))
        self.version = req.version
        nb = _mutation_bytes(req.mutations)
        self._queue_bytes += nb
        self.smoothed_input_bytes.add_delta(nb)
        self.smoothed_queue_bytes.set_total(self._queue_bytes)
        if self.partitioned:
            await self._chain_wake()
        return TLogPushReply(durable_version=self.version)

    def status(self) -> dict:
        """The StatusRequest payload: retained queue depth and bytes
        (smoothed and now) and the durable version."""
        return {
            "role": "log",
            "version": self.version,
            "epoch": self.epoch,
            "qos": {
                "queue_mutations": sum(
                    len(ms) for _v, ms in self.entries
                ),
                "queue_bytes": self._queue_bytes,
                "smoothed_queue_bytes": (
                    self.smoothed_queue_bytes.smooth_total()
                ),
                "input_bytes_per_s": (
                    self.smoothed_input_bytes.smooth_rate()
                ),
                "entries": len(self.entries),
                "stale_epoch_rejects": self.stale_epoch_rejects,
                "partitioned": self.partitioned,
                "chain_waiters": self._chain_waiters,
            },
            **_encryption_status(self._enc),
        }

    async def pop(self, req: TLogPop) -> TLogPopReply:
        """Pop the log prefix at or below `version` (storage holds it
        durably): the retained entries, the queue bytes and the disk
        queue shrink, so a restart replays only the tail between
        storage-durable and the head. `self.version` is unaffected."""
        import bisect

        _fence_epoch(req, self)
        cut = bisect.bisect_right(
            self.entries, req.version, key=lambda e: e[0]
        )
        if cut:
            dropped = self.entries[:cut]
            self.entries = self.entries[cut:]
            self._queue_bytes -= sum(
                _mutation_bytes(ms) for _v, ms in dropped
            )
            self.smoothed_queue_bytes.set_total(self._queue_bytes)
        if self._dq is not None and self._seq_by_version:
            last_seq = None
            kept = []
            for v, s in self._seq_by_version:
                if v <= req.version:
                    last_seq = s
                else:
                    kept.append((v, s))
            if last_seq is not None:
                if not kept:
                    # the pop empties the queue: persist the head version
                    # first, so a restart of a fully popped log comes back
                    # at the head and never at -1 (marker, then pop: a
                    # crash between them leaves both). With a surviving
                    # tail the scan restores the head on its own.
                    await asyncio.get_event_loop().run_in_executor(
                        None, self._write_popped_marker, self.version
                    )
                self._dq.pop(last_seq + 1)
                self._dq.commit()
                self._seq_by_version = kept
        return TLogPopReply(durable_version=self.version)

    def _marker_path(self) -> str:
        return os.path.join(self._data_dir, "POPPED_VERSION")

    def _read_popped_marker(self) -> int:
        try:
            with open(self._marker_path()) as f:
                return int(f.read().strip())
        except (FileNotFoundError, ValueError):
            return -1

    def _write_popped_marker(self, version: int) -> None:
        tmp = self._marker_path() + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{version}\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._marker_path())

    def close_disk(self) -> None:
        """Release the disk queue (a successor on the same files must be
        able to reopen them)."""
        if self._dq is not None:
            try:
                self._dq.close()
            except Exception:
                pass
            self._dq = None

    async def peek(self, req: TLogPeek) -> TLogPeekReply:
        i = self._first_after(req.after_version)
        if i < len(self.entries):
            v, muts = self.entries[i]
            return TLogPeekReply(version=v, mutations=muts)
        return TLogPeekReply(version=-1, mutations=[])

    async def peek_batch(self, req: TLogPeekBatchReq) -> TLogPeekBatchReply:
        """Batched tail read for a storage catch-up: the entries above
        after_version, at most max_entries (a linear restart, not one
        call a version)."""
        i = self._first_after(req.after_version)
        chunk = self.entries[i : i + req.max_entries]
        return TLogPeekBatchReply(
            versions=[v for v, _m in chunk],
            groups=[m for _v, m in chunk],
        )

    def _first_after(self, after_version: int) -> int:
        """Binary search: the entries ascend by version."""
        import bisect

        return bisect.bisect_right(
            self.entries, after_version, key=lambda e: e[0]
        )

    async def get_version(self, req: RoleVersionReq) -> RoleVersionReply:
        return RoleVersionReply(version=self.version)


class SequencerRole:
    """Wire-served sequencer (the reference's master, MasterInterface):
    version-batch allotment behind a call, so several proxies share one
    global version chain. It wraps the Sequencer state machine
    (cluster/sequencer.py: in-order grants a proxy, the duplicate-replay
    cache, the live committed version) on the wall clock.

    On top of it, it tracks the previous version of each tag: a grant
    declares which tag-partitioned tlogs the batch will push to, and the
    reply carries each tag's previous granted version, so every tlog
    sees a gapless chain of the versions that own its tag."""

    def __init__(self, *, epoch: int = 0, recovery_version: int = 0,
                 n_tags: int = 1):
        from foundationdb_tpu_torch.cluster.sequencer import Sequencer
        from foundationdb_tpu_torch.utils.metrics import TimerSmoother

        class _WallClock:
            def now(self):
                return time.monotonic()

            async def delay(self, seconds):
                await asyncio.sleep(seconds)

        self.epoch = epoch
        self.stale_epoch_rejects = 0
        self.recovery_version = recovery_version
        self.n_tags = n_tags
        self._seq = Sequencer(_WallClock(), recovery_version=recovery_version)
        #: tag -> the last granted version touching it (missing: the
        #: recovery version, where the two-phase lock set every tlog's
        #: floor)
        self._tag_prev: dict[int, int] = {}
        #: version -> the tag_prevs granted with it (a duplicate grant
        #: replays the same ones); a bounded FIFO
        self._grant_cache: dict[int, list[int]] = {}
        self.grants = 0
        self.smoothed_grants = TimerSmoother(1.0)

    async def get_commit_version(
        self, req: GetCommitVersionRequest
    ) -> GetCommitVersionReply:
        _fence_epoch(req, self)
        rep = await self._seq.get_commit_version(
            req.proxy_id, req.request_num, req.most_recent_processed
        )
        if rep is None:
            raise transport.RemoteError(
                "sequencer: request_num below most_recent_processed"
            )
        tags = list(req.tags or ())
        if rep.version in self._grant_cache:
            tag_prevs = self._grant_cache[rep.version]
        else:
            # a fresh grant: snapshot each declared tag's prev and move it
            # to this version, with no await since the grant, so grants
            # running at once see their prevs in grant order
            tag_prevs = [
                self._tag_prev.get(t, self.recovery_version) for t in tags
            ]
            for t in tags:
                self._tag_prev[t] = rep.version
            self._grant_cache[rep.version] = tag_prevs
            while len(self._grant_cache) > 4096:
                self._grant_cache.pop(next(iter(self._grant_cache)))
            self.grants += 1
            self.smoothed_grants.add_delta(1)
        return GetCommitVersionReply(
            version=rep.version,
            prev_version=rep.prev_version,
            request_num=rep.request_num,
            tag_prevs=tag_prevs,
        )

    async def report_committed(
        self, req: ReportRawCommittedVersionRequest
    ) -> ReportRawCommittedVersionReply:
        _fence_epoch(req, self)
        if req.version >= 0:
            self._seq.report_live_committed_version(req.version)
        return ReportRawCommittedVersionReply(
            live_version=self._seq.get_live_committed_version()
        )

    async def get_version(self, req: RoleVersionReq) -> RoleVersionReply:
        """The allocated head: a recovery derives the new generation's
        recovery version from it, so a version granted but never pushed
        is never granted again."""
        return RoleVersionReply(version=self._seq.version)

    def status(self) -> dict:
        return {
            "role": "sequencer",
            "version": self._seq.version,
            "epoch": self.epoch,
            "qos": {
                "grants": self.grants,
                "grants_per_s": self.smoothed_grants.smooth_rate(),
                "live_committed_version": (
                    self._seq.get_live_committed_version()
                ),
                "tags": self.n_tags,
                "proxies_seen": len(self._seq._proxies),
                "stale_epoch_rejects": self.stale_epoch_rejects,
            },
        }


class StorageRole:
    """Wire-served storage: a versioned point store (SET and CLEAR_RANGE
    mutations) on the `memory` engine (a dict of version histories, a
    mutation log and checkpoints) or the `lsm` engine (native/vlsm.cpp
    behind the same mutation log)."""

    MUT_SET = 0
    MUT_CLEAR_RANGE = 1

    #: checkpoint every N applied versions when persistent
    CHECKPOINT_INTERVAL = 8

    #: memtable budget before the LSM engine flushes (bytes)
    LSM_FLUSH_BYTES = 4 << 20

    def __init__(self, data_dir: str | None = None, engine: str = "memory",
                 window: int = 5_000_000, encryption=None):
        from foundationdb_tpu_torch.cluster import sampling as _sampling
        from foundationdb_tpu_torch.utils.metrics import (
            LatencySample,
            TimerSmoother,
        )

        # encryption at rest (crypto/at_rest.StorageEncryption): every
        # SET value is sealed once, in the executor, before it reaches
        # the WAL, the store or a checkpoint, so no cipher runs on the
        # event loop under the apply lock and nothing is sealed twice.
        # Keys stay plaintext (run and checkpoint order); reads open
        # values through the cipher cache (a plaintext record written
        # before encryption was enabled passes through).
        self._enc = encryption if data_dir else None
        if self._enc is not None:
            # both cipher identities, so the seal path starts warm (a
            # REST KMS still pays one refresh trip an
            # ENCRYPT_KEY_REFRESH_INTERVAL, off the hot path), and a KMS
            # that does not answer fails the role before it opens a file
            self._enc.prefetch()
        # key -> [(version, value or None)] ascending (memory engine)
        self.history: dict[bytes, list[tuple[int, Optional[bytes]]]] = {}
        # the empty store is readable at version 0 (a GRV before any
        # commit must not block behind the first apply)
        self.version = 0
        self._cond: asyncio.Condition | None = None
        self._data_dir = data_dir
        self._applies_since_ckpt = 0
        # Incremental durability (KeyValueStoreMemory's discipline,
        # fdbserver/KeyValueStoreMemory.actor.cpp): every apply streams
        # its mutations to a local DiskQueue and fsyncs before acking
        # durable_version (the tlog pops on that ack). A checkpoint is a
        # periodic compaction that pops the log prefix; a restart loads
        # the checkpoint and replays only the log tail.
        self._dq = None
        self._seq_by_version: list[tuple[int, int]] = []
        # Serializes write-ahead logging: the fsync runs in an executor
        # outside the read condition's lock (reads must not stall behind
        # the disk), so without this two applies at once could log out
        # of version order and replay would skip the lower version.
        self._log_lock: asyncio.Lock | None = None
        self.replayed_on_restart = 0
        # the storage engine (the reference's storage-engine knob,
        # fdbserver/worker.actor.cpp openKVStore): "memory" =
        # KeyValueStoreMemory-class (a dict, the WAL, a checkpoint blob);
        # "lsm" = the versioned LSM (data past RAM, restart in proportion
        # to the WAL tail, at-version reads off disk runs)
        self.engine = engine
        self._lsm = None
        self.window = window
        # saturation sensors: smoothed apply bandwidth and the batch-size
        # distribution (the version lag behind the committed head is
        # joined where the status is assembled, where the head is known)
        self.smoothed_input_bytes = TimerSmoother(1.0)
        self.apply_batch_size = LatencySample("applyBatchMutations")
        self._applies = 0
        # skew sensors: the byteSample and the busiest-tag pair, seeded
        # from wall entropy on the wall clock (a wire role)
        self.byte_sample = _sampling.ByteSample()
        self.read_tags = _sampling.TagCounter()
        self.write_tags = _sampling.TagCounter()
        if data_dir:
            from foundationdb_tpu_torch import native

            os.makedirs(data_dir, exist_ok=True)
            _check_encryption_marker(data_dir, self._enc)
            self._dq = native.DiskQueue(os.path.join(data_dir, "mutlog"))
            if engine == "lsm":
                self._lsm = native.VersionedLsm(
                    os.path.join(data_dir, "kvstore"), window=window
                )
                self.version = self._lsm.durable_version
            else:
                self._load_checkpoint()
            self._replay_local_log()
        elif engine == "lsm":
            raise ValueError("engine='lsm' requires a data_dir")

    # -- durable-version checkpoints (the storageserver durableVersion
    # discipline: persist at a version, replay the tail on restart) --

    async def aclose_disk(self) -> None:
        """close_disk under the WAL lock: an apply in flight runs
        _log_apply_durably on an executor thread inside the native
        queue, and freeing the handles under it would be a
        use-after-free."""
        async with self._log_lock_lazy():
            self.close_disk()

    def close_disk(self) -> None:
        """Release the WAL and LSM handles (a successor on the same files
        must be able to reopen them)."""
        if self._dq is not None:
            try:
                self._dq.close()
            except Exception:
                pass
            self._dq = None
        if self._lsm is not None:
            try:
                self._lsm.close()
            except Exception:
                pass
            self._lsm = None

    def _ckpt_path(self) -> str:
        return os.path.join(self._data_dir, "storage.ckpt")

    def _serialize_checkpoint(self) -> bytes:
        out = codec.WriteBuffer()
        codec.w_i64(out, self.version)
        kvs = []
        for k, hist in self.history.items():
            value = None
            for v, val in hist:
                if v <= self.version:
                    value = val
            if value is not None:
                kvs.append((k, value))
        _w_kvlist(out, kvs)
        return out.getvalue()

    def _write_checkpoint_blob(self, blob: bytes) -> None:
        # values in the blob are already sealed (sealed once, at apply)
        tmp = self._ckpt_path() + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._ckpt_path())  # an atomic install

    def _checkpoint(self) -> None:
        self._write_checkpoint_blob(self._serialize_checkpoint())

    def _load_checkpoint(self) -> None:
        try:
            with open(self._ckpt_path(), "rb") as f:
                blob = memoryview(f.read())
        except FileNotFoundError:
            return
        version, off = codec.r_i64(blob, 0)
        kvs, _off = _r_kvlist(blob, off)
        self.version = version
        self.history = {k: [(version, v)] for k, v in kvs}

    # -- the mutation log (incremental durability) -----------------------
    # Records are codec-encoded StorageApply messages: the registered wire
    # codec the calls use (the TLog logs its records the same way).

    def _seal_values(self, req):
        """Seal every SET value of a StorageApply: the one place values
        are encrypted (the WAL, the store and the checkpoints carry the
        sealed bytes from here on). Runs in the executor."""
        return StorageApply(
            version=req.version,
            mutations=[
                codec.Mutation(m.op, m.param1, self._enc.seal(m.param2))
                if m.op == self.MUT_SET
                else m
                for m in req.mutations
            ],
        )

    async def _sealed(self, reqs: list) -> list:
        """`reqs` with their SET values sealed, in the executor (as
        they are when encryption is off)."""
        if not reqs or self._enc is None:
            return reqs
        return await asyncio.get_event_loop().run_in_executor(
            None, lambda rs: [self._seal_values(r) for r in rs], reqs
        )

    def _open(self, value):
        """A stored value as the client wrote it (sealed values opened;
        a plain pass-through when encryption is off: the marker check at
        start-up made sure the store is unencrypted, and a user's value
        may start with the header's magic)."""
        if value is None or self._enc is None:
            return value
        return self._enc.open(value)

    def _replay_local_log(self) -> None:
        """Restart: replay the log tail above the checkpoint, at a cost
        in proportion to the tail, not the dataset (the values in the
        records are sealed: stored as they are, opened on read)."""
        for seq, blob in self._dq.recovered:
            if self._enc is None and _looks_sealed(blob):
                # codec records never start with the cipher's magic: a
                # sealed blob here means a lost marker (values sealed
                # inside plain codec records only the marker guards)
                raise RuntimeError(
                    "sealed storage WAL record but encryption is disabled"
                )
            rec = codec.decode(blob)
            if rec.version > self.version:
                self._apply_mutations(rec.version, rec.mutations)
                self.version = rec.version
                self.replayed_on_restart += 1
            self._seq_by_version.append((rec.version, seq))

    def _log_apply_durably(self, reqs: list) -> None:
        """Write ahead and fsync a group of versions' mutations (one
        fsync a group). Runs in the executor, before the in-memory apply
        and the ack."""
        seqs = [
            (req.version, self._dq.push(codec.encode(req)))
            for req in reqs
        ]
        if self._dq.commit() is None:
            # fsync or pwrite failed: not durable, so no ack (the tlog
            # pops on our durable_version)
            raise transport.RemoteError("storage mutation-log commit failed")
        self._seq_by_version.extend(seqs)

    def _compact_log(self, ckpt_version: int) -> None:
        """Once a checkpoint at ckpt_version is installed, the log prefix
        at or below it is dead: pop it."""
        last_seq = None
        kept = []
        for v, s in self._seq_by_version:
            if v <= ckpt_version:
                last_seq = s
            else:
                kept.append((v, s))
        if last_seq is not None:
            self._dq.pop(last_seq + 1)
            self._dq.commit()
            self._seq_by_version = kept

    def _apply_mutations(self, version: int, mutations) -> None:
        from foundationdb_tpu_torch.cluster.sampling import tag_of_key

        self._applies += 1
        self.apply_batch_size.sample(len(mutations))
        self.smoothed_input_bytes.add_delta(_mutation_bytes(mutations))
        # the skew sensors see every engine's applies (the byteSample
        # estimates the live keyspace; a clear drops its span)
        for m in mutations:
            nb = 8 + len(m.param1) + len(m.param2)
            self.write_tags.note(tag_of_key(m.param1), nb)
            if m.op == self.MUT_SET:
                self.byte_sample.note_write(m.param1, m.param2)
            elif m.op == self.MUT_CLEAR_RANGE:
                self.byte_sample.erase_range(m.param1, m.param2)
        if self._lsm is not None:
            # values arrive sealed when encryption is on; keys stay
            # plaintext for the runs' order (crypto/at_rest.py)
            self._lsm.apply(
                version, [(m.op, m.param1, m.param2) for m in mutations]
            )
            return
        for m in mutations:
            if m.op == self.MUT_SET:
                self.history.setdefault(m.param1, []).append(
                    (version, m.param2)
                )
            elif m.op == self.MUT_CLEAR_RANGE:
                for k in list(self.history):
                    if m.param1 <= k < m.param2:
                        self.history[k].append((version, None))

    async def catch_up_from_tlog(self, tlog_address: str) -> None:
        """Replay the tlog tail above our durable version (the restart
        path of storageserver.actor.cpp:9117's pull loop) in chunks:
        linear in the tail's length."""
        conn = transport.RpcConnection(tlog_address, tls=_tls_from_env())
        await conn.connect()
        try:
            while True:
                try:
                    rep = await conn.call(
                        TOKEN_TLOG_PEEK_BATCH,
                        TLogPeekBatchReq(
                            after_version=self.version, max_entries=256
                        ),
                        timeout=30.0,
                    )
                except (transport.TransportError, ConnectionError,
                        asyncio.TimeoutError) as e:
                    # retryable for the recovery caller, against a fresh
                    # tlog address
                    raise transport.RemoteError(
                        f"tlog catch-up from {tlog_address} failed: {e!r}"
                    ) from e
                if not rep.versions:
                    break
                reqs = await self._sealed([
                    StorageApply(version=v, mutations=muts)
                    for v, muts in zip(rep.versions, rep.groups)
                    if v > self.version
                ])
                if reqs and self._dq is not None:
                    # one fsync a peek chunk, not a version
                    await self._log_durably(reqs)
                for req in reqs:
                    await self._apply_logged(req)
        finally:
            await conn.close()

    def _log_lock_lazy(self) -> asyncio.Lock:
        if self._log_lock is None:
            self._log_lock = asyncio.Lock()
        return self._log_lock

    def _cond_lazy(self) -> asyncio.Condition:
        if self._cond is None:
            self._cond = asyncio.Condition()
        return self._cond

    async def apply(self, req: StorageApply) -> StorageApplyReply:
        # write ahead: fsync the mutations to the local log before the
        # in-memory apply and the ack (the tlog pops on durable_version).
        # The fsync runs outside the condition's lock, so reads at
        # versions already applied never wait on the disk; a duplicate
        # record a lost race logged is skipped on replay.
        if req.version > self.version:
            (req,) = await self._sealed([req])
            if self._dq is not None:
                await self._log_durably([req])
        return await self._apply_logged(req)

    async def apply_batch(self, req: StorageApplyBatch) -> StorageApplyReply:
        """Version-ordered group apply (the applier's drain): one
        sealing pass, one write-ahead group fsync (when persistent) and
        one ordered in-memory sweep for the whole chunk.

        With `prev_versions` (several proxies) each contiguous run of the
        chunk first waits for its predecessor version to land: the
        global chain is rebuilt here, so interleaved appliers never apply
        out of order (the WAL stays version-ascending, as replay needs)."""
        prevs = list(req.prev_versions or ())
        if prevs and len(prevs) == len(req.versions):
            return await self._apply_batch_chained(req, prevs)
        reqs = [
            StorageApply(version=v, mutations=m)
            for v, m in zip(req.versions, req.groups)
            if v > self.version
        ]
        return await self._apply_run(reqs)

    def _durable_reply(self) -> StorageApplyReply:
        return StorageApplyReply(
            durable_version=self.version,
            durable=1 if self._dq is not None else 0,
        )

    async def _apply_run(self, reqs: list) -> StorageApplyReply:
        reqs = await self._sealed(reqs)
        if reqs and self._dq is not None:
            await self._log_durably(reqs)
        rep = None
        for r in reqs:
            rep = await self._apply_logged(r)
        return rep if rep is not None else self._durable_reply()

    async def _apply_batch_chained(self, req, prevs) -> StorageApplyReply:
        rep = None
        cond = self._cond_lazy()
        i, n = 0, len(req.versions)
        while i < n:
            # a contiguous run: each item's prev is the item before it
            j = i
            while j + 1 < n and prevs[j + 1] == req.versions[j]:
                j += 1
            run_prev = prevs[i]
            try:
                async with cond:
                    await asyncio.wait_for(
                        cond.wait_for(lambda: self.version >= run_prev),
                        timeout=10.0,
                    )
            except asyncio.TimeoutError:
                # the predecessor's proxy died mid-window: a retryable
                # stall (recovery's catch-up advances the floor past the
                # gap and drives us again from the tlogs)
                raise transport.RemoteError(
                    f"storage chain stall: prev_version {run_prev} "
                    "never applied (retryable)"
                )
            rep = await self._apply_run([
                StorageApply(version=v, mutations=m)
                for v, m in zip(req.versions[i:j + 1], req.groups[i:j + 1])
                if v > self.version
            ]) or rep
            i = j + 1
        return rep if rep is not None else self._durable_reply()

    async def _log_durably(self, reqs: list) -> None:
        """The write-ahead fsync in the executor, under a lock of this
        store: records must reach the disk in version order (replay skips
        any version at or below the restart cursor, so an out-of-order
        pair would drop the lower one)."""
        async with self._log_lock_lazy():
            await asyncio.get_event_loop().run_in_executor(
                None, self._log_apply_durably, reqs
            )

    async def _apply_logged(self, req: StorageApply) -> StorageApplyReply:
        cond = self._cond_lazy()
        async with cond:
            if req.version > self.version:
                self._apply_mutations(req.version, req.mutations)
                self.version = req.version
                if self._data_dir and self._lsm is not None:
                    self._applies_since_ckpt += 1
                    if (
                        self._applies_since_ckpt >= self.CHECKPOINT_INTERVAL
                        or self._lsm.mem_bytes > self.LSM_FLUSH_BYTES
                    ):
                        self._applies_since_ckpt = 0
                        # the LSM checkpoint: flush the memtable to a
                        # durable run (the fsync off the loop), advance
                        # the MVCC floor, pop the WAL prefix the run holds
                        lsm = self._lsm

                        def lsm_flush():
                            durable = lsm.flush()
                            lsm.set_floor(durable - self.window)
                            self._compact_log(durable)

                        # _compact_log pops the native WAL queue while an
                        # apply's _log_apply_durably may push it from
                        # another executor thread, and the queue takes no
                        # locks: serialize through _log_lock
                        async with self._log_lock_lazy():
                            await asyncio.get_event_loop().run_in_executor(
                                None, lsm_flush
                            )
                elif self._data_dir:
                    self._applies_since_ckpt += 1
                    if self._applies_since_ckpt >= self.CHECKPOINT_INTERVAL:
                        self._applies_since_ckpt = 0
                        # a checkpoint is a compaction: serialize under the
                        # lock (a consistent view), install and pop the
                        # log prefix off the event loop
                        blob = self._serialize_checkpoint()
                        ckpt_version = self.version

                        def install():
                            self._write_checkpoint_blob(blob)
                            self._compact_log(ckpt_version)

                        # the same WAL push/pop race as the LSM branch
                        async with self._log_lock_lazy():
                            await asyncio.get_event_loop().run_in_executor(
                                None, install
                            )
                cond.notify_all()
            return self._durable_reply()

    async def get_version(self, req: RoleVersionReq) -> RoleVersionReply:
        return RoleVersionReply(version=self.version)

    async def catch_up(self, req: StorageCatchUp) -> StorageCatchUpReply:
        """Recovery catch-up: replay the locked tlogs' tails above our
        durable version now, before the new generation's first apply can
        move our version past them. The pull is idempotent a version, so
        a straggling apply of the dying generation is harmless."""
        addrs = [req.tlog_address] + list(req.tlog_addresses or ())
        if len(addrs) > 1:
            await self.catch_up_from_tlogs(addrs)
        else:
            await self.catch_up_from_tlog(req.tlog_address)
        if req.recovery_version >= 0:
            await self.advance_floor(req.recovery_version)
        return StorageCatchUpReply(version=self.version)

    async def advance_floor(self, recovery_version: int) -> None:
        """Advance the version floor to the new generation's recovery
        version and wake the read and chain waiters: the versions between
        the old generation's tail and the recovery version carry no data,
        and the new generation's first chained apply waits on
        prev == recovery_version."""
        cond = self._cond_lazy()
        async with cond:
            if recovery_version > self.version:
                self.version = recovery_version
                cond.notify_all()

    async def catch_up_from_tlogs(self, addresses: list) -> None:
        """Tag-partitioned catch-up: each tlog holds only the versions of
        its tag, so the union of the tails is the commit history above
        our durable version; k-way merge the peek streams by version and
        apply in merged order (the WAL stays version-ascending)."""
        conns = []
        try:
            for a in addresses:
                c = transport.RpcConnection(a, tls=_tls_from_env())
                await c.connect()
                conns.append((a, c))
            n = len(conns)
            cursors = [self.version] * n
            buffers: list[list] = [[] for _ in conns]
            done = [False] * n
            while True:
                for i, (a, c) in enumerate(conns):
                    if done[i] or buffers[i]:
                        continue
                    try:
                        rep = await c.call(
                            TOKEN_TLOG_PEEK_BATCH,
                            TLogPeekBatchReq(
                                after_version=cursors[i], max_entries=256
                            ),
                            timeout=30.0,
                        )
                    except (transport.TransportError, ConnectionError,
                            asyncio.TimeoutError) as e:
                        raise transport.RemoteError(
                            f"tlog catch-up from {a} failed: {e!r}"
                        ) from e
                    if not rep.versions:
                        done[i] = True
                        continue
                    cursors[i] = rep.versions[-1]
                    buffers[i] = list(zip(rep.versions, rep.groups))
                if not any(buffers):
                    break
                # merge by version until a stream needs a refill; a
                # version spanning several tags is in every owning tlog
                # (with that tag's mutations): heads of one version are
                # combined into one apply, never dropped
                chunk = []
                while len(chunk) < 256:
                    if any(not done[i] and not buffers[i] for i in range(n)):
                        break
                    live = [i for i in range(n) if buffers[i]]
                    if not live:
                        break
                    vmin = min(buffers[i][0][0] for i in live)
                    muts = []
                    for i in live:
                        if buffers[i][0][0] == vmin:
                            muts.extend(buffers[i].pop(0)[1])
                    chunk.append((vmin, muts))
                await self._apply_run([
                    StorageApply(version=v, mutations=muts)
                    for v, muts in chunk
                    if v > self.version
                ])
        finally:
            for _a, c in conns:
                await c.close()

    def status(self) -> dict:
        """The StatusRequest payload: apply bandwidth, the batch-size
        distribution, the store's size and the skew sensors."""
        return {
            "role": "storage",
            "version": self.version,
            "engine": self.engine,
            "qos": {
                "applies": self._applies,
                "apply_batch_mutations": self.apply_batch_size.as_dict(),
                "input_bytes_per_s": (
                    self.smoothed_input_bytes.smooth_rate()
                ),
                "keys": len(self.history),
                "sampled_bytes": self.byte_sample.total_bytes(),
                "sample_keys": self.byte_sample.count,
                "hot_ranges": self.byte_sample.hot_ranges(),
                "busiest_read_tag": self.read_tags.busiest(),
                "busiest_write_tag": self.write_tags.busiest(),
            },
            **_encryption_status(self._enc),
        }

    async def get(self, req: StorageGet) -> StorageGetReply:
        from foundationdb_tpu_torch.cluster.sampling import tag_of_key

        self.read_tags.note(tag_of_key(req.key), len(req.key))
        cond = self._cond_lazy()
        async with cond:
            await cond.wait_for(lambda: self.version >= req.version)
        if self._lsm is not None:
            # disk reads and the open (a decrypt, maybe a by-id KMS
            # fetch) off the event loop: neither may stall unrelated
            # requests
            lsm = self._lsm
            value = await asyncio.get_event_loop().run_in_executor(
                None, lambda: self._open(lsm.get(req.key, req.version))
            )
            return StorageGetReply(value=value)
        value = self._get_at(req.key, req.version)
        if value is not None and self._enc is not None:
            # the decrypt (and a cold by-id KMS fetch) off the loop, as
            # the LSM's reads
            value = await asyncio.get_event_loop().run_in_executor(
                None, self._open, value
            )
        return StorageGetReply(value=value)

    def _get_at(self, key: bytes, version: int):
        """The newest value at or below `version` in the memory history
        (still sealed when encryption is on)."""
        value = None
        for v, val in self.history.get(key, []):
            if v <= version:
                value = val
            else:
                break
        return value

    async def get_batch(self, req: StorageGetBatch) -> StorageGetBatchReply:
        """Coalesced reads: one version wait (the batch's max), then
        every key served at its own requested version (exact MVCC), one
        round trip for an event-loop turn's worth of the proxy's reads."""
        from foundationdb_tpu_torch.cluster.sampling import tag_of_key

        for k in req.keys:
            self.read_tags.note(tag_of_key(k), len(k))
        vmax = max(req.versions) if req.versions else 0
        cond = self._cond_lazy()
        async with cond:
            await cond.wait_for(lambda: self.version >= vmax)
        if self._lsm is not None:
            lsm = self._lsm

            def read_all():
                # reads and opens in one executor hop a batch
                return [self._open(lsm.get(k, rv))
                        for k, rv in zip(req.keys, req.versions)]

            values = await asyncio.get_event_loop().run_in_executor(
                None, read_all
            )
            return StorageGetBatchReply(values=values)
        values = [
            self._get_at(k, rv) for k, rv in zip(req.keys, req.versions)
        ]
        if self._enc is not None:
            values = await asyncio.get_event_loop().run_in_executor(
                None, lambda vs: [self._open(v) for v in vs], values
            )
        return StorageGetBatchReply(values=values)

    async def snapshot(self, req: StorageSnapshotReq) -> StorageSnapshotReply:
        cond = self._cond_lazy()
        async with cond:
            await cond.wait_for(lambda: self.version >= req.version)
        if self._lsm is not None:
            lsm = self._lsm

            def range_open():
                # the range and every value's open in the executor: a
                # whole dataset's decrypt on the loop would stall every
                # other request
                return [(k, self._open(v))
                        for k, v in lsm.range(b"", b"", req.version)]

            kvs = await asyncio.get_event_loop().run_in_executor(
                None, range_open
            )
            return StorageSnapshotReply(version=self.version, kvs=kvs)
        kvs = []
        for k, hist in sorted(self.history.items()):
            value = None
            for v, val in hist:
                if v <= req.version:
                    value = val  # the newest value at or below the version
            if value is not None:
                kvs.append((k, value))
        if self._enc is not None:
            # the sealed list is built already, so the loop may change
            # the history meanwhile
            kvs = await asyncio.get_event_loop().run_in_executor(
                None, lambda rows: [(k, self._open(v)) for k, v in rows],
                kvs,
            )
        return StorageSnapshotReply(version=self.version, kvs=kvs)


# ---------------------------------------------------------------------------
# Wire-cluster lifecycle: the worker / cluster-controller shape.
#
# The reference runs ONE binary (`fdbserver`) whose worker dispatch loop
# (fdbserver/worker.actor.cpp:2305-2811) can host any role in response
# to the cluster controller's Initialize*Request streams, and the
# ClusterController rebuilds the transaction system as a unit in a new
# generation on any failure (ClusterRecovery.actor.cpp). The classes
# below are that deployment shape for this framework: WorkerRole hosts
# any role behind a token dispatch, ClusterControllerRole recruits a
# declarative topology onto registered workers, heartbeats them, and
# runs the cluster/generation.py recovery walk on any transaction-path
# death — the same state machine the sim ClusterController
# (cluster/recovery.py) walks, so sim and wire cannot drift.


class RatekeeperRole:
    """Wire-mode Ratekeeper: `fdbserver/Ratekeeper.actor.cpp` as an OS
    process. Polls every peer role's StatusRequest for its saturation
    sensors (the same qos blocks fdbtop renders), drives the SAME
    `AdmissionController` law the sim Ratekeeper runs, and serves the
    live budget over GetRateInfo. Robustness contract: a peer that
    stops answering simply contributes no sensors this interval; when
    NO peer answers, the law's fail-safe decay engages (budget decays
    toward the conservative floor) — and a consumer that cannot reach
    THIS process applies its own decay (ProxyPipeline._rate_fetcher),
    so a dead ratekeeper never freezes the cluster at full speed."""

    def __init__(self, peers: list[str], *, interval: float = 0.25,
                 controller: str | None = None):
        import time as _time

        from foundationdb_tpu_torch.cluster.ratekeeper import AdmissionController

        self.peers = [p for p in peers if p]
        self.interval = interval
        self.law = AdmissionController(clock=_time.monotonic)
        self._conns: dict[str, transport.RpcConnection] = {}
        self._task: asyncio.Task | None = None
        self.polls = 0
        self.poll_failures = 0
        # -- live peer discovery (the frozen-peer-list bugfix): with a
        # cluster controller configured, the peer set RE-RESOLVES from
        # the controller's live topology every control cycle, so a
        # re-recruited resolver's occupancy feed rejoins the admission
        # law the cycle after recovery instead of never. The static
        # `peers` list remains the controller-less fallback (and the
        # bootstrap set while the controller is still recruiting).
        self._controller_addr = controller
        self._controller_conns: dict = {}  # _cached_call cache
        self.peer_refreshes = 0
        self.topology_epoch = 0
        # -- push-based rate updates: when a control cycle
        # moves the budget past the hysteresis threshold (or flips the
        # binding limiter / staleness), the fresh GetRateInfo payload
        # is PUSHED to every proxy in the topology instead of waiting
        # out the proxies' poll cadence. Threshold semantics mirror the
        # law's own hysteresis discipline: small drift never floods the
        # wire, overload onset lands in one control cycle.
        self.push_threshold = 0.15
        self.rate_pushes = 0
        self.rate_push_failures = 0
        self._proxy_addrs: list[str] = []
        self._last_pushed: dict | None = None
        #: last cycle's observed GRV admission rate (the law's
        #: actualTps input) — surfaced in status so the wire feedback
        #: path is testable end to end
        self.observed_grv_per_s = 0.0

    async def start(self) -> None:
        self._task = asyncio.ensure_future(self._poll_loop())

    async def stop(self) -> None:
        """Cancel the poll loop and close every cached peer/controller
        connection — a worker re-recruiting over this role must not
        leak one socket per polled peer per recovery."""
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        await _close_all(self._conns)
        await _close_all(self._controller_conns)

    async def _poll_one(self, path: str) -> dict:
        import json as _json

        conn = self._conns.get(path)
        if conn is None:
            conn = transport.RpcConnection(path, tls=_tls_from_env())
            await conn.connect(retries=1)
            self._conns[path] = conn
        # classification boundary is _poll_loop's gather with
        # return_exceptions=True: a failed poll counts poll_failures
        # and invalidates the cached connection there
        reply = await conn.call(  # flowcheck: ignore[wire.unclassified-error]
            TOKEN_STATUS, StatusRequest(pad=0), timeout=2.0
        )
        return _json.loads(reply.payload)

    async def _refresh_peers(self) -> None:
        """Re-resolve the peer list from the controller topology (one
        TopologyRequest per control cycle). Failures keep the last
        known peer set — a dead controller degrades to static peers,
        and the law's own staleness decay covers dead sensors."""
        import json as _json

        if self._controller_addr is None:
            return
        try:
            reply = await _cached_call(
                self._controller_conns, self._controller_addr,
                TOKEN_TOPOLOGY, TopologyRequest(pad=0),
                timeout=2.0, retries=1,
            )
            topo = _json.loads(reply.payload)
        except asyncio.CancelledError:
            raise
        except Exception:
            return
        peers = sorted(
            {
                entry["address"]
                for entry in topo.get("roles", {}).values()
                if entry.get("kind") != "ratekeeper"
            }
        )
        self._proxy_addrs = sorted(
            {
                entry["address"]
                for entry in topo.get("roles", {}).values()
                if entry.get("kind") == "proxy"
            }
        )
        if peers and peers != self.peers:
            # drop cached connections to peers that left the topology
            for gone in set(self._conns) - set(peers):
                conn = self._conns.pop(gone)
                try:
                    await conn.close()
                except Exception:
                    pass
            self.peers = peers
            self.peer_refreshes += 1
        self.topology_epoch = int(topo.get("epoch", 0))

    async def _poll_loop(self) -> None:
        from foundationdb_tpu_torch.cluster.status import _QOS_SLOT

        while True:
            await self._refresh_peers()
            slots: dict = {
                "tlogs": {}, "storages": {}, "resolvers": {},
                "proxies": {},
            }
            answered = 0
            current_tps = 0.0
            # polls are independent I/O and go out CONCURRENTLY: one
            # hung peer (2s call timeout) bounds the cycle at the
            # slowest single peer, not the sum — a serial loop would
            # stretch the control cadence ~Nx while the served budget
            # sat frozen at its last (possibly full-speed) value
            results = await asyncio.gather(
                *(self._poll_one(p) for p in self.peers),
                return_exceptions=True,
            )
            for path, block in zip(self.peers, results):
                if isinstance(block, BaseException):
                    self.poll_failures += 1
                    conn = self._conns.pop(path, None)
                    if conn is not None:
                        try:
                            await conn.close()
                        except Exception:
                            pass
                    continue
                name = os.path.basename(path)
                if name.endswith(".sock"):
                    name = name[: -len(".sock")]
                answered += 1
                slot = _QOS_SLOT.get(block.get("role", ""))
                if slot in slots:
                    slots[slot][name] = block.get("qos", {})
                # the parent pipeline's status socket embeds its GRV
                # block (a process block: role + qos): its served-GRV
                # rate is the law's actualTps
                grv = block.get("grv_proxy")
                if grv:
                    current_tps = max(
                        current_tps,
                        float(grv.get("qos", {}).get("grv_per_s", 0.0)),
                    )
            self.polls += 1
            self.observed_grv_per_s = current_tps
            if answered == 0:
                # total sensor dropout: fail safe, never full speed
                self.law.decay()
            else:
                self.law.update(slots, current_tps=current_tps)
            await self._maybe_push_rate()
            await asyncio.sleep(self.interval)

    def _push_due(self) -> bool:
        """Hysteresis: push only when the budget moved by more than
        push_threshold relative to the last delivered value, or the
        binding limiter / staleness flipped — overload ONSET is exactly
        a limiter flip plus a large budget drop, so it always pushes."""
        info = self.law.rate_info()
        last = self._last_pushed
        if last is None:
            return True
        budget = info["transactions_per_second_limit"]
        moved = abs(budget - last["budget"]) > (
            self.push_threshold * max(last["budget"], self.law.min_tps)
        )
        return (
            moved
            or info["budget_limited_by"]["name"] != last["limiter"]
            or bool(info["budget_stale"]) != last["stale"]
        )

    async def _maybe_push_rate(self) -> None:
        import json as _json

        if not self._proxy_addrs or not self._push_due():
            return
        info = self.law.rate_info()
        # fence stamp: the generation this pusher believes is live
        # (ProxyRole.rate_update rejects a mismatch — a superseded
        # ratekeeper cannot override the new generation's budget)
        info["epoch"] = self.topology_epoch
        payload = _json.dumps(info)
        # pushes go out CONCURRENTLY, like the sensor polls above: one
        # dead/hung proxy (2s call timeout) bounds this step at the
        # slowest single push, not the sum — a serial loop would stall
        # the control cadence on exactly the overload-onset cycles the
        # push exists to speed up
        results = await asyncio.gather(
            *(
                _cached_call(
                    self._conns, addr, TOKEN_RATE_UPDATE,
                    RateUpdate(payload=payload), timeout=2.0, retries=1,
                )
                for addr in self._proxy_addrs
            ),
            return_exceptions=True,
        )
        delivered = False
        for res in results:
            if isinstance(res, asyncio.CancelledError):
                raise res
            if isinstance(res, BaseException):
                # a proxy that can't be pushed still has its poll loop
                # (the backstop) — count and continue
                self.rate_push_failures += 1
            else:
                self.rate_pushes += 1
                delivered = True
        if delivered:
            self._last_pushed = {
                "budget": info["transactions_per_second_limit"],
                "limiter": info["budget_limited_by"]["name"],
                "stale": bool(info["budget_stale"]),
            }

    async def get_rate_info(
        self, _req: GetRateInfoRequest
    ) -> GetRateInfoReply:
        import json as _json

        return GetRateInfoReply(payload=_json.dumps(self.law.rate_info()))

    def status(self) -> dict:
        return {
            "role": "ratekeeper",
            "qos": {
                **self.law.rate_info(),
                "peer_polls": self.polls,
                "peer_poll_failures": self.poll_failures,
                "peers": len(self.peers),
                "peer_refreshes": self.peer_refreshes,
                "topology_epoch": self.topology_epoch,
                "observed_grv_per_s": self.observed_grv_per_s,
                "rate_pushes": self.rate_pushes,
                "rate_push_failures": self.rate_push_failures,
            },
        }


async def _cached_call(conns: dict, address, token: int, msg, *,
                       timeout: float = 30.0, retries: int = 2,
                       delay: float = 0.05, on_fail=None):
    """One call over a cached connection: connect lazily, call, and on
    any failure drop the cache entry (closing the connection) and run
    `on_fail(address)` before raising again: the connect / call /
    invalidate contract of every control-plane caller."""
    try:
        conn = conns.get(address)
        if conn is None:
            conn = transport.RpcConnection(address, tls=_tls_from_env())
            await conn.connect(retries=retries, delay=delay)
            conns[address] = conn
        return await conn.call(token, msg, timeout=timeout)
    except Exception:
        old = conns.pop(address, None)
        if old is not None:
            try:
                await old.close()
            except Exception:
                pass
        if on_fail is not None:
            on_fail(address)
        raise


async def _close_all(conns: dict) -> None:
    for conn in list(conns.values()):
        try:
            await conn.close()
        except Exception:
            pass
    conns.clear()


class ProxyRole:
    """The commit+GRV proxy as a recruitable, killable worker role.

    Wraps ProxyPipeline behind the client front-door RPCs
    (ClientGrv/ClientCommit/ClientRead), so clients reach the commit
    path over the wire like every other hop and a kill -9 of the proxy
    is survivable: the controller recruits a replacement in the next
    generation and the NEW proxy's first batch carries the conservative
    whole-keyspace blind write (cluster/generation.py), aborting every
    in-flight transaction whose snapshot predates recovery."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.epoch = int(spec.get("epoch", 0))
        self.start_version = int(spec.get("start_version", 0))
        self.recovered = False
        self.pipeline: ProxyPipeline | None = None
        self._conns: list[transport.RpcConnection] = []
        #: rate pushes rejected by the epoch fence (a superseded
        #: ratekeeper still pushing) — surfaced in status
        self.stale_rate_pushes = 0

    async def start(self) -> None:
        topo = self.spec["topology"]
        # partial-recruit cleanup: a failed later connect must not leak
        # the connections already opened (a recruit raced a kill here
        # leaks one socket per retry otherwise)
        opened: list[transport.RpcConnection] = []
        try:
            resolvers = []
            for a in topo["resolvers"]:
                c = await connect(a)
                opened.append(c)
                resolvers.append(c)
            # tag-partitioned log system: "tlogs" lists every
            # tlog address; "tlog" stays as the first for back-compat
            tlogs = []
            for a in topo.get("tlogs") or [topo["tlog"]]:
                c = await connect(a)
                opened.append(c)
                tlogs.append(c)
            storage = await connect(topo["storage"])
            opened.append(storage)
            sequencer = None
            if topo.get("sequencer"):
                sequencer = await connect(topo["sequencer"])
                opened.append(sequencer)
            rk = None
            if topo.get("ratekeeper"):
                rk = await connect(topo["ratekeeper"])
                opened.append(rk)
        except BaseException:
            for c in opened:
                try:
                    await c.close()
                except Exception:
                    pass
            raise
        self._conns = opened
        # resolver partition boundaries (hex-encoded in the topology
        # JSON; the controller re-derives them on every resolver-count
        # change — the elastic-recruit path's multi-resolver split)
        boundaries = [
            bytes.fromhex(h)
            for h in topo.get("resolver_boundaries") or []
        ]
        tlog_boundaries = [
            bytes.fromhex(h)
            for h in topo.get("tlog_boundaries") or []
        ]
        self.pipeline = ProxyPipeline(
            resolvers,
            tlogs[0],
            storage,
            batch_interval=float(self.spec.get("batch_interval", 0.002)),
            max_batch=int(self.spec.get("max_batch", 512)),
            start_version=self.start_version,
            epoch=self.epoch,
            ratekeeper=rk,
            trace=bool(self.spec.get("trace", False)),
            resolver_boundaries=boundaries or None,
            sequencer=sequencer,
            proxy_id=str(self.spec.get("proxy_id", "proxy0")),
            tlogs=tlogs,
            tlog_boundaries=tlog_boundaries or None,
        )
        self.pipeline.start()
        if self.spec.get("recover", True):
            # the recovery transaction: the new generation's FIRST
            # batch is the conservative whole-keyspace blind write —
            # it pushes the log (and storage) past the recovery
            # version so reads don't stall, and registers the write
            # that aborts every pre-recovery snapshot
            from foundationdb_tpu_torch.cluster.generation import (
                conservative_recovery_transaction,
            )

            await self.pipeline.commit(
                conservative_recovery_transaction(self.start_version)
            )
        self.recovered = True

    async def stop(self) -> None:
        if self.pipeline is not None:
            await self.pipeline.stop()
        for c in self._conns:
            try:
                await c.close()
            except Exception:
                pass
        self._conns = []

    async def client_grv(self, _req: "ClientGrvRequest") -> "ClientGrvReply":
        try:
            v = await self.pipeline.get_read_version()
        except GrvThrottledError:
            # marker-carrying RemoteError: ClusterClient re-raises the
            # typed retryable error client-side
            raise transport.RemoteError("grv_throttled")
        return ClientGrvReply(version=v)

    async def client_commit(
        self, req: "ClientCommitRequest"
    ) -> "ClientCommitReply":
        try:
            v = await self.pipeline.commit(req.txn)
        except NotCommittedError as e:
            raise transport.RemoteError(f"not_committed: {e}")
        return ClientCommitReply(version=v)

    async def client_read(self, req: "ClientReadRequest") -> "ClientReadReply":
        v = await self.pipeline.read(req.key, req.version)
        return ClientReadReply(value=v)

    async def rate_update(self, req: "RateUpdate") -> "RateUpdateReply":
        """Push-based budget delivery: the ratekeeper calls
        this the cycle the budget moves past its push hysteresis; the
        pipeline applies it exactly like a poll result. The poll loop
        keeps running as the backstop.

        EPOCH-FENCED like every other control frame: the pusher stamps
        its topology epoch, and a mismatch is rejected retryably — a
        superseded-but-alive ratekeeper (re-recruited away after a
        clog) must not keep overriding the live generation's budget
        (its pushes would even clear the fail-safe staleness a dead
        feed is supposed to engage). Epoch 0 == unfenced standalone
        deployment, matching the resolve/tlog fencing convention."""
        import json as _json

        info = _json.loads(req.payload)
        push_epoch = int(info.get("epoch", 0))
        if push_epoch != self.epoch:
            from foundationdb_tpu_torch.cluster.generation import (
                stale_epoch_message,
            )

            self.stale_rate_pushes += 1
            raise transport.RemoteError(
                stale_epoch_message(push_epoch, self.epoch)
            )
        self.pipeline.apply_rate_info(info)
        self.pipeline.rate_pushes_applied += 1
        return RateUpdateReply(payload=_json.dumps({"ok": True}))

    def status(self) -> dict:
        block = _pipeline_status_blocks(self.pipeline)
        payload = block["proxy0"]
        payload["grv_proxy"] = block["grv_proxy0"]
        payload["epoch"] = self.epoch
        payload["recovered"] = self.recovered
        payload["stale_rate_pushes"] = self.stale_rate_pushes
        payload["proxy_id"] = str(self.spec.get("proxy_id", "proxy0"))
        return payload


class WorkerRole:
    """One process that can host any role behind a dispatch loop — the
    fdbserver worker. Every role token is registered up front against a
    dispatcher that routes to the currently hosted role object;
    InitializeRole (the Initialize*Request analog) installs or REPLACES
    a role at a given generation, which is exactly what recovery needs:
    re-initializing a resolver builds a brand-new ResolverRole with
    EMPTY conflict state. A background beacon registers this worker
    with the cluster controller (RegisterWorker) on a cadence — it
    doubles as the liveness signal and re-announces after a monitor
    restart."""

    BEACON_INTERVAL = 0.5

    def __init__(self, worker_id: str, address: str,
                 controller: str | None = None, device=None):
        self.worker_id = worker_id
        self.address = address
        self.controller = controller
        #: the device of the resolvers this worker builds when their
        #: spec names none: None is the card, "cpu" the plain versions
        self.device = device
        self.roles: dict[str, object] = {}  # kind -> hosted role object
        self.role_epochs: dict[str, int] = {}
        self.initializations = 0
        self._reg_task: asyncio.Task | None = None
        self._reg_conn: transport.RpcConnection | None = None

    async def start(self) -> None:
        if self.controller:
            self._reg_task = asyncio.ensure_future(self._register_loop())

    async def stop(self) -> None:
        """Release everything the worker owns: the registration beacon
        task, its controller connection, and every hosted role — the
        ownership hook the res.* pass (and the per-process census)
        require of any store-on-self acquire."""
        task = self._reg_task
        self._reg_task = None
        if task is not None:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        conn = self._reg_conn
        self._reg_conn = None
        if conn is not None:
            try:
                await conn.close()
            except Exception:
                pass
        for kind in list(self.roles):
            old = self.roles.pop(kind)
            self.role_epochs.pop(kind, None)
            if isinstance(old, (ProxyRole, RatekeeperRole)):
                await old.stop()
            elif isinstance(old, StorageRole):
                await old.aclose_disk()
            elif hasattr(old, "close_disk"):
                old.close_disk()

    async def _register_loop(self) -> None:
        import json as _json

        while True:
            try:
                conn = self._reg_conn
                if conn is None:
                    conn = transport.RpcConnection(
                        self.controller, tls=_tls_from_env()
                    )
                    await conn.connect(retries=1)
                    self._reg_conn = conn
                await conn.call(
                    TOKEN_REGISTER_WORKER,
                    RegisterWorker(payload=_json.dumps({
                        "worker_id": self.worker_id,
                        "address": self.address,
                        "pid": os.getpid(),
                        "roles": dict(self.role_epochs),
                    })),
                    timeout=2.0,
                )
            except asyncio.CancelledError:
                raise
            except Exception:
                conn = self._reg_conn
                self._reg_conn = None
                if conn is not None:
                    try:
                        await conn.close()
                    except Exception:
                        pass
            await asyncio.sleep(self.BEACON_INTERVAL)

    def role(self, kind: str):
        r = self.roles.get(kind)
        if r is None:
            # retryable: the controller hasn't recruited this role here
            # (or a monitor-restarted worker lost it — the controller's
            # heartbeat sees the mismatch and recovers)
            raise transport.RemoteError(
                f"worker_not_initialized: no {kind} hosted on "
                f"{self.worker_id}"
            )
        return r

    async def init_role(self, req: "InitializeRole") -> "InitializeRoleReply":
        import json as _json

        spec = _json.loads(req.payload)
        kind = spec["kind"]
        epoch = int(spec.get("epoch", 0))
        old = self.roles.pop(kind, None)
        self.role_epochs.pop(kind, None)
        if isinstance(old, (ProxyRole, RatekeeperRole)):
            await old.stop()
        elif isinstance(old, StorageRole):
            # storage WAL writes run on executor threads: close under
            # the log lock (use-after-free in the native queue
            # otherwise) — and BEFORE the successor (possibly on this
            # same worker) re-opens the data dir
            await old.aclose_disk()
        elif old is not None and hasattr(old, "close_disk"):
            # the tlog's disk ops all run on the event loop; a plain
            # close cannot interleave with a push
            old.close_disk()
        role, info = await self._build_role(kind, epoch, spec)
        self.roles[kind] = role
        self.role_epochs[kind] = epoch
        self.initializations += 1
        from foundationdb_tpu_torch.utils.trace import SEV_INFO, TraceEvent

        TraceEvent("WorkerRoleInitialized", severity=SEV_INFO).detail(
            "WorkerId", self.worker_id
        ).detail("Kind", kind).detail("Epoch", epoch).log()
        return InitializeRoleReply(payload=_json.dumps({
            "ok": True, "kind": kind, "epoch": epoch,
            "worker_id": self.worker_id, **info,
        }))

    async def _build_role(self, kind: str, epoch: int, spec: dict):
        if kind == "resolver":
            if spec.get("resolver_kernel"):
                os.environ["RESOLVER_KERNEL"] = spec["resolver_kernel"]
            # the device: the spec's (the controller's conf "device"),
            # else this worker's own; None is the card, and a "cuda"
            # resolver on a host without one fails here, a failed
            # recruit the controller retries (never a CPU fallback)
            role = ResolverRole(
                backend=spec.get("backend", "cuda"), epoch=epoch,
                compute_cost_per_txn=float(
                    spec.get("compute_cost_per_txn") or 0.0
                ),
                device=spec.get("device") or self.device,
            )
            return role, {}
        if kind == "tlog":
            role = TLogRole(
                data_dir=spec.get("data_dir"), epoch=epoch,
                partitioned=bool(spec.get("partitioned", False)),
            )
            return role, {"durable_version": role.version}
        if kind == "sequencer":
            role = SequencerRole(
                epoch=epoch,
                recovery_version=int(spec.get("recovery_version", 0)),
                n_tags=int(spec.get("n_tags", 1)),
            )
            return role, {"version": role._seq.version}
        if kind == "storage":
            role = StorageRole(
                data_dir=spec.get("data_dir"),
                engine=spec.get("storage_engine", "memory"),
            )
            if spec.get("tlog_address"):
                addrs = [spec["tlog_address"]] + list(
                    spec.get("tlog_addresses") or ()
                )
                if len(addrs) > 1:
                    await role.catch_up_from_tlogs(addrs)
                else:
                    await role.catch_up_from_tlog(spec["tlog_address"])
            rv = int(spec.get("recovery_version", -1))
            if rv >= 0:
                await role.advance_floor(rv)
            return role, {"durable_version": role.version}
        if kind == "ratekeeper":
            role = RatekeeperRole(
                spec.get("peers") or [],
                controller=spec.get("controller") or self.controller,
            )
            await role.start()
            return role, {}
        if kind == "proxy":
            role = ProxyRole(spec)
            await role.start()
            return role, {"recovered": role.recovered}
        raise transport.RemoteError(f"unknown role kind {kind!r}")

    def status(self) -> dict:
        base = {
            "worker_id": self.worker_id,
            "hosted": sorted(self.roles),
            "role_epochs": dict(self.role_epochs),
            "initializations": self.initializations,
        }
        if len(self.roles) == 1:
            # the common one-role-per-worker shape: report AS the
            # hosted role so fdbtop / the ratekeeper / the controller
            # heartbeat read the role's sensors straight off the
            # worker's socket
            (kind, role), = self.roles.items()
            block = role.status()
            block.update(base)
            return block
        return {"role": "worker", "idle": not self.roles, **base,
                "qos": {"hosted": sorted(self.roles),
                        **{k: r.status().get("qos", {})
                           for k, r in self.roles.items()}}}

    def register_tokens(self, server: transport.RpcServer) -> None:
        """The dispatch loop: every role token routes through the
        hosted-role map, so one worker binary serves whatever it is
        recruited as (the fdbserver shape)."""

        def route(kind: str, method: str):
            async def handler(req, _kind=kind, _method=method):
                return await getattr(self.role(_kind), _method)(req)

            return handler

        server.register(TOKEN_INIT_ROLE, self.init_role)
        server.register(TOKEN_RESOLVE, route("resolver", "resolve"))

        async def resolver_version(_req: RoleVersionReq) -> RoleVersionReply:
            return RoleVersionReply(version=self.role("resolver").version)

        server.register(TOKEN_RESOLVER_VERSION, resolver_version)
        server.register(TOKEN_TLOG_PUSH, route("tlog", "push"))
        server.register(TOKEN_TLOG_PEEK, route("tlog", "peek"))
        server.register(TOKEN_TLOG_PEEK_BATCH, route("tlog", "peek_batch"))
        server.register(TOKEN_TLOG_VERSION, route("tlog", "get_version"))
        server.register(TOKEN_TLOG_LOCK, route("tlog", "lock"))
        server.register(TOKEN_TLOG_POP, route("tlog", "pop"))
        server.register(TOKEN_STORAGE_APPLY, route("storage", "apply"))
        server.register(
            TOKEN_STORAGE_APPLY_BATCH, route("storage", "apply_batch")
        )
        server.register(TOKEN_STORAGE_GET, route("storage", "get"))
        server.register(TOKEN_STORAGE_GET_BATCH, route("storage", "get_batch"))
        server.register(TOKEN_STORAGE_SNAPSHOT, route("storage", "snapshot"))
        server.register(TOKEN_STORAGE_VERSION, route("storage", "get_version"))
        server.register(TOKEN_STORAGE_CATCHUP, route("storage", "catch_up"))
        server.register(
            TOKEN_GET_RATE_INFO, route("ratekeeper", "get_rate_info")
        )
        server.register(TOKEN_CLIENT_GRV, route("proxy", "client_grv"))
        server.register(TOKEN_CLIENT_COMMIT, route("proxy", "client_commit"))
        server.register(TOKEN_CLIENT_READ, route("proxy", "client_read"))
        server.register(TOKEN_RATE_UPDATE, route("proxy", "rate_update"))
        server.register(
            TOKEN_GET_COMMIT_VERSION, route("sequencer", "get_commit_version")
        )
        server.register(
            TOKEN_REPORT_COMMITTED, route("sequencer", "report_committed")
        )
        server.register(
            TOKEN_SEQUENCER_VERSION, route("sequencer", "get_version")
        )


class ClusterControllerRole:
    """The cluster state owner: recruits a declarative topology onto
    registered workers, heartbeats them over the StatusRequest
    plumbing, and on any transaction-path death runs the reference
    recovery walk (cluster/generation.py GenerationState — the SAME
    state machine the sim ClusterController drives): bump the
    generation, lock the durable tlog and take the recovery version
    from it, recruit NEW resolvers with EMPTY conflict state, recruit
    the new proxy generation whose first batch is the conservative
    whole-keyspace blind write, and re-open for business. Storage and
    the tlog's durable state survive recovery untouched; a dead
    controller is itself survivable — the monitor restarts it, it
    re-learns workers from their beacons and (epoch persisted in the
    state file) always recovers into a strictly newer generation."""

    #: consecutive heartbeat misses before a role is declared dead — a
    #: kill -9'd worker fails its poll in milliseconds (connection
    #: refused), so detection stays fast; the margin is for a LIVE
    #: worker whose event loop stalls a poll under load
    HEARTBEAT_MISSES = 3
    #: a worker whose beacon is older than this is not live
    WORKER_TTL = 3.0

    def __init__(self, conf: dict, *, state_file: str | None = None,
                 check_interval: float = 0.25):
        import time as _time

        from foundationdb_tpu_torch.cluster.generation import GenerationState

        self.conf = conf
        self.check_interval = check_interval
        self.state_file = state_file
        self.gen = GenerationState(
            epoch=self._load_epoch(), clock=_time.time
        )
        self.workers: dict[str, dict] = {}  # id -> beacon info
        self.assignments: dict[str, dict] = {}  # role name -> placement
        self.recoveries_completed = 0
        self.last_recovery_s: float | None = None
        self.last_recovery_reason: str | None = None
        #: monitor push-on-death notifications received —
        #: the chaos smoke pins that the push path, not the heartbeat
        #: backstop, is what detects a SIGKILL'd worker
        self.death_notifications = 0
        self._needs_recovery = True  # initial recruitment IS a recovery
        self._recovery_reason = "initial_recruitment"
        self._miss_counts: dict[str, int] = {}
        self._conns: dict[str, transport.RpcConnection] = {}
        self._task: asyncio.Task | None = None
        # -- elastic topology: when the Ratekeeper's binding
        # limiter names resolver occupancy/queueing for `elastic_streak`
        # consecutive control intervals (the law's own binding_streak
        # counter, read off the ratekeeper's heartbeat status), the
        # controller plans a topology with ONE MORE resolver and drives
        # the normal generation-bumped recovery walk to recruit it live
        # — the reference's configuration-change-causes-recovery
        # discipline, with Ratekeeper turned from a brake into a
        # scaling signal. Capped at elastic_max_resolvers; OFF by
        # default (conf "elastic": true arms it).
        self.elastic_enabled = bool(conf.get("elastic", False))
        self.elastic_max_resolvers = int(
            conf.get("elastic_max_resolvers", 2)
        )
        #: commit-path scale-out: the SAME trigger machinery
        #: drives proxy recruitment off the proxy-queue limiter — the
        #: _plan + clip machinery generalizes verbatim
        self.elastic_max_proxies = int(conf.get("elastic_max_proxies", 2))
        self.elastic_streak = int(conf.get("elastic_streak", 4))
        #: limiter names that mean "another resolver would help"
        self.ELASTIC_RESOLVER_REASONS = ("resolver_busy", "resolver_queue")
        #: limiter names that mean "another commit proxy would help"
        self.ELASTIC_PROXY_REASONS = ("commit_proxy_queue", "proxy_queue")
        self.elastic_recruits = 0
        self.elastic_last_streak = 0
        self.elastic_last_limiter = None
        # -- elastic scale-down: when the binding
        # limiter has been "workload" (= nothing structural binds; the
        # offered load itself is the ceiling) for elastic_scale_down_
        # streak consecutive control intervals, ONE above-baseline
        # elastic role is retired through the same recovery walk. The
        # baseline is the conf as DECLARED (captured before any
        # persisted elastic override), so scale-down never cuts below
        # what the operator asked for.
        self.elastic_scale_down_streak = int(
            conf.get("elastic_scale_down_streak",
                     max(4, 2 * self.elastic_streak))
        )
        self._elastic_baseline = {
            "resolvers": int(conf.get("resolvers", 1)),
            "proxies": int(conf.get("proxies", 1)),
        }
        self.elastic_scale_downs = 0
        self._workload_streak_observed = 0
        self._workload_gate = self.elastic_scale_down_streak
        # -- persisted elastic topology: a
        # controller kill -9 must not forget fleet size — the planned
        # counts ride the state file next to the epoch and are re-
        # applied over the conf here, before the first _plan()
        for kind_key, count in (self._load_state().get(
                "topology") or {}).items():
            if kind_key in ("resolvers", "proxies", "tlogs"):
                try:
                    self.conf[kind_key] = max(
                        int(self.conf.get(kind_key, 1)), int(count)
                    )
                except (TypeError, ValueError):
                    pass
        self._rk_qos: dict = {}
        #: the streak value a trigger must reach. Normally
        #: elastic_streak; after a recruit it is raised to
        #: (streak-at-recruit + elastic_streak) because the surviving
        #: ratekeeper's law carries its streak ACROSS the recovery — a
        #: still-binding limiter must hold for elastic_streak FRESH
        #: post-recruit intervals (proof the previous recruit didn't
        #: help) before the next one, never chain off the old streak.
        #: A streak reset observed in between restores the normal gate.
        self._elastic_gate = self.elastic_streak
        self._elastic_last_observed = 0
        #: set by worker_death to cut the supervision loop's sleep short
        #: — a pushed death starts the recovery walk on the next loop
        #: iteration, not up to check_interval later
        self._wake = asyncio.Event()

    # -- epoch persistence (the coordinated-state analog) ---------------

    def _load_state(self) -> dict:
        import json as _json

        if self.state_file and os.path.exists(self.state_file):
            try:
                with open(self.state_file) as f:
                    doc = _json.load(f)
                    return doc if isinstance(doc, dict) else {}
            except Exception:
                return {}
        return {}

    def _load_epoch(self) -> int:
        try:
            return int(self._load_state().get("epoch", 0))
        except (TypeError, ValueError):
            return 0

    def _persist_epoch(self, epoch: int) -> None:
        import json as _json

        if not self.state_file:
            return
        tmp = self.state_file + ".tmp"
        with open(tmp, "w") as f:
            # the planned elastic topology persists NEXT TO the epoch
            #: a restarted controller re-applies
            # these counts over its conf, so a kill -9 between an
            # elastic recruit and the next one never forgets fleet size
            _json.dump({
                "epoch": epoch,
                "topology": {
                    "resolvers": int(self.conf.get("resolvers", 1)),
                    "proxies": int(self.conf.get("proxies", 1)),
                    "tlogs": int(self.conf.get("tlogs", 1)),
                },
            }, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.state_file)

    # -- RPC surface -----------------------------------------------------

    async def register_worker(
        self, req: "RegisterWorker"
    ) -> "RegisterWorkerReply":
        import json as _json
        import time as _time

        info = _json.loads(req.payload)
        self.workers[info["worker_id"]] = {
            **info, "last_seen": _time.monotonic(),
        }
        return RegisterWorkerReply(payload=_json.dumps(
            {"ok": True, "epoch": self.gen.epoch}
        ))

    async def worker_death(self, req: "WorkerDeath") -> "WorkerDeathReply":
        """Monitor push-on-death: the monitor reaped this
        worker's process, so every role it hosted is dead NOW — no need
        to wait out HEARTBEAT_MISSES failed polls. Transaction-path
        roles flag the recovery walk immediately (reason "push:<roles>"
        — the chaos smoke pins the prefix); singletons get their miss
        count pre-loaded so the next supervision pass re-recruits on
        its FIRST failed poll. The wake event cuts the loop's sleep."""
        import json as _json

        from foundationdb_tpu_torch.utils.trace import SEV_WARN_ALWAYS, TraceEvent

        info = _json.loads(req.payload)
        wid = info.get("worker_id")
        self.death_notifications += 1
        self.workers.pop(wid, None)
        dead = sorted(
            n for n, a in self.assignments.items()
            if a["worker_id"] == wid
        )
        txn_dead = [
            n for n in dead
            if self.assignments[n]["kind"]
            in ("proxy", "resolver", "tlog", "sequencer")
        ]
        TraceEvent(
            "WorkerDeathPushed", severity=SEV_WARN_ALWAYS
        ).detail("Worker", wid).detail(
            "Roles", ",".join(dead) or "none"
        ).detail("Epoch", self.gen.epoch).log()
        if txn_dead and not self._needs_recovery:
            self._needs_recovery = True
            self._recovery_reason = "push:" + ",".join(txn_dead)
        for n in dead:
            # singletons (and txn roles, harmlessly): one more failed
            # poll — not three — declares them dead in the heartbeat
            self._miss_counts[n] = self.HEARTBEAT_MISSES
        self._wake.set()
        return WorkerDeathReply(payload=_json.dumps(
            {"ok": True, "roles": dead}
        ))

    def topology_doc(self) -> dict:
        return {
            "epoch": self.gen.epoch,
            "state": self.gen.status,
            "recovery_version": self.gen.recovery_version,
            "recoveries_completed": self.recoveries_completed,
            "roles": {
                name: {
                    "kind": a["kind"],
                    "address": a["address"],
                    "worker": a["worker_id"],
                    "epoch": a["epoch"],
                    "pid": self.workers.get(a["worker_id"], {}).get("pid"),
                }
                for name, a in self.assignments.items()
            },
        }

    async def topology(self, _req: "TopologyRequest") -> "TopologyReply":
        import json as _json

        return TopologyReply(payload=_json.dumps(self.topology_doc()))

    def status(self) -> dict:
        import time as _time

        now = _time.monotonic()
        return {
            "role": "cluster_controller",
            "epoch": self.gen.epoch,
            "qos": {
                "epoch": self.gen.epoch,
                "recovery_state": self.gen.status,
                "recovery_version": self.gen.recovery_version,
                "recoveries_completed": self.recoveries_completed,
                "last_recovery_s": self.last_recovery_s,
                "last_recovery_reason": self.last_recovery_reason,
                "death_notifications": self.death_notifications,
                # elastic topology — the fdbtop panel's and
                # the drill's observability surface
                "elastic_enabled": self.elastic_enabled,
                "elastic_recruits": self.elastic_recruits,
                "elastic_streak_needed": self.elastic_streak,
                "elastic_last_streak": self.elastic_last_streak,
                "elastic_last_limiter": self.elastic_last_limiter,
                "elastic_scale_downs": self.elastic_scale_downs,
                "resolvers_planned": int(self.conf.get("resolvers", 1)),
                "proxies_planned": int(self.conf.get("proxies", 1)),
                "tlogs_planned": int(self.conf.get("tlogs", 1)),
                "partitioned": self._partitioned(),
                # the last recovery's phase-one lock width: a one-of-N
                # tlog kill shows survivors < total (per-tag quorum)
                "last_tlog_lock": getattr(self, "last_tlog_lock", None),
                "workers_registered": len(self.workers),
                "workers_live": len(self._live_workers()),
                "roles_recruited": len(self.assignments),
                "recovery_timeline": self.gen.timeline_dicts(),
                "workers": {
                    wid: {
                        "pid": w.get("pid"),
                        "age_s": round(now - w["last_seen"], 3),
                        "roles": w.get("roles", {}),
                    }
                    for wid, w in self.workers.items()
                },
            },
        }

    # -- recruitment planning --------------------------------------------

    def _partitioned(self) -> bool:
        """True when the commit path runs in scale-out mode:
        a sequencer role owns version allotment, pushes carry the
        chained prev_versions, and the tlogs run their per-tag chain
        wait. Any of N>1 proxies, N>1 tlogs, or an explicit conf
        "sequencer": true turns it on; the default single-proxy
        topology keeps the legacy local-allocation path byte-
        identical."""
        return (
            int(self.conf.get("proxies", 1)) > 1
            or int(self.conf.get("tlogs", 1)) > 1
            or bool(self.conf.get("sequencer", False))
        )

    def _role_names(self) -> list[tuple[str, str]]:
        """(role name, kind) pairs of the declarative topology, in
        recruitment order: durable logs first (the recovery version
        source), then storage, the sequencer (scale-out mode), the
        resolvers, ratekeeper, proxies last (proxy0's init commits the
        recovery transaction)."""
        names: list[tuple[str, str]] = []
        for i in range(int(self.conf.get("tlogs", 1))):
            names.append((f"tlog{i}", "tlog"))
        names.append(("storage0", "storage"))
        if self._partitioned():
            names.append(("sequencer0", "sequencer"))
        for i in range(int(self.conf.get("resolvers", 1))):
            names.append((f"resolver{i}", "resolver"))
        if self.conf.get("ratekeeper", True):
            names.append(("ratekeeper0", "ratekeeper"))
        for i in range(int(self.conf.get("proxies", 1))):
            names.append((f"proxy{i}", "proxy"))
        return names

    def _live_workers(self) -> dict[str, dict]:
        import time as _time

        now = _time.monotonic()
        return {
            wid: w for wid, w in self.workers.items()
            if now - w["last_seen"] <= self.WORKER_TTL
        }

    def _plan(self) -> dict[str, dict]:
        """Assign each role a live worker (one role per worker, so a
        kill -9 takes out exactly one role). Placement preference:
        (1) the current assignment when its worker is still live;
        (2) a live worker whose BEACON already reports hosting the
        kind — the re-adoption path: a restarted controller has no
        assignment memory, and recruiting a durable role away from the
        worker that still holds its disk queue open would double-open
        the data dir (found by the controller-kill chaos scenario);
        (3) an idle live worker; (4) any live worker. Raises if the
        live worker set cannot host the topology — the caller retries
        after the monitor has restarted the dead workers."""
        live = self._live_workers()
        taken: set[str] = set()
        plan: dict[str, dict] = {}
        for name, kind in self._role_names():
            cur = self.assignments.get(name)
            wid = None
            if cur and cur["worker_id"] in live \
                    and cur["worker_id"] not in taken:
                wid = cur["worker_id"]
            if wid is None:
                for cand in sorted(live):
                    if cand not in taken \
                            and kind in (live[cand].get("roles") or {}):
                        wid = cand
                        break
            if wid is None:
                for cand in sorted(live):
                    if cand not in taken \
                            and not (live[cand].get("roles") or {}):
                        wid = cand
                        break
            if wid is None:
                for cand in sorted(live):
                    if cand not in taken:
                        wid = cand
                        break
            if wid is None:
                raise RuntimeError(
                    f"not enough live workers: need "
                    f"{len(self._role_names())}, have {len(live)}"
                )
            taken.add(wid)
            plan[name] = {
                "kind": kind,
                "worker_id": wid,
                "address": live[wid]["address"],
                "epoch": self.gen.epoch,
            }
        return plan

    def _hosted_epoch(self, worker_id: str, kind: str) -> int:
        """The epoch a surviving role was initialized at, from its
        worker's beacon — what heartbeats will compare against."""
        w = self._live_workers().get(worker_id) or {}
        return int((w.get("roles") or {}).get(kind, 0))

    def _suspect_worker(self, address: str) -> None:
        """Drop a worker we failed to reach from the registry: its
        beacon ages in every ~0.5s, so a LIVE worker re-appears almost
        immediately, while a kill -9 corpse stops poisoning the
        recruitment plan NOW instead of after the beacon TTL (found by
        the first chaos run: recovery retried into the dead worker for
        a full TTL before re-planning)."""
        for wid, w in list(self.workers.items()):
            if w.get("address") == address:
                self.workers.pop(wid, None)

    async def _worker_call(self, address: str, token: int, msg,
                           *, timeout: float = 30.0):
        return await _cached_call(
            self._conns, address, token, msg,
            timeout=timeout, on_fail=self._suspect_worker,
        )

    async def _init_role(self, placement: dict, spec: dict, *,
                         timeout: float = 120.0) -> dict:
        import json as _json

        reply = await self._worker_call(
            placement["address"], TOKEN_INIT_ROLE,
            InitializeRole(payload=_json.dumps({
                "kind": placement["kind"],
                "epoch": placement["epoch"],
                **spec,
            })),
            timeout=timeout,
        )
        return _json.loads(reply.payload)

    # -- the recovery walk ----------------------------------------------

    async def _recover(self) -> None:
        import time as _time

        from foundationdb_tpu_torch.cluster import generation as gen

        t0 = _time.monotonic()
        reason = self._recovery_reason
        epoch = self.gen.begin_recovery(floor=self._load_epoch())
        self._persist_epoch(epoch)
        # wait until the monitor has restarted enough workers to host
        # the topology (the beacons re-announce them)
        while True:
            try:
                plan = self._plan()
                break
            except RuntimeError:
                await asyncio.sleep(self.check_interval)
        conf = self.conf
        self.gen.transition(gen.LOCKING_OLD_TRANSACTION_SERVERS,
                            Reason=reason)
        # 1. The durable logs: keep each where it lives (or re-host it
        #    from its per-index data dir), then LOCK at the new epoch —
        #    old-generation pushes are fenced from here on, and the
        #    lock replies carry the durable versions recovery derives
        #    from. Scale-out mode runs the TWO-PHASE per-tag
        #    quorum walk: phase one locks the LIVE tlogs immediately
        #    (killing one of N stalls only its tags for the re-host
        #    window — the survivors' lock is the quorum), phase two
        #    re-locks everything with the computed recovery version so
        #    every per-tag version floor advances past the old
        #    generation as a unit.
        n_tlogs = int(conf.get("tlogs", 1))
        partitioned = self._partitioned()
        tlog_places = [plan[f"tlog{i}"] for i in range(n_tlogs)]
        base_tlog_dir = conf.get("tlog_data_dir")

        def _tlog_dir(i: int):
            if not base_tlog_dir:
                return None
            return base_tlog_dir if i == 0 else f"{base_tlog_dir}-{i}"

        part_flag = 1 if partitioned else 0
        survivor_idx: set[int] = set()
        for i, place in enumerate(tlog_places):
            if self._worker_hosts(place["worker_id"], "tlog"):
                # survivor (current assignment OR a restarted
                # controller's beacon re-adoption): keep the epoch it
                # was INITIALIZED at — the worker's role_epochs is what
                # heartbeats compare, and the fencing epoch advances
                # via the lock below (a re-stamped assignment here made
                # every later heartbeat a mismatch and cascaded
                # spurious recoveries)
                place["epoch"] = self._hosted_epoch(
                    place["worker_id"], "tlog"
                )
                survivor_idx.add(i)
        # phase one: fence the survivors NOW (concurrently)
        locks = await asyncio.gather(*(
            self._worker_call(
                tlog_places[i]["address"], TOKEN_TLOG_LOCK,
                TLogLock(epoch=epoch, partitioned=part_flag),
            )
            for i in sorted(survivor_idx)
        ))
        durables = [lk.durable_version for lk in locks]
        # the quorum surface (chaos drill pin): how many tlogs the
        # phase-one lock needed vs the topology width — a one-of-N
        # kill must show survivors < total with recovery proceeding
        self.last_tlog_lock = {
            "survivors": len(survivor_idx), "total": n_tlogs,
        }
        if partitioned:
            # the OLD sequencer's head (best effort): versions it
            # GRANTED but no tlog ever saw must stay below the new
            # floor, or the fresh sequencer could re-issue them
            old_seq = self.assignments.get("sequencer0")
            if old_seq is not None and self._worker_hosts(
                    old_seq["worker_id"], "sequencer"):
                try:
                    r = await self._worker_call(
                        old_seq["address"], TOKEN_SEQUENCER_VERSION,
                        RoleVersionReq(pad=0), timeout=2.0,
                    )
                    durables.append(r.version)
                except Exception:
                    pass
        # re-host dead tlogs from their data dirs (the WAL replay
        # restores each tag's durable state) and lock them on arrival
        for i, place in enumerate(tlog_places):
            if i in survivor_idx:
                continue
            await self._init_role(place, {
                "data_dir": _tlog_dir(i),
                "partitioned": partitioned,
            })
            lk = await self._worker_call(
                place["address"], TOKEN_TLOG_LOCK,
                TLogLock(epoch=epoch, partitioned=part_flag),
            )
            durables.append(lk.durable_version)
        recovery_version = gen.recovery_version_for(*durables)
        self.gen.recovery_version = recovery_version
        self.gen.transition(gen.RECRUITING_TRANSACTION_SERVERS,
                            RecoveryVersion=recovery_version)
        if partitioned:
            # phase two: advance every per-tag version floor to the
            # recovery version — the new generation's first push per
            # tag (prev = recovery version) finds its predecessor, and
            # parked chain waiters drain as stale instead of wedging
            # across the generation bump
            await asyncio.gather(*(
                self._worker_call(
                    p["address"], TOKEN_TLOG_LOCK,
                    TLogLock(epoch=epoch,
                             recovery_version=recovery_version,
                             partitioned=part_flag),
                )
                for p in tlog_places
            ))
        tlog = tlog_places[0]
        tlog_addresses = [p["address"] for p in tlog_places]
        # 2. Storage's durable state survives recovery, but its APPLY
        #    FEED died with the old proxy: it must replay the locked
        #    tlog's tail BEFORE the new generation's first apply can
        #    advance its version past the gap. A dead storage is
        #    re-hosted from its durable dir (the init catch-up does the
        #    same replay).
        storage = plan["storage0"]
        # scale-out mode also hands storage the recovery version: its
        # apply chain's floor must advance past the old generation so
        # the first new-generation chained apply (prev = a version the
        # old generation owned) finds its predecessor
        storage_rv = recovery_version if partitioned else -1
        if self._worker_hosts(storage["worker_id"], "storage"):
            storage["epoch"] = self._hosted_epoch(
                storage["worker_id"], "storage"
            )
            await self._worker_call(
                storage["address"], TOKEN_STORAGE_CATCHUP,
                StorageCatchUp(
                    tlog_address=tlog_addresses[0],
                    tlog_addresses=tlog_addresses[1:],
                    recovery_version=storage_rv,
                ),
            )
        else:
            await self._init_role(storage, {
                "data_dir": conf.get("storage_data_dir"),
                "storage_engine": conf.get("storage_engine", "memory"),
                "tlog_address": tlog_addresses[0],
                "tlog_addresses": tlog_addresses[1:],
                "recovery_version": storage_rv,
            })
        # 3. NEW resolvers, EMPTY conflict state — always rebuilt, even
        #    on surviving workers (resolvers are stateless across
        #    recoveries; correctness comes from the conservative abort).
        #    Each boots with the empty batch at the recovery version so
        #    the new proxy's version chain finds them ready.
        resolver_places = [
            p for n, p in sorted(plan.items()) if p["kind"] == "resolver"
        ]
        for place in resolver_places:
            await self._init_role(place, {
                "backend": conf.get("backend", "cuda"),
                "resolver_kernel": conf.get("resolver_kernel"),
                "compute_cost_per_txn": conf.get("resolver_compute_cost"),
                # the port's own key, sent only when the conf names a
                # device (None: the card)
                **({"device": conf["device"]} if conf.get("device")
                   else {}),
            })
            await self._worker_call(
                place["address"], TOKEN_RESOLVE,
                ResolveTransactionBatchRequest(
                    prev_version=-1,
                    version=recovery_version,
                    last_received_version=-1,
                    epoch=epoch,
                ),
            )
        # 4. Ratekeeper: a singleton, re-recruited only if dead (it
        #    re-resolves peers from our topology each control cycle).
        #    The resolver-count change (elastic recruit or conf edit)
        #    RE-DERIVES the keyspace split here: N resolvers get the
        #    even byte-prefix boundaries (the ResolutionBalancer's
        #    key-sample feed is the remaining headroom), and the new
        #    proxy clips every batch to them — so a recruit genuinely
        #    divides conflict work instead of broadcasting it N times.
        # 3b. The sequencer (scale-out mode): ALWAYS rebuilt fresh at
        #     the recovery version — a surviving old instance carries
        #     the fenced generation's grant state, and the per-tag
        #     chains must restart at the new floor. n_tags = the tlog
        #     count (the tag partition IS the tlog partition).
        seq_place = None
        if partitioned:
            seq_place = plan["sequencer0"]
            await self._init_role(seq_place, {
                "recovery_version": recovery_version,
                "n_tags": n_tlogs,
            })
        topo_addrs = {
            "resolvers": [p["address"] for p in resolver_places],
            "resolver_boundaries": [
                b.hex()
                for b in default_resolver_boundaries(len(resolver_places))
            ],
            "tlog": tlog["address"],
            "storage": storage["address"],
        }
        if partitioned:
            topo_addrs["tlogs"] = tlog_addresses
            topo_addrs["tlog_boundaries"] = [
                b.hex() for b in default_resolver_boundaries(n_tlogs)
            ]
            topo_addrs["sequencer"] = seq_place["address"]
        if "ratekeeper0" in plan:
            rk = plan["ratekeeper0"]
            if self._worker_hosts(rk["worker_id"], "ratekeeper"):
                # survivor keeps its init epoch
                rk["epoch"] = self._hosted_epoch(
                    rk["worker_id"], "ratekeeper"
                )
            else:
                await self._init_role(rk, {
                    "peers": [*tlog_addresses, storage["address"],
                              *topo_addrs["resolvers"]],
                })
            topo_addrs["ratekeeper"] = rk["address"]
        # 5. The new proxy generation: proxy0's start() commits the
        #    conservative recovery transaction as the FIRST batch (the
        #    sequencer grants it the first version of the generation),
        #    then the remaining proxies join the shared version chain
        #    concurrently — they never recover, only commit.
        self.gen.transition(gen.RECOVERY_TRANSACTION)
        proxy_places = [
            (n, p) for n, p in sorted(plan.items())
            if p["kind"] == "proxy"
        ]

        def _proxy_spec(name: str, recover: bool) -> dict:
            return {
                "topology": topo_addrs,
                "start_version": recovery_version,
                "recover": recover,
                "proxy_id": name,
                "batch_interval": conf.get("batch_interval", 0.002),
                "max_batch": conf.get("max_batch", 512),
                "trace": bool(conf.get("trace", False)),
            }

        name0, proxy = proxy_places[0]
        info = await self._init_role(proxy, _proxy_spec(name0, True))
        if not info.get("recovered"):
            raise RuntimeError(f"proxy recruitment did not recover: {info}")
        if len(proxy_places) > 1:
            await asyncio.gather(*(
                self._init_role(p, _proxy_spec(n, False))
                for n, p in proxy_places[1:]
            ))
        self.gen.transition(gen.ACCEPTING_COMMITS)
        self.assignments = plan
        self._miss_counts.clear()
        self.recoveries_completed += 1
        self.last_recovery_s = round(_time.monotonic() - t0, 3)
        self.last_recovery_reason = reason
        self.gen.transition(
            gen.FULLY_RECOVERED,
            RecoverySeconds=self.last_recovery_s,
            Reason=reason,
        )

    def _worker_hosts(self, worker_id: str, kind: str) -> bool:
        """True if the worker's latest beacon reports hosting `kind` —
        a monitor-restarted worker re-registers with an EMPTY role map,
        which is how the controller learns a kill -9 took the role with
        it even though the socket answers again."""
        w = self._live_workers().get(worker_id)
        return bool(w) and kind in (w.get("roles") or {})

    # -- heartbeat + supervision loop ------------------------------------

    async def _heartbeat(self) -> list[str]:
        """One heartbeat pass over the recruited topology (concurrent
        StatusRequest polls; reusing the StatusRequest plumbing means
        heartbeats double as sensor reads). A role is dead after
        HEARTBEAT_MISSES consecutive misses, where a miss is a failed
        poll OR a worker that answers but no longer hosts the role at
        the recruited epoch (restarted corpse)."""
        import json as _json

        async def poll(name: str, a: dict):
            try:
                reply = await self._worker_call(
                    a["address"], TOKEN_STATUS, StatusRequest(pad=0),
                    timeout=2.0,
                )
                block = _json.loads(reply.payload)
            except Exception:
                return name, False
            if a["kind"] == "ratekeeper":
                # heartbeats double as sensor reads: the ratekeeper's
                # qos carries the law's budget + binding_streak — the
                # elasticity trigger's input (stale entries age out via
                # the budget_stale flag the law itself sets)
                self._rk_qos = block.get("qos") or {}
            hosted = block.get("role_epochs") or {}
            return name, hosted.get(a["kind"]) == a["epoch"]

        results = await asyncio.gather(
            *(poll(n, a) for n, a in self.assignments.items())
        )
        dead = []
        for name, ok in results:
            if ok:
                self._miss_counts[name] = 0
                continue
            self._miss_counts[name] = self._miss_counts.get(name, 0) + 1
            if self._miss_counts[name] >= self.HEARTBEAT_MISSES:
                dead.append(name)
        return dead

    async def run(self) -> None:
        from foundationdb_tpu_torch.utils.trace import (
            SEV_WARN_ALWAYS,
            TraceEvent,
        )

        while True:
            try:
                if self._needs_recovery:
                    await self._recover()
                    self._needs_recovery = False
                else:
                    dead = await self._heartbeat()
                    txn_dead = [
                        n for n in dead
                        if self.assignments[n]["kind"]
                        in ("proxy", "resolver", "tlog", "sequencer")
                    ]
                    for name in dead:
                        TraceEvent(
                            "ControllerRoleDead", severity=SEV_WARN_ALWAYS
                        ).detail("Role", name).detail(
                            "Kind", self.assignments[name]["kind"]
                        ).detail("Epoch", self.gen.epoch).log()
                        # the dead role's worker is suspect until its
                        # beacon re-announces it (a kill -9 corpse must
                        # not be re-planned into the next generation)
                        self.workers.pop(
                            self.assignments[name]["worker_id"], None
                        )
                    if txn_dead and not self._needs_recovery:
                        # the transaction system recovers AS A UNIT —
                        # never patched (the reference's key recovery
                        # property). Guarded like worker_death's flag:
                        # a push that landed while this heartbeat pass
                        # was in flight already set the reason, and the
                        # in-flight results must not overwrite its
                        # "push:" attribution (the chaos gate pins it)
                        self._needs_recovery = True
                        self._recovery_reason = ",".join(sorted(txn_dead))
                    else:
                        for name in dead:
                            await self._rerecruit_singleton(name)
                        if not dead:
                            # only a HEALTHY pass may scale: a dying
                            # role's missing occupancy feed can read as
                            # a saturated survivor for a cycle
                            self._elastic_check()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                TraceEvent(
                    "ControllerLoopError", severity=SEV_WARN_ALWAYS
                ).detail("Error", repr(e)).log()
            # interruptible sleep: a pushed worker death (worker_death)
            # wakes the loop immediately instead of up to a full
            # check_interval later
            try:
                await asyncio.wait_for(
                    self._wake.wait(), self.check_interval
                )
            except asyncio.TimeoutError:
                pass
            self._wake.clear()

    def _elastic_check(self) -> None:
        """The elasticity trigger: read the admission law's
        binding_streak off the ratekeeper's last heartbeat status; when
        a resolver-shaped limiter has been binding for elastic_streak
        consecutive control intervals (and the budget is not running on
        stale sensors), plan a topology with ONE MORE resolver and flag
        the generation-bumped recovery walk — the recruit happens
        through the exact code path any configuration change takes, so
        epoch fencing, the conservative abort and the boundary
        re-derivation all apply unchanged."""
        from foundationdb_tpu_torch.cluster.generation import elastic_reason

        if not self.elastic_enabled or self._needs_recovery:
            return
        qos = self._rk_qos or {}
        streak = qos.get("binding_streak") or {}
        limiter = streak.get("name")
        self.elastic_last_limiter = limiter
        # the limiter name routes the SAME trigger machinery to the
        # role kind that would relieve it (the proxy-queue
        # limiter recruits commit proxies exactly like resolvers)
        if limiter in self.ELASTIC_RESOLVER_REASONS:
            kind, conf_key, cap = (
                "resolver", "resolvers", self.elastic_max_resolvers
            )
        elif limiter in self.ELASTIC_PROXY_REASONS:
            kind, conf_key, cap = (
                "proxy", "proxies", self.elastic_max_proxies
            )
        else:
            if limiter == "workload" and not qos.get("budget_stale"):
                # nothing structural binds: the workload itself is the
                # ceiling: feed the scale-down streak while the
                # recruit gate resets below
                self._scale_down_check(streak)
            else:
                self._workload_streak_observed = 0
                self._workload_gate = self.elastic_scale_down_streak
            self.elastic_last_streak = 0
            self._elastic_last_observed = 0
            self._elastic_gate = self.elastic_streak
            return
        self._workload_streak_observed = 0
        self._workload_gate = self.elastic_scale_down_streak
        if qos.get("budget_stale"):
            self.elastic_last_streak = 0
            self._elastic_last_observed = 0
            self._elastic_gate = self.elastic_streak
            return
        self.elastic_last_streak = int(streak.get("intervals", 0))
        if self.elastic_last_streak < self._elastic_last_observed:
            # the law's streak restarted since the last look (the
            # limiter released and re-engaged): the post-recruit gate
            # no longer applies — this is a fresh signal
            self._elastic_gate = self.elastic_streak
        self._elastic_last_observed = self.elastic_last_streak
        if self.elastic_last_streak < self._elastic_gate:
            return
        current = int(self.conf.get(conf_key, 1))
        if current >= cap:
            return
        from foundationdb_tpu_torch.utils.trace import SEV_WARN_ALWAYS, TraceEvent

        self.conf[conf_key] = current + 1
        self.elastic_recruits += 1
        # the snapshot that fired this trigger must not fire the next
        # one: drop it, AND raise the gate past the law's surviving
        # streak — the ratekeeper outlives the recovery walk with its
        # counter intact, so the next recruit needs elastic_streak
        # FRESH intervals on top (or a reset, handled above)
        self._rk_qos = {}
        self._elastic_gate = self.elastic_last_streak + self.elastic_streak
        self._needs_recovery = True
        self._recovery_reason = elastic_reason(kind, current + 1)
        # cut the supervision sleep short, like a pushed worker death:
        # the recovery walk (loop top) starts next iteration, not up
        # to check_interval later
        self._wake.set()
        code_probe(True, "controller.elastic_recruit")
        TraceEvent(
            "ElasticRecruitPlanned", severity=SEV_WARN_ALWAYS
        ).detail("Kind", kind).detail(
            "From", current
        ).detail("To", current + 1).detail(
            "Limiter", limiter
        ).detail("StreakIntervals", self.elastic_last_streak).detail(
            "Epoch", self.gen.epoch
        ).log()

    def _scale_down_check(self, streak: dict) -> None:
        """The OFF direction of elasticity: when
        the admission law reports "workload" as the binding limiter —
        the offered load is the ceiling, nothing structural binds —
        for elastic_scale_down_streak consecutive control intervals,
        retire ONE above-baseline elastic role through the same
        generation-bumped recovery walk the recruit took. The baseline
        is the conf as declared by the operator (captured before the
        persisted elastic override), so scale-down never cuts below
        the configured topology; a gate mirrors the recruit gate so a
        ratekeeper streak surviving the walk cannot chain-retire the
        whole fleet in consecutive passes."""
        from foundationdb_tpu_torch.cluster.generation import elastic_reason
        from foundationdb_tpu_torch.utils.trace import SEV_WARN_ALWAYS, TraceEvent

        intervals = int(streak.get("intervals", 0))
        if intervals < self._workload_streak_observed:
            # the cold streak restarted: fresh signal, normal gate
            self._workload_gate = self.elastic_scale_down_streak
        self._workload_streak_observed = intervals
        if intervals < self._workload_gate:
            return
        for kind, conf_key in (
            ("proxy", "proxies"), ("resolver", "resolvers")
        ):
            current = int(self.conf.get(conf_key, 1))
            if current <= self._elastic_baseline[conf_key]:
                continue
            self.conf[conf_key] = current - 1
            self.elastic_scale_downs += 1
            self._rk_qos = {}
            self._workload_gate = (
                intervals + self.elastic_scale_down_streak
            )
            self._needs_recovery = True
            self._recovery_reason = elastic_reason(kind, current - 1)
            self._wake.set()
            code_probe(True, "controller.elastic_scale_down")
            TraceEvent(
                "ElasticScaleDownPlanned", severity=SEV_WARN_ALWAYS
            ).detail("Kind", kind).detail(
                "From", current
            ).detail("To", current - 1).detail(
                "StreakIntervals", intervals
            ).detail("Epoch", self.gen.epoch).log()
            return

    async def _rerecruit_singleton(self, name: str) -> None:
        """Non-transaction-path roles (storage, ratekeeper) re-recruit
        alone, no generation bump — the reference re-replicates /
        re-recruits singletons without a recovery."""
        kind = self.assignments[name]["kind"]
        live = self._live_workers()
        used = {
            a["worker_id"] for n, a in self.assignments.items() if n != name
        }
        # RE-ADOPT first: a live worker whose beacon still reports
        # hosting the kind is a slow-but-alive instance that missed
        # its polls, not a corpse — recruiting a durable role onto a
        # DIFFERENT worker while it still holds the data dir open
        # would double-open the WAL. The beacon
        # re-announces within ~0.5s, so by the time the miss threshold
        # trips, a live instance is visible here.
        for wid in sorted(live):
            if wid not in used and kind in (live[wid].get("roles") or {}):
                self.assignments[name] = {
                    "kind": kind, "worker_id": wid,
                    "address": live[wid]["address"],
                    "epoch": self._hosted_epoch(wid, kind),
                }
                self._miss_counts[name] = 0
                return
        wid = next(
            (w for w in sorted(live) if w not in used), None
        )
        if wid is None:
            return  # monitor hasn't restarted a worker yet; next pass
        place = {
            "kind": kind, "worker_id": wid,
            "address": live[wid]["address"], "epoch": self.gen.epoch,
        }
        conf = self.conf
        if kind == "storage":
            tlog = self.assignments.get("tlog0")
            await self._init_role(place, {
                "data_dir": conf.get("storage_data_dir"),
                "storage_engine": conf.get("storage_engine", "memory"),
                "tlog_address": tlog["address"] if tlog else None,
            })
        elif kind == "ratekeeper":
            await self._init_role(place, {"peers": []})
        else:
            return
        self.assignments[name] = place
        self._miss_counts[name] = 0


class ClusterRecoveringError(Exception):
    """The cluster is between generations; retry after recovery."""


class CommitUnknownError(Exception):
    """The commit's fate is unknown (connection/generation lost mid-
    flight) — the commit_unknown_result contract: the transaction may
    or may not have committed; only an idempotent replay or a readback
    can tell."""


class ClusterClient:
    """Client-side lifecycle handle: discovers the proxy generation
    through the controller topology and survives recoveries. GRV and
    reads retry transparently across generations (they are stateless);
    commit is ONE attempt — a connection lost mid-commit surfaces
    CommitUnknownError (the reference's commit_unknown_result) because
    the batch may have logged before the crash."""

    #: process-wide client counter: successive clients start their
    #: front-door rotation at successive proxies, so a fleet of
    #: clients spreads across an N-proxy generation
    _rr_seq = 0

    def __init__(self, controller_address: str, *,
                 recovery_timeout: float = 60.0):
        self.controller_address = controller_address
        self.recovery_timeout = recovery_timeout
        self._rr = ClusterClient._rr_seq
        ClusterClient._rr_seq += 1
        self._ctrl_conns: dict = {}  # _cached_call cache (controller)
        self._proxy: transport.RpcConnection | None = None
        #: strong refs to detached close() tasks (the loop only keeps
        #: weak task refs — without this a close could be GC'd unrun)
        self._closing: set = set()
        #: serializes _refresh: N coroutines losing the generation at
        #: once must produce ONE probe connection, not N (the census
        #: gate caught the stampede leaking every non-winner's conn)
        self._refresh_lock = asyncio.Lock()
        self.epoch = 0
        self.proxy_address: str | None = None
        self.refreshes = 0

    async def connect(self) -> None:
        # drop any current proxy first: connect() means "re-resolve the
        # generation", never "reuse whatever is cached"
        self._drop_proxy()
        await self._refresh()

    async def close(self) -> None:
        await _close_all(self._ctrl_conns)
        if self._proxy is not None:
            try:
                await self._proxy.close()
            except Exception:
                pass
        self._proxy = None
        if self._closing:
            await asyncio.gather(
                *list(self._closing), return_exceptions=True
            )

    def _drop_proxy(self) -> None:
        """Forget the current proxy connection, CLOSING it — error
        paths must not leak one transport per generation change."""
        conn = self._proxy
        self._proxy = None
        if conn is not None:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return
            t = loop.create_task(conn.close())
            # detached close: the loop holds only weak task refs —
            # anchor it until done or it can be GC'd before running
            self._closing.add(t)
            t.add_done_callback(self._closing.discard)

    async def topology(self) -> dict:
        import json as _json

        reply = await _cached_call(
            self._ctrl_conns, self.controller_address,
            TOKEN_TOPOLOGY, TopologyRequest(pad=0), timeout=2.0,
        )
        return _json.loads(reply.payload)

    async def _refresh(self) -> dict:
        """Poll the controller until the cluster is fully recovered and
        the proxy front door answers; reconnect to it. Bounded by
        recovery_timeout."""
        import time as _time

        from foundationdb_tpu_torch.cluster import generation as gen

        deadline = _time.monotonic() + self.recovery_timeout
        async with self._refresh_lock:
            if self._proxy is not None:
                # a concurrent refresher won while we waited on the
                # lock: its liveness probe just passed, so reuse its
                # connection — N callers must not stampede N probes
                return {"state": gen.FULLY_RECOVERED,
                        "epoch": self.epoch}
            while True:
                topo = None
                try:
                    topo = await self.topology()
                except Exception:
                    pass
                if topo and topo.get("state") == gen.FULLY_RECOVERED:
                    proxies = [
                        e for _n, e in sorted(
                            (topo.get("roles") or {}).items()
                        )
                        if e["kind"] == "proxy"
                    ]
                    proxy = (
                        proxies[self._rr % len(proxies)]
                        if proxies else None
                    )
                    if proxy is not None:
                        conn = None
                        try:
                            conn = transport.RpcConnection(
                                proxy["address"], tls=_tls_from_env()
                            )
                            await conn.connect(retries=2, delay=0.05)
                            # liveness probe: the socket may be a
                            # corpse the controller hasn't noticed yet
                            await conn.call(
                                TOKEN_CLIENT_GRV,
                                ClientGrvRequest(pad=0),
                                timeout=5.0,
                            )
                            alive = True
                        except transport.RemoteError as e:
                            # a throttled front door IS alive
                            alive = "grv_throttled" in str(e)
                        except Exception:
                            alive = False
                        if alive:
                            self._proxy = conn
                            self.proxy_address = proxy["address"]
                            self.epoch = int(topo["epoch"])
                            self.refreshes += 1
                            return topo
                        # rotate: the next attempt probes a different
                        # proxy of the generation, not the same corpse
                        self._rr += 1
                        if conn is not None:
                            try:
                                await conn.close()
                            except Exception:
                                pass
                if _time.monotonic() > deadline:
                    raise ClusterRecoveringError(
                        f"no recovered generation within "
                        f"{self.recovery_timeout}s (topology: "
                        f"{topo and topo.get('state')})"
                    )
                await asyncio.sleep(0.1)

    async def _retryable_call(self, token: int, msg, *,
                              timeout: float = 30.0):
        """GRV/read path: retry through generation changes until the
        recovery timeout. Typed retryable errors (grv_throttled) pass
        through to the caller's backoff."""
        import time as _time

        deadline = _time.monotonic() + self.recovery_timeout
        while True:
            conn = self._proxy
            try:
                if conn is None:
                    await self._refresh()
                    conn = self._proxy
                return await conn.call(token, msg, timeout=timeout)
            except transport.RemoteError as e:
                s = str(e)
                if "grv_throttled" in s:
                    raise GrvThrottledError()
                if "not_committed" in s:
                    raise NotCommittedError(s)
                # stale epoch / failed pipeline / uninitialized worker:
                # the generation is changing under us
                self._drop_proxy()
            except (transport.TransportError, ConnectionError,
                    asyncio.TimeoutError):
                self._drop_proxy()
            if _time.monotonic() > deadline:
                raise ClusterRecoveringError(
                    f"rpc {token:#x} found no live generation within "
                    f"{self.recovery_timeout}s"
                )
            await asyncio.sleep(0.05)

    async def get_read_version(self) -> int:
        reply = await self._retryable_call(
            TOKEN_CLIENT_GRV, ClientGrvRequest(pad=0)
        )
        return reply.version

    async def read(self, key: bytes, version: int) -> Optional[bytes]:
        reply = await self._retryable_call(
            TOKEN_CLIENT_READ, ClientReadRequest(key=key, version=version)
        )
        return reply.value

    async def commit(self, txn: CommitTransaction, *,
                     timeout: float = 30.0) -> int:
        """ONE commit attempt. NotCommittedError = definitely aborted
        (safe to retry at a fresh snapshot); CommitUnknownError = the
        request was SENT and the generation/connection died mid-flight
        (only a readback can tell); ClusterRecoveringError = the
        request was never sent (no recovered generation reachable) —
        definitely not committed, safe to retry outright."""
        conn = self._proxy
        if conn is None:
            # connection setup failures happen BEFORE anything is
            # sent: surface the retryable recovering error, never
            # "unknown" — callers must not pay readback cost for a
            # commit that provably never left this process
            await self._refresh()
            conn = self._proxy
        try:
            reply = await conn.call(
                TOKEN_CLIENT_COMMIT, ClientCommitRequest(txn=txn),
                timeout=timeout,
            )
            return reply.version
        except transport.RemoteError as e:
            s = str(e)
            if "not_committed" in s:
                raise NotCommittedError(s)
            if "grv_throttled" in s:
                raise GrvThrottledError()
            self._drop_proxy()
            from foundationdb_tpu_torch.cluster.generation import is_stale_epoch

            if is_stale_epoch(s):
                # a generation-fence rejection happens BEFORE anything
                # is appended (resolver and tlog both fence ahead of
                # the log), so this commit provably did not land —
                # retryable, no readback needed
                raise ClusterRecoveringError(s)
            raise CommitUnknownError(s)
        except (transport.TransportError, ConnectionError,
                asyncio.TimeoutError) as e:
            self._drop_proxy()
            raise CommitUnknownError(repr(e))


# ---------------------------------------------------------------------------
# The role process.


async def _serve_role(
    role_name: str,
    address,
    backend: Optional[str],
    data_dir: str | None = None,
    tlog_address: str | None = None,
    storage_engine: str = "memory",
    encrypt: bool = False,
    trace_file: str | None = None,
    peers: list[str] | None = None,
    controller: str | None = None,
    worker_id: str | None = None,
    cluster_conf: str | None = None,
    state_file: str | None = None,
    device=None,
) -> None:
    """Serve one role on `address` until cancelled. The role (a
    resolver's warm-up, a storage's catch-up from `tlog_address`) is
    built before the socket binds: a role that cannot serve never binds.
    A worker builds its roles later, when the controller recruits them;
    `device` is then the device of the resolvers it builds. `encrypt`
    seals a tlog's or a storage's data dir (`default_encryption`: the
    REST KMS at FDB_TPU_KMS, else the sim KMS); without a data dir
    nothing is at rest and it does nothing."""
    if role_name == "controller" and not trace_file:
        # a controller the monitor starts has no trace flag of its own:
        # the environment names its trace file (the recovery timeline's
        # MasterRecoveryState events)
        trace_file = os.environ.get("FDBTPU_CONTROLLER_TRACE")
    if trace_file:
        # a trace sink of this process (the reference's one trace file a
        # fdbserver): micro-events and spans land in a JSONL file that
        # the JAX package's scripts/commit_debug.py merges with the other
        # roles' files into cross-process timelines
        from foundationdb_tpu_torch.utils import spans as _spans
        from foundationdb_tpu_torch.utils import trace as _tr

        sink = _tr.TraceLog(
            min_severity=_tr.SEV_DEBUG, clock=time.time, path=trace_file
        )
        _tr.install(
            sink, _tr.TraceBatch(clock=time.time, logger=sink, enabled=True)
        )
        _spans.set_exporter(_spans.SpanExporter(trace_log=sink))
    # --encrypt is the one switch that reaches this process: spawn_role
    # turns the launcher's ENABLE_ENCRYPTION knob into the flag (a knob
    # read here would always be a fresh interpreter's default)
    encryption = None
    if encrypt and data_dir:
        from foundationdb_tpu_torch.crypto.at_rest import default_encryption

        encryption = default_encryption(
            kms_endpoint=os.environ.get("FDB_TPU_KMS")
        )
    tokens: dict = {}
    if role_name == "resolver":
        role = ResolverRole(backend=backend, device=device)
        tokens[TOKEN_RESOLVE] = role.resolve

        async def rv(req: RoleVersionReq) -> RoleVersionReply:
            return RoleVersionReply(version=role.version)

        tokens[TOKEN_RESOLVER_VERSION] = rv
    elif role_name == "tlog":
        role = TLogRole(data_dir=data_dir, encryption=encryption)
        tokens.update({
            TOKEN_TLOG_PUSH: role.push,
            TOKEN_TLOG_PEEK: role.peek,
            TOKEN_TLOG_PEEK_BATCH: role.peek_batch,
            TOKEN_TLOG_VERSION: role.get_version,
            TOKEN_TLOG_LOCK: role.lock,
            TOKEN_TLOG_POP: role.pop,
        })
    elif role_name == "storage":
        role = StorageRole(
            data_dir=data_dir, engine=storage_engine, encryption=encryption
        )
        if tlog_address:
            await role.catch_up_from_tlog(tlog_address)
        tokens.update({
            TOKEN_STORAGE_APPLY: role.apply,
            TOKEN_STORAGE_APPLY_BATCH: role.apply_batch,
            TOKEN_STORAGE_GET: role.get,
            TOKEN_STORAGE_GET_BATCH: role.get_batch,
            TOKEN_STORAGE_SNAPSHOT: role.snapshot,
            TOKEN_STORAGE_VERSION: role.get_version,
            TOKEN_STORAGE_CATCHUP: role.catch_up,
        })
    elif role_name == "sequencer":
        role = SequencerRole()
        tokens.update({
            TOKEN_GET_COMMIT_VERSION: role.get_commit_version,
            TOKEN_REPORT_COMMITTED: role.report_committed,
            TOKEN_SEQUENCER_VERSION: role.get_version,
        })
    elif role_name == "ratekeeper":
        role = RatekeeperRole(peers or [], controller=controller)
        tokens[TOKEN_GET_RATE_INFO] = role.get_rate_info
    elif role_name == "worker":
        role = WorkerRole(
            worker_id or os.path.basename(str(address)),
            str(address),
            controller=controller,
            device=device,
        )
    elif role_name == "controller":
        conf: dict = {}
        if cluster_conf:
            with open(cluster_conf) as f:
                conf = json.load(f)
        role = ClusterControllerRole(conf, state_file=state_file)
        tokens.update({
            TOKEN_REGISTER_WORKER: role.register_worker,
            TOKEN_TOPOLOGY: role.topology,
            TOKEN_WORKER_DEATH: role.worker_death,
        })
    else:
        raise ValueError(f"unknown role {role_name!r}")
    server = transport.RpcServer(address, tls=_tls_from_env())

    async def ping(msg: Ping) -> Pong:
        return Pong(payload=msg.payload)

    async def status(_req: StatusRequest) -> StatusReply:
        from foundationdb_tpu_torch.runtime import census as _census

        blk = role.status()
        # this process's own live fds, connections, servers and asyncio
        # tasks
        blk["census"] = {
            **_census.snapshot(),
            "tasks": len(asyncio.all_tasks()),
        }
        resolver = (role if role_name == "resolver" else
                    role.roles.get("resolver") if role_name == "worker"
                    else None)
        if resolver is not None:
            # the port's own: the conflict set, and this process's kernel
            # launches (kernels.COUNTS) now and when the role was ready
            blk.update(resolver.process_status())
        return StatusReply(payload=json.dumps(blk))

    server.register(TOKEN_PING, ping)
    server.register(TOKEN_STATUS, status)
    for token, handler in tokens.items():
        server.register(token, handler)
    if role_name == "worker":
        role.register_tokens(server)
    await server.start()
    # the roles with a loop of their own start once the socket serves
    if role_name in ("ratekeeper", "worker"):
        await role.start()
    elif role_name == "controller":
        role._task = asyncio.ensure_future(role.run())
    try:
        await asyncio.Event().wait()  # until killed
    finally:
        if role_name in ("ratekeeper", "worker"):
            await role.stop()
        elif role_name == "controller":
            role._task.cancel()
            await asyncio.gather(role._task, return_exceptions=True)
            await _close_all(role._conns)
        await server.close()


# ---------------------------------------------------------------------------
# Launcher (parent side).


class RoleExitedError(transport.TransportError):
    """The role's process exited before it served."""


@dataclasses.dataclass
class RoleProcess:
    name: str
    address: str
    proc: subprocess.Popen

    def exited(self) -> Optional[int]:
        """The child's exit code, or None while it runs."""
        return self.proc.poll()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def spawn_role(
    name: str,
    socket_dir: str,
    *,
    backend: Optional[str] = "cuda",
    index: int = 0,
    data_dir: str | None = None,
    tlog_address: str | None = None,
    storage_engine: str = "memory",
    encrypt: bool = False,
    trace_file: str | None = None,
    peers: list[str] | None = None,
    controller: str | None = None,
    worker_id: str | None = None,
    cluster_conf: str | None = None,
    state_file: str | None = None,
    device=None,
    env: Optional[dict] = None,
) -> RoleProcess:
    """Start one role as a child OS process serving a Unix socket in
    `socket_dir`. The child sees the parent's environment (`env` adds to
    it) with PYTHONPATH set to the repository root, and nothing else
    changed: a "cuda" resolver uses the card the parent would, and exits
    non-zero before it binds when there is none. `backend` only matters
    to a resolver, `device` to a resolver and a worker (the device of the
    resolvers it builds); `peers` to a ratekeeper, `controller` to a
    worker and a ratekeeper, `worker_id` to a worker, `cluster_conf` and
    `state_file` to a controller, `encrypt` (or the launcher's
    ENABLE_ENCRYPTION knob) to a tlog and a storage with a data dir."""
    address = os.path.join(socket_dir, f"{name}{index}.sock")
    child_env = dict(os.environ)
    child_env.update(env or {})
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    child_env["PYTHONPATH"] = repo_root
    cmd = [
        sys.executable,
        "-m",
        "foundationdb_tpu_torch.cluster.multiprocess",
        "--role",
        name,
        "--address",
        address,
        "--backend",
        "knob" if backend is None else backend,
    ]
    if device is not None:
        cmd += ["--device", str(device)]
    for flag, value in (("--data-dir", data_dir),
                        ("--trace-file", trace_file),
                        ("--peers", ",".join(peers) if peers else None),
                        ("--controller", controller),
                        ("--worker-id", worker_id),
                        ("--cluster-conf", cluster_conf),
                        ("--state-file", state_file),
                        ("--tlog-address", tlog_address)):
        if value:
            cmd += [flag, value]
    if storage_engine != "memory":
        cmd += ["--storage-engine", storage_engine]
    # the child is a fresh interpreter with the default knobs, so the
    # launcher's ENABLE_ENCRYPTION travels as the flag
    from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS

    if encrypt or SERVER_KNOBS.ENABLE_ENCRYPTION:
        cmd += ["--encrypt"]
    proc = subprocess.Popen(cmd, env=child_env)
    return RoleProcess(name=name, address=address, proc=proc)


def _tls_from_env():
    """Cluster TLS from the environment, as the JAX package's roles take
    it: FDB_TPU_TLS_DIR names a directory with ca.crt and
    node.crt / node.key; every role and client then speaks mutual TLS
    under that CA."""
    tls_dir = os.environ.get("FDB_TPU_TLS_DIR")
    if not tls_dir:
        return None
    from foundationdb_tpu_torch.crypto.tls import TLSConfig

    return TLSConfig(
        ca_file=os.path.join(tls_dir, "ca.crt"),
        cert_file=os.path.join(tls_dir, "node.crt"),
        key_file=os.path.join(tls_dir, "node.key"),
    )


async def connect(address, *, proc: Optional[RoleProcess] = None,
                  retries: int = 1200,
                  delay: float = 0.1) -> transport.RpcConnection:
    """Connect to the role serving `address`, retrying while it starts: a
    resolver warms up (the torch import, the CUDA context, the kernel
    loads, two constructors and a first resolve) before it binds. With
    `proc`, the child is polled between tries and its exit fails the
    call at once (RoleExitedError), not after the retries."""
    conn = transport.RpcConnection(address, tls=_tls_from_env())
    last = None
    for _ in range(retries):
        code = proc.exited() if proc is not None else None
        if code is not None:
            raise RoleExitedError(
                f"{proc.name} at {proc.address} exited with code {code} "
                "before it served"
            )
        try:
            await conn.connect(retries=1, delay=delay)
            return conn
        except transport.TransportError as e:
            if not str(e).startswith("cannot connect"):
                raise
            last = e
    raise transport.TransportError(f"cannot connect to {address}: {last}")


# ---------------------------------------------------------------------------
# The commit pipeline (the parent process: the proxies and the client API).


class NotCommittedError(Exception):
    pass


class AsyncNotified:
    """Monotone value with when_at_least — the runtime/flow `Notified`
    (NotifiedVersion) for asyncio: the wire pipeline's batch-ordering
    chains wait on it exactly like the simulated proxy's
    latest_batch_resolving / latest_batch_logging chains."""

    def __init__(self, value: int = 0):
        self._value = value
        self._waiters: list[tuple[int, asyncio.Future]] = []

    def get(self) -> int:
        return self._value

    def set(self, value: int) -> None:
        if value < self._value:
            raise ValueError(
                f"Notified must not decrease: {value} < {self._value}"
            )
        self._value = value
        still = []
        for threshold, fut in self._waiters:
            if fut.done():
                continue
            if threshold <= value:
                fut.set_result(value)
            else:
                still.append((threshold, fut))
        self._waiters = still

    async def when_at_least(self, threshold: int) -> int:
        if self._value >= threshold:
            return self._value
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append((threshold, fut))
        return await fut


class PipelineFailedError(Exception):
    """A predecessor batch died mid-chain; this proxy generation is
    broken (the in-process CommitProxy's `failed` discipline)."""


# A/B toggle for the resolve-hop payload (measurement): 1 = conflict
# metadata only (default), 0 = full transactions incl. mutations.
_RESOLVE_STRIP = os.environ.get("RESOLVE_STRIP", "1") != "0"


def _resolve_columnar_default() -> bool:
    """A/B toggle for the resolve-hop frame: 1 (default) = the
    columnar ResolveBatchColumnar frame — conflict metadata packed once
    at the proxy as flat little-endian arrays + one key blob, decoded
    resolver-side with np.frombuffer straight into kernel tensors; 0 =
    the per-transaction object frame (the escape hatch, and the object
    path for A/B runs). Columnar applies only to the STRIPPED
    conflict-metadata hop: with RESOLVE_STRIP=0 (full transactions
    incl. mutations on the wire) the object frame always runs. Read at
    pipeline construction so one process can A/B both paths."""
    return os.environ.get("RESOLVE_COLUMNAR", "1") != "0"


class ProxyPipeline:
    """Sequencer + commit proxy over wire-connected roles.

    The 5-phase commitBatch pipeline
    (fdbserver/CommitProxyServer.actor.cpp:2516-2555) against remote
    resolver/tlog/storage processes, STAGE-OVERLAPPED: successive batches
    run concurrently through resolve -> tlog-push -> reply, ordered only
    at the Notified-chain handoffs — batch N+1's resolution is on the
    wire while batch N is logging (the resolver serializes versions by
    the prev_version chain server-side), its tlog push waits only for
    batch N's push, and client replies fire as soon as the batch's own
    push is durable. Storage applies ride a third ordered chain BEHIND
    the replies (reads wait for the storage version they need, so
    lagging applies cost read latency, never correctness) — the
    reference's storage lag. Batching is adaptive (cluster/batching.py):
    the accumulation interval shrinks while batches fill early and the
    count/bytes targets follow measured resolve+log seconds. GRV serves
    the last tlog-durable version (commit-before-GRV visibility).
    """

    def __init__(
        self,
        resolvers: list[transport.RpcConnection],
        tlog: transport.RpcConnection,
        storage: transport.RpcConnection,
        *,
        version_step: int = 1000,
        batch_interval: float = 0.002,
        max_batch: int = 512,
        start_version: int = 0,
        trace: bool = False,
        pipeline_depth: int = None,
        ratekeeper: transport.RpcConnection = None,
        rate_fetch_interval: float = 0.25,
        max_grv_queue: int = None,
        resolve_columnar: bool = None,
        epoch: int = 0,
        resolver_boundaries: list = None,
        sequencer: transport.RpcConnection = None,
        proxy_id: str = "proxy0",
        tlogs: list = None,
        tlog_boundaries: list = None,
    ):
        from foundationdb_tpu_torch.cluster.batching import AdaptiveBatchSizer
        from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS as _K

        self.resolvers = resolvers
        # -- commit-path scale-out: with a sequencer
        # connection, version allotment moves behind GetCommitVersion —
        # N proxy processes share the global chain, each handing the
        # grant's (prev_version, version) to the resolvers. With
        # `tlogs` + boundaries, pushes are TAG-PARTITIONED: each batch
        # pushes only to the tlogs owning its mutations' key ranges,
        # chained per tag by the grant's tag_prevs. Without a
        # sequencer, the legacy single-proxy local allocation runs
        # byte-identically.
        self.sequencer = sequencer
        self.proxy_id = proxy_id
        self._tlogs = list(tlogs) if tlogs else [tlog]
        self.tlog = self._tlogs[0]
        if tlog_boundaries and len(self._tlogs) > 1:
            if len(tlog_boundaries) != len(self._tlogs) - 1:
                raise ValueError(
                    f"{len(self._tlogs)} tlog(s) need "
                    f"{len(self._tlogs) - 1} boundary key(s), got "
                    f"{len(tlog_boundaries)}"
                )
            self._tlog_ranges = resolver_key_ranges(list(tlog_boundaries))
        else:
            self._tlog_ranges = None
        self._seq_request_num = 0
        self._seq_processed = 0
        self.version_grants = 0
        # GRV live-committed coalescer (sequencer mode): waiters that
        # arrive while a fetch is in flight ride the NEXT round, so a
        # GRV issued after a commit ack can never observe an older
        # snapshot of the sequencer's live committed version
        self._grv_waiters: list = []
        self._grv_fetching = False
        self.storage = storage
        # -- multi-resolver keyspace split: with N > 1
        # resolvers and boundaries (N-1 interior split keys, re-derived
        # by the controller on every resolver-count change), each
        # resolver receives the batch with its conflict ranges CLIPPED
        # to its partition (clip_transactions — the reference's
        # ResolutionRequestBuilder), so per-resolver conflict work
        # scales down with recruits. No boundaries (or a single
        # resolver) keeps the full broadcast.
        if resolver_boundaries and len(resolvers) > 1:
            if len(resolver_boundaries) != len(resolvers) - 1:
                raise ValueError(
                    f"{len(resolvers)} resolver(s) need "
                    f"{len(resolvers) - 1} boundary key(s), got "
                    f"{len(resolver_boundaries)}"
                )
            self._resolver_ranges = resolver_key_ranges(
                list(resolver_boundaries)
            )
        else:
            self._resolver_ranges = None
        #: this proxy generation's recovery epoch, stamped on every
        #: resolve frame and tlog push — resolvers/tlogs of another
        #: generation reject them retryably (stale_epoch), so a fenced
        #: old proxy can never slip a commit in after recovery
        self.epoch = epoch
        # columnar resolve frame: pack the batch's conflict
        # metadata ONCE into flat arrays + one key blob at batch-build
        # time (the layout the resolver's kernel packer consumes), so
        # the resolve hop is wire bytes -> device tensors with two
        # copies total. None = the RESOLVE_COLUMNAR env default; the
        # object frame still runs with RESOLVE_STRIP=0 (mutations must
        # travel) regardless.
        self._columnar = (
            _resolve_columnar_default()
            if resolve_columnar is None
            else bool(resolve_columnar)
        ) and _RESOLVE_STRIP
        # -- admission control (the wire GRV front door): the budget is
        # fetched from the ratekeeper role over GetRateInfo and enforced
        # as an arrival-spacing token bucket with a burst cap; requests
        # whose backlog would exceed the bounded queue are SHED with the
        # retryable grv_throttled error (same contract as the sim
        # GrvProxy). No ratekeeper connection == unthrottled.
        self._rk_conn = ratekeeper
        self._rate_interval = rate_fetch_interval
        self.max_grv_queue = (
            max_grv_queue if max_grv_queue is not None
            else _K.GRV_PROXY_MAX_QUEUE
        )
        from foundationdb_tpu_torch.cluster.ratekeeper import FAILSAFE_TAU

        self._rate_limit = float("inf")
        self._rate_floor = 1e4
        self._rate_tau = FAILSAFE_TAU
        self._rate_info: dict = {}
        self._rate_stale = False
        self._rate_failures = 0
        self._rate_task: asyncio.Task | None = None
        self._grv_next_slot = 0.0
        self.grv_sheds = 0
        self.grv_throttle_waits = 0
        #: push-based rate updates applied: the ratekeeper
        #: pushes GetRateInfo deltas past a hysteresis threshold; the
        #: poll loop stays as the backstop
        self.rate_pushes_applied = 0
        self.version_step = version_step
        self.batch_interval = batch_interval
        self.max_batch = max_batch
        self.batch_sizer = AdaptiveBatchSizer(
            interval=batch_interval,
            min_interval=min(
                batch_interval, _K.COMMIT_TRANSACTION_BATCH_INTERVAL_MIN
            ),
            # unlike the in-process proxy (whose window only shrinks, to
            # keep existing sim schedules), the wire pipeline's window
            # may GROW to the MAX knob: under a slow resolver (kernel
            # dispatch cost) the latency-fraction rule earns bigger
            # batches that amortize the per-dispatch cost
            max_interval=max(
                batch_interval, _K.COMMIT_TRANSACTION_BATCH_INTERVAL_MAX
            ),
            target_count=max_batch,
            max_count=max(
                max_batch, _K.COMMIT_TRANSACTION_BATCH_COUNT_MAX
            ),
            max_bytes=_K.COMMIT_TRANSACTION_BATCH_BYTES_MAX,
            latency_budget=_K.COMMIT_BATCH_STAGE_LATENCY_BUDGET,
            alpha=_K.COMMIT_TRANSACTION_BATCH_INTERVAL_SMOOTHER_ALPHA,
            latency_fraction=_K.COMMIT_TRANSACTION_BATCH_INTERVAL_LATENCY_FRACTION,
        )
        #: commit-path tracing: batches carry span contexts + debug ids
        #: over the wire to the resolver processes, and this process
        #: emits the CommitProxy.* micro-events (enable the global
        #: trace sinks — e.g. a TraceLog file — to persist them)
        self.trace = trace
        self._batch_seq = 0
        # a recovering proxy passes start_version = max(tlog version,
        # resolver version) so allocation resumes strictly above anything
        # any role has seen (the reference's recovery version semantics)
        self.committed_version = start_version
        self.prev_version = -1 if start_version == 0 else start_version
        self._last_allocated = start_version
        # the resolve/push version chain: batch N+1's prev_version is
        # batch N's version, assigned synchronously at spawn
        self._chain_prev = self.prev_version
        self._queue: list[tuple[CommitTransaction, asyncio.Future]] = []
        self._batcher_task: asyncio.Task | None = None
        # batch-ordering chain (batch numbers, 1-based)
        self._latest_batch_logging = AsyncNotified(0)
        self._inflight: set[asyncio.Task] = set()
        self._depth = asyncio.Semaphore(
            pipeline_depth
            if pipeline_depth is not None
            else _K.MAX_PIPELINED_COMMIT_BATCHES
        )
        self.failed: Optional[BaseException] = None
        self._loop: asyncio.AbstractEventLoop | None = None
        # ordered apply queue: (version, mutations, prev_version)
        # appended in commit order at reply time, drained by ONE
        # applier task in batched StorageApplyBatch RPCs — replies never wait on storage, and
        # the storage version trails the committed version by at most
        # one drain roundtrip (the reference's bounded storage lag)
        self._apply_queue: list[tuple[int, list, int]] = []
        self._apply_event: asyncio.Event | None = None
        self._applier_task: asyncio.Task | None = None
        self.applied_version = start_version
        self._last_enqueued_apply = start_version
        # read coalescer: every read issued in the same event-loop turn
        # rides one StorageGetBatch RPC (per-key versions, exact MVCC)
        self._read_pending: list = []
        self._read_flush_scheduled = False
        # -- saturation sensors (the parent process plays BOTH proxies
        # in wire mode: commit batching here, GRV at get_read_version)
        from foundationdb_tpu_torch.utils.metrics import TimerSmoother

        self._batches_inflight = 0
        self.smoothed_queue_depth = TimerSmoother(1.0)
        self.smoothed_grv_rate = TimerSmoother(1.0)
        self.grvs_served = 0
        # busiest-write-tag tracker: the commit-side
        # TransactionTagCounter twin — wall clock, like every other
        # wire-role sensor
        from foundationdb_tpu_torch.cluster.sampling import TagCounter

        self.write_tags = TagCounter()

    def start(self) -> None:
        self._loop = asyncio.get_event_loop()
        self._apply_event = asyncio.Event()
        self._batcher_task = asyncio.ensure_future(self._batcher())
        self._applier_task = asyncio.ensure_future(self._applier())
        if self._rk_conn is not None:
            self._rate_task = asyncio.ensure_future(self._rate_fetcher())

    async def stop(self) -> None:
        if self._rate_task:
            self._rate_task.cancel()
            try:
                await self._rate_task
            except asyncio.CancelledError:
                pass
            self._rate_task = None
        if self._batcher_task:
            self._batcher_task.cancel()
            try:
                await self._batcher_task
            except asyncio.CancelledError:
                pass
            self._batcher_task = None
        # drain in-flight batches: their replies must not die with the
        # pipeline (and tests must not leak pending tasks)
        if self._inflight:
            await asyncio.gather(
                *list(self._inflight), return_exceptions=True
            )
        # flush the apply queue so storage converges to committed state
        # before the roles go down (consistency checks snapshot here);
        # applied_version advances only after the batch RPC is acked, so
        # this cannot cancel a drain mid-roundtrip
        if self._applier_task:
            while (
                self.applied_version < self._last_enqueued_apply
                and self.failed is None
                and not self._applier_task.done()
            ):
                self._apply_event.set()
                await asyncio.sleep(0.001)
            self._applier_task.cancel()
            try:
                await self._applier_task
            except asyncio.CancelledError:
                pass
            self._applier_task = None

    async def _rate_fetcher(self) -> None:
        """Budget-fetch loop (GetRateInfoRequest cadence). A ratekeeper
        that stops answering FAILS SAFE: after two consecutive misses
        the effective budget decays exponentially toward the
        conservative floor — a dead ratekeeper must clamp the front
        door, never freeze it at full speed."""
        import json as _json
        import math as _math
        import time as _time

        last = _time.monotonic()
        while True:
            now = _time.monotonic()
            dt = max(0.0, now - last)
            last = now
            try:
                rep = await self._rk_conn.call(
                    TOKEN_GET_RATE_INFO, GetRateInfoRequest(pad=0),
                    timeout=2.0,
                )
                self.apply_rate_info(_json.loads(rep.payload))
            except asyncio.CancelledError:
                raise
            except Exception:
                self._rate_failures += 1
                if self._rate_failures >= 2:
                    self._rate_stale = True
                    if self._rate_limit == float("inf"):
                        self._rate_limit = self._rate_floor
                    else:
                        self._rate_limit = max(
                            self._rate_floor,
                            self._rate_limit
                            * _math.exp(-dt / self._rate_tau),
                        )
            await asyncio.sleep(self._rate_interval)

    def apply_rate_info(self, info: dict) -> None:
        """Apply one GetRateInfo payload — shared by the poll loop and
        the ratekeeper's push path. A push counts as a fresh
        feed: it clears the staleness/decay state exactly like a
        successful poll, so during overload onset the enforced budget
        tracks the control loop at one control-cycle latency instead of
        the fetch cadence."""
        self._rate_limit = float(info["transactions_per_second_limit"])
        self._rate_floor = float(info.get("failsafe_tps", self._rate_floor))
        self._rate_tau = float(info.get("failsafe_tau", self._rate_tau))
        self._rate_info = info
        self._rate_failures = 0
        self._rate_stale = False

    def _grv_backlog(self) -> int:
        """Requests currently parked in the admission throttle (the
        token schedule's lead over now, in request slots) — the wire
        GRV front door's queue-depth sensor."""
        import time as _time

        rate = self._rate_limit
        if self._rk_conn is None or rate == float("inf"):
            return 0
        return max(
            0, int((self._grv_next_slot - _time.monotonic()) * rate)
        )

    async def _grv_admit(self) -> None:
        """Arrival-spacing token bucket: each admit takes the next
        1/rate-spaced slot; the slot may lag `now` by up to the burst
        allowance (0.1s of budget), and a backlog past the bounded
        queue sheds with the retryable grv_throttled error."""
        import time as _time

        from foundationdb_tpu_torch.cluster.grv_proxy import GrvThrottledError

        rate = self._rate_limit
        if rate == float("inf"):
            return
        rate = max(rate, 1e-3)
        now = _time.monotonic()
        burst = max(1.0, rate * 0.1)
        slot = max(self._grv_next_slot, now - burst / rate) + 1.0 / rate
        backlog = slot - now
        if backlog * rate > self.max_grv_queue:
            # the slot is NOT consumed: a shed request must not push
            # the schedule further out for the next arrival
            self.grv_sheds += 1
            raise GrvThrottledError()
        self._grv_next_slot = slot
        if backlog > 0:
            self.grv_throttle_waits += 1
            await asyncio.sleep(backlog)

    async def get_read_version(self) -> int:
        if self._rk_conn is not None:
            # admission control gates HERE and only here: an admitted
            # transaction's resolve/commit path is byte-identical to
            # the unthrottled one (decision parity)
            await self._grv_admit()
        self.grvs_served += 1
        self.smoothed_grv_rate.add_delta(1.0)
        if self.sequencer is not None:
            # N proxies: this proxy's local committed head misses the
            # other proxies' commits — serve the sequencer's live
            # committed version (coalesced: one in-flight fetch serves
            # every waiter of its round)
            return max(
                await self._live_committed(), self.committed_version
            )
        return self.committed_version

    async def _live_committed(self) -> int:
        loop = self._loop or asyncio.get_event_loop()
        fut = loop.create_future()
        self._grv_waiters.append(fut)
        if not self._grv_fetching:
            self._grv_fetching = True
            t = asyncio.ensure_future(self._live_committed_rounds())
            self._inflight.add(t)
            t.add_done_callback(self._inflight.discard)
        return await fut

    async def _live_committed_rounds(self) -> None:
        """Serve queued GRV waiters in rounds: a waiter only rides a
        fetch that STARTS after it queued, so commit-then-GRV ordering
        holds across proxies (the commit was reported to the sequencer
        before its client ack)."""
        try:
            while self._grv_waiters:
                waiters, self._grv_waiters = self._grv_waiters, []
                try:
                    rep = await self.sequencer.call(
                        TOKEN_REPORT_COMMITTED,
                        ReportRawCommittedVersionRequest(
                            version=-1, epoch=self.epoch
                        ),
                        timeout=5.0,
                    )
                    for f in waiters:
                        if not f.done():
                            f.set_result(rep.live_version)
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    for f in waiters:
                        if not f.done():
                            f.set_exception(transport.RemoteError(
                                f"grv live-committed fetch: {e!r}"
                            ))
        finally:
            self._grv_fetching = False
            for f in self._grv_waiters:
                if not f.done():
                    f.set_exception(transport.RemoteError(
                        "grv live-committed fetch cancelled"
                    ))
            self._grv_waiters = []

    # -- saturation sensors ------------------------------------------------

    def saturation(self) -> dict:
        """The wire commit proxy's qos block: in-flight batch depth
        (the stage-overlap window), queued requests (smoothed +
        instantaneous), the apply backlog behind the replies, and the
        AdaptiveBatchSizer's live interval/count/bytes targets."""
        return {
            "inflight_batches": self._batches_inflight,
            "queued_requests": len(self._queue),
            "smoothed_queued_requests": (
                self.smoothed_queue_depth.smooth_total()
            ),
            "batches_started": self._batch_seq,
            "batches_logged": self._latest_batch_logging.get(),
            "apply_backlog_versions": max(
                0, self._last_enqueued_apply - self.applied_version
            ),
            "apply_queue_batches": len(self._apply_queue),
            "read_backlog_keys": len(self._read_pending),
            "batch_sizer": self.batch_sizer.as_dict(),
            "failed": self.failed is not None,
            "version_grants": self.version_grants,
            "tag_partitioned": self._tlog_ranges is not None,
            "busiest_write_tag": self.write_tags.busiest(),
        }

    def grv_saturation(self) -> dict:
        """The wire GRV front door's qos block (this process serves
        read versions directly off the committed head)."""
        return {
            # the admission throttle's backlog: callers parked inside
            # _grv_admit waiting for their token slot. Without a
            # ratekeeper the front door answers synchronously (the
            # read-coalescer backlog is the proxy block's
            # read_backlog_keys) — then this is genuinely 0.
            "queued_requests": self._grv_backlog(),
            "grvs_served": self.grvs_served,
            "grv_per_s": self.smoothed_grv_rate.smooth_rate(),
            "committed_version": self.committed_version,
            "applied_version": self.applied_version,
            # admission-control surface (None == unthrottled: no
            # ratekeeper connection configured)
            "transactions_per_second_limit": (
                self._rate_limit
                if self._rate_limit != float("inf") else None
            ),
            "budget_limited_by": self._rate_info.get("budget_limited_by"),
            "budget_stale": self._rate_stale,
            "sheds": self.grv_sheds,
            "throttle_waits": self.grv_throttle_waits,
            "rate_pushes_applied": self.rate_pushes_applied,
            "max_queue": self.max_grv_queue,
        }

    async def commit(self, txn: CommitTransaction) -> int:
        """Returns the commit version or raises NotCommittedError."""
        loop = self._loop or asyncio.get_event_loop()
        fut = loop.create_future()
        if self.failed is not None:
            fut.set_exception(
                transport.RemoteError(
                    f"commit pipeline failed: {self.failed!r}"
                )
            )
            return await fut
        # busiest-write-tag sensor: note at the front door (per offered
        # mutation, like the reference proxy's TransactionTagCounter —
        # throttling decisions must see load BEFORE conflict verdicts)
        from foundationdb_tpu_torch.cluster.sampling import tag_of_key

        for m in txn.mutations:
            key = getattr(m, "param1", None)
            if key is None and isinstance(m, (tuple, list)) and len(m) >= 3:
                key = m[1]
            if not isinstance(key, bytes):
                continue
            val = getattr(m, "param2", None)
            if val is None and isinstance(m, (tuple, list)) and len(m) >= 3:
                val = m[2]
            nb = 8 + len(key) + (len(val) if isinstance(val, bytes) else 0)
            self.write_tags.note(tag_of_key(key), nb)
        self._queue.append((txn, fut))
        return await fut

    async def read(self, key: bytes, version: int) -> Optional[bytes]:
        """Versioned point read, coalesced: reads enqueued in the same
        event-loop turn go out as ONE StorageGetBatch roundtrip (each
        key still served at its own version server-side)."""
        loop = self._loop or asyncio.get_event_loop()
        fut = loop.create_future()
        self._read_pending.append((key, version, fut))
        if not self._read_flush_scheduled:
            self._read_flush_scheduled = True
            loop.call_soon(self._flush_reads)
        return await fut

    def _flush_reads(self) -> None:
        self._read_flush_scheduled = False
        pending, self._read_pending = self._read_pending, []
        if pending:
            t = asyncio.ensure_future(self._read_batch(pending))
            self._inflight.add(t)
            t.add_done_callback(self._inflight.discard)

    async def _read_batch(self, pending) -> None:
        try:
            rep = await self.storage.call(
                TOKEN_STORAGE_GET_BATCH,
                StorageGetBatch(
                    versions=[v for _k, v, _f in pending],
                    keys=[k for k, _v, _f in pending],
                ),
                timeout=30.0,
            )
            for (_k, _v, fut), val in zip(pending, rep.values):
                if not fut.done():
                    fut.set_result(val)
        except Exception as e:
            for _k, _v, fut in pending:
                if not fut.done():
                    fut.set_exception(
                        transport.RemoteError(f"read batch: {e!r}")
                    )

    async def _applier(self) -> None:
        """Single ordered drain of the apply queue: many versions per
        StorageApplyBatch RPC. Append order IS commit order (appends
        happen synchronously after each batch's logging-chain set)."""
        while True:
            await self._apply_event.wait()
            self._apply_event.clear()
            while self._apply_queue:
                q, self._apply_queue = self._apply_queue, []
                try:
                    apply_rep = await self.storage.call(
                        TOKEN_STORAGE_APPLY_BATCH,
                        StorageApplyBatch(
                            versions=[v for v, _m, _p in q],
                            groups=[m for _v, m, _p in q],
                            # sequencer mode: ship the global grant
                            # chain so storage orders interleaved
                            # per-proxy appliers; legacy mode sends no
                            # prevs (queue order IS version order and
                            # failed batches legally hole the chain)
                            prev_versions=(
                                [p for _v, _m, p in q]
                                if self.sequencer is not None else ()
                            ),
                        ),
                        timeout=30.0,
                    )
                except Exception as e:
                    if self.failed is None:
                        self.failed = e
                    return
                self.applied_version = q[-1][0]
                if self.trace:
                    from foundationdb_tpu_torch.utils import commit_debug as _cdbg
                    from foundationdb_tpu_torch.utils import trace as _tr

                    for v, m, _p in q:
                        if m:
                            _tr.g_trace_batch.add_event(
                                "CommitDebug", _cdbg.version_id(v),
                                _cdbg.STORAGE_APPLIED,
                            )
                # storage holds this prefix DURABLY (reply durable=1 —
                # the store write-ahead-logs its applies): pop the
                # tlog so its disk queue stays tail-sized (restart
                # recovery cost ∝ tail, not history). A memory-only
                # store never earns a pop: the tlog would be the only
                # durable copy of committed mutations. Advisory — a
                # pop failure (e.g. a mid-recovery fence) must never
                # fail the pipeline — and LAST in the drain round, so
                # a teardown cancellation parked here can't eat the
                # batch's trace events above.
                if not getattr(apply_rep, "durable", 0):
                    continue
                for tl in self._tlogs:
                    try:
                        await tl.call(
                            TOKEN_TLOG_POP,
                            TLogPop(
                                version=self.applied_version,
                                epoch=self.epoch,
                            ),
                            timeout=5.0,
                        )
                    except asyncio.CancelledError:
                        raise
                    except Exception:
                        pass

    async def _batcher(self) -> None:
        from foundationdb_tpu_torch.cluster.batching import commit_txn_bytes

        while True:
            await asyncio.sleep(self.batch_sizer.interval)
            if not self._queue:
                continue
            sizer = self.batch_sizer
            count_target = min(sizer.target_count, self.max_batch)
            take, nbytes = 0, 0
            for txn, _f in self._queue:
                if take >= count_target or nbytes >= sizer.target_bytes:
                    break
                take += 1
                nbytes += commit_txn_bytes(txn)
            batch, self._queue = self._queue[:take], self._queue[take:]
            was_full = bool(self._queue) or take >= count_target
            if was_full:
                sizer.batch_full()
            else:
                sizer.batch_underfull(take)
            # bounded pipeline depth: acquire BEFORE allocating the
            # version so a stalled chain backpressures the batcher
            # instead of growing an unbounded in-flight set
            await self._depth.acquire()
            self._batch_seq += 1
            num = self._batch_seq
            # phase 1, at spawn: version allocation. Sequencer mode
            # awaits a GetCommitVersion grant — the batcher is the sole
            # caller, so request_nums are issued in order and the
            # resolve/push stages of successive batches still overlap
            # (only the allotment RPC is serial, as in the reference).
            # Legacy mode allocates locally, synchronously (monotonic
            # across failed attempts — a dead batch consumed its
            # version; the reference master never re-hands one).
            tag_info = None
            if self.sequencer is not None:
                tags = self._batch_tags([t for t, _f in batch])
                try:
                    grant = await self._get_commit_version(tags)
                except Exception as e:
                    # an unreachable sequencer breaks the chain for
                    # this proxy generation: fail fast and retryably
                    if self.failed is None:
                        self.failed = e
                    for _txn, fut in batch:
                        if not fut.done():
                            fut.set_exception(transport.RemoteError(
                                f"commit pipeline: {e!r}"
                            ))
                    self._depth.release()
                    self._batch_seq -= 1
                    return
                version, prev_version = grant.version, grant.prev_version
                self._last_allocated = version
                self._chain_prev = version
                tag_info = (tags, dict(zip(tags, grant.tag_prevs)))
            else:
                version = (
                    max(self.committed_version, self._last_allocated)
                    + self.version_step
                )
                self._last_allocated = version
                prev_version, self._chain_prev = self._chain_prev, version
            t = asyncio.ensure_future(
                self._commit_batch(batch, num, prev_version, version,
                                   was_full, tag_info)
            )
            self._inflight.add(t)
            self._batches_inflight += 1
            self.smoothed_queue_depth.set_total(len(self._queue))

            def _done(_f, t=t):
                self._inflight.discard(t)
                self._batches_inflight -= 1
                self._depth.release()

            t.add_done_callback(_done)

    async def _commit_batch(
        self, batch, num, prev_version, version, was_full, tag_info=None
    ) -> None:
        try:
            await self._commit_batch_traced(
                batch, num, prev_version, version, was_full, tag_info
            )
        except Exception as e:
            # A hole in the version chain breaks this proxy generation:
            # fail the batch's clients, mark the pipeline failed, and
            # advance the ordering chains so successors fail fast
            # instead of wedging on when_at_least forever.
            if self.failed is None:
                self.failed = e
            for _txn, fut in batch:
                if not fut.done():
                    fut.set_exception(
                        transport.RemoteError(f"commit pipeline: {e!r}")
                    )
            if num > self._latest_batch_logging.get():
                self._latest_batch_logging.set(num)

    async def _commit_batch_traced(
        self, batch, num, prev_version, version, was_full, tag_info=None
    ) -> None:
        if not self.trace:
            await self._commit_batch_impl(
                batch, num, prev_version, version, was_full, None, None,
                tag_info,
            )
            return
        from foundationdb_tpu_torch.utils import commit_debug as _cdbg
        from foundationdb_tpu_torch.utils import trace as _tr
        from foundationdb_tpu_torch.utils.spans import Span

        dbg = f"pipe-b{num}"
        for t, _f in batch:
            if t.debug_id is not None:
                _tr.g_trace_batch.add_attach(
                    "CommitAttachID", t.debug_id, dbg
                )
        _tr.g_trace_batch.add_event("CommitDebug", dbg, _cdbg.BATCH_BEFORE)
        with Span("ProxyPipeline.commitBatch") as span:
            span.attribute("Txns", len(batch))
            await self._commit_batch_impl(
                batch, num, prev_version, version, was_full, dbg, span,
                tag_info,
            )

    # -- tag partitioning ----------------------------------------------

    def _tag_of_key(self, key: bytes) -> int:
        """The tlog index owning `key` — the same even byte-prefix
        partition formula as the resolver split (the ranges come from
        default_resolver_boundaries over the tlog count)."""
        for i, (lo, hi) in enumerate(self._tlog_ranges):
            if key >= lo and (hi is None or key < hi):
                return i
        return len(self._tlog_ranges) - 1

    def _mutation_tags(self, m) -> list:
        """Owning tlog indices for one mutation: a SET has one owner; a
        CLEAR_RANGE touches every partition it intersects."""
        if m.op == StorageRole.MUT_CLEAR_RANGE:
            out = []
            for i, (lo, hi) in enumerate(self._tlog_ranges):
                if m.param1 < (hi if hi is not None else m.param1 + b"\x00") \
                        and (m.param2 > lo):
                    out.append(i)
            return out
        return [self._tag_of_key(m.param1)]

    def _batch_tags(self, txns) -> list:
        """Declared tags for a batch = owners of every txn's mutations,
        computed BEFORE resolution (an aborted txn's declared tag still
        gets its empty push — the per-tag chain must stay gapless
        whether or not the data survives the conflict check)."""
        if self._tlog_ranges is None:
            return [0] if len(self._tlogs) == 1 else list(
                range(len(self._tlogs))
            )
        tags = set()
        for t in txns:
            for m in t.mutations:
                tags.update(self._mutation_tags(m))
        if not tags:
            tags.add(0)  # empty batches keep tag 0's chain warm
        return sorted(tags)

    def _split_mutations(self, mutations, tags) -> dict:
        """Partition a batch's committed mutations by owning tlog.
        CLEAR_RANGEs are CLIPPED to each owner's range so recovery's
        multi-tlog merge concatenates disjoint pieces."""
        groups = {t: [] for t in tags}
        if self._tlog_ranges is None:
            for t in tags:
                groups[t] = list(mutations)
            return groups
        for m in mutations:
            if m.op == StorageRole.MUT_CLEAR_RANGE:
                for i in self._mutation_tags(m):
                    if i not in groups:
                        continue
                    lo, hi = self._tlog_ranges[i]
                    cb = m.param1 if m.param1 > lo else lo
                    ce = (
                        m.param2 if hi is None or m.param2 < hi else hi
                    )
                    if cb < ce:
                        groups[i].append(
                            codec.Mutation(m.op, cb, ce)
                        )
            else:
                i = self._tag_of_key(m.param1)
                if i in groups:
                    groups[i].append(m)
        return groups

    async def _get_commit_version(self, tags):
        self._seq_request_num += 1
        rn = self._seq_request_num
        # classification boundary is the batcher's grant try/except:
        # a failed grant fails the batch's clients retryably
        rep = await self.sequencer.call(
            TOKEN_GET_COMMIT_VERSION,
            GetCommitVersionRequest(
                proxy_id=self.proxy_id,
                request_num=rn,
                most_recent_processed=self._seq_processed,
                epoch=self.epoch,
                tags=tags,
            ),
            timeout=30.0,
        )
        self._seq_processed = rn
        self.version_grants += 1
        return rep

    async def _commit_batch_impl(
        self, batch, num, prev_version, version, was_full, dbg, span,
        tag_info=None,
    ) -> None:
        if self.failed is not None:
            raise PipelineFailedError(repr(self.failed))
        loop = asyncio.get_event_loop()
        txns = [t for t, _f in batch]
        if dbg is not None:
            from foundationdb_tpu_torch.utils import commit_debug as _cdbg
            from foundationdb_tpu_torch.utils import trace as _tr

            _tr.g_trace_batch.add_event(
                "CommitDebug", dbg, _cdbg.BATCH_GOT_VERSION
            )
        # phase 2: resolution — fired IMMEDIATELY (no wait on batch N:
        # the resolver's own prev_version chain serializes versions
        # server-side, Resolver.actor.cpp:269-290), so batch N+1's
        # resolve overlaps batch N's logging. All resolvers see the full
        # batch; verdicts min-combine (CommitProxyServer:1551-1567).
        # The resolve hop carries CONFLICT METADATA only — ranges, read
        # snapshot, per-txn debug id — never the data mutations, which
        # stay proxy-side for the tlog push (the resolver's verdict
        # doesn't read them): mutation bytes off the wire roughly
        # halves resolve encode+decode for write-heavy batches. On the
        # columnar path (default) that metadata packs ONCE into the
        # flat interval-array layout the resolver kernel consumes —
        # per-txn counts + versions + one joined key blob — instead of
        # per-txn objects the resolver would re-flatten.
        # the multi-resolver split applies on the stripped
        # conflict-metadata hop only: with RESOLVE_STRIP=0 (mutations
        # on the wire for A/B) every resolver still needs the full
        # transactions, so the split degrades to the broadcast
        if self._resolver_ranges is not None and _RESOLVE_STRIP:
            txn_views = [
                clip_transactions(txns, lo, hi)
                for lo, hi in self._resolver_ranges
            ]
        else:
            txn_views = None
        span_tuple = span.context.as_tuple() if span is not None else None
        if self._columnar:
            from foundationdb_tpu_torch.utils import packing as _packing

            def columnar_req(view):
                return codec.ResolveBatchColumnar(
                    prev_version=prev_version,
                    version=version,
                    last_received_version=prev_version,
                    epoch=self.epoch,
                    cols=_packing.pack_columnar(view),
                    debug_id=dbg,
                    span=span_tuple,
                )

            if txn_views is None:
                reqs = [columnar_req(txns)] * len(self.resolvers)
            else:
                reqs = [columnar_req(view) for view in txn_views]
            if dbg is not None:
                _tr.g_trace_batch.add_event(
                    "CommitDebug", dbg, _cdbg.PROXY_COLUMNAR_PACK
                )
        else:
            def object_req(view):
                return ResolveTransactionBatchRequest(
                    prev_version=prev_version,
                    version=version,
                    last_received_version=prev_version,
                    epoch=self.epoch,
                    transactions=view,
                    debug_id=dbg,
                    span=span_tuple,
                )

            if txn_views is not None:
                reqs = [object_req(view) for view in txn_views]
            elif _RESOLVE_STRIP:
                reqs = [object_req([
                    CommitTransaction(
                        read_conflict_ranges=t.read_conflict_ranges,
                        write_conflict_ranges=t.write_conflict_ranges,
                        read_snapshot=t.read_snapshot,
                        report_conflicting_keys=t.report_conflicting_keys,
                        debug_id=t.debug_id,
                    )
                    for t in txns
                ])] * len(self.resolvers)
            else:
                reqs = [object_req(txns)] * len(self.resolvers)
        t_resolve = loop.time()
        # classification boundary is _commit_batch: any pipeline
        # exception marks self.failed and fans RemoteError("commit
        # pipeline: ...") out to every queued client future
        replies = await asyncio.gather(
            *(r.call(TOKEN_RESOLVE, req, timeout=30.0)
              for r, req in zip(self.resolvers, reqs))
        )
        resolve_s = loop.time() - t_resolve
        if dbg is not None:
            _tr.g_trace_batch.add_event(
                "CommitDebug", dbg, _cdbg.BATCH_AFTER_RESOLUTION
            )
        verdicts = [
            min(int(rep.committed[i]) for rep in replies)
            for i in range(len(txns))
        ]
        # phase 3: collect committed mutations
        mutations = []
        for t, v in zip(txns, verdicts):
            if v == TransactionResult.COMMITTED:
                mutations.extend(t.mutations)
        # phase 4: log — ordered at the logging chain hand-off only
        if dbg is not None:
            _tr.TraceEvent(
                "CommitDebugVersion", severity=_tr.SEV_DEBUG
            ).detail("ID", dbg).detail("Version", version).detail(
                "Messages", 1 if mutations else 0
            ).log()
        await self._latest_batch_logging.when_at_least(num - 1)
        if self.failed is not None:
            raise PipelineFailedError(repr(self.failed))
        t_log = loop.time()
        # classification boundary is _commit_batch (same fan-out as the
        # resolve gather above)
        if tag_info is not None:
            # tag-partitioned push: each declared tlog gets ONLY its
            # tag's mutations, chained by the grant's per-tag prev.
            # Declared-but-empty tags (mutations died in the conflict
            # check or clipped empty) still get their empty push — the
            # per-tag chain must advance for every granted version that
            # declared the tag, or a later push would wedge on the gap.
            tags, tag_prevs = tag_info
            groups = self._split_mutations(mutations, tags)
            await asyncio.gather(*(
                self._tlogs[tg].call(
                    TOKEN_TLOG_PUSH,
                    TLogPush(
                        version=version,
                        prev_version=tag_prevs[tg],
                        mutations=groups[tg],
                        epoch=self.epoch,
                    ),
                    timeout=30.0,
                )
                for tg in tags
            ))
        else:
            await self.tlog.call(
                TOKEN_TLOG_PUSH,
                TLogPush(
                    version=version,
                    prev_version=prev_version,
                    mutations=mutations,
                    epoch=self.epoch,
                ),
                timeout=30.0,
            )
        if self.sequencer is not None:
            # report BEFORE the client replies: any later GRV — from
            # ANY proxy — must observe this version (the reference's
            # ReportRawCommittedVersion ordering)
            await self.sequencer.call(
                TOKEN_REPORT_COMMITTED,
                ReportRawCommittedVersionRequest(
                    version=version, epoch=self.epoch
                ),
                timeout=30.0,
            )
        log_s = loop.time() - t_log
        if dbg is not None:
            _tr.g_trace_batch.add_event(
                "CommitDebug", dbg, _cdbg.TLOG_AFTER_COMMIT
            )
            _tr.g_trace_batch.add_event(
                "CommitDebug", dbg, _cdbg.BATCH_AFTER_LOG_PUSH
            )
        self.prev_version = version
        self.committed_version = version
        # guarded like the error path: a FAILED successor batch advances
        # the chain past us (fail-fast for its own successors), and an
        # unguarded set(num) here would raise Notified-must-not-decrease
        # AFTER our push is durable — turning a committed batch into a
        # client error and skipping its storage apply while
        # committed_version already advanced (reads at our GRV would
        # wedge server-side until the RPC timeout)
        if num > self._latest_batch_logging.get():
            self._latest_batch_logging.set(num)
        self.batch_sizer.observe_stage_latency(
            resolve_s + log_s, full=was_full
        )
        # phase 5: replies fire as soon as OUR push is durable — no
        # wait for storage. The chain hand-off above makes replies
        # version-ordered: batch N's reply loop runs synchronously
        # after set(num=N) and before N+1 can resume from its wait.
        for (txn, fut), v in zip(batch, verdicts):
            if fut.done():
                continue
            if v == TransactionResult.COMMITTED:
                fut.set_result(version)
            else:
                fut.set_exception(NotCommittedError(TransactionResult(v).name))
        # phase 6: storage apply rides the applier's ordered queue
        # BEHIND the replies (the storage pull loop collapsed into a
        # batched ordered push; versioned reads wait server-side for the
        # version they need, so a lagging apply costs read latency,
        # never correctness). Appended with no await since the logging
        # set above — queue order IS commit order.
        self._apply_queue.append((version, mutations, prev_version))
        self._last_enqueued_apply = version
        self._apply_event.set()


# ---------------------------------------------------------------------------
# Wire-mode status (the fdbtop substrate).


def _pipeline_status_blocks(pipeline: "ProxyPipeline") -> dict[str, dict]:
    """The parent process's own process blocks: it plays both proxies
    in wire mode (commit batching and the GRV front door)."""
    from foundationdb_tpu_torch.runtime import census as _census

    try:
        tasks = len(asyncio.all_tasks())
    except RuntimeError:  # no running loop (a synchronous status dump)
        tasks = 0
    return {
        "proxy0": {
            "role": "commit_proxy",
            "committed_version": pipeline.committed_version,
            "qos": pipeline.saturation(),
            # the parent's own resource census (each role process
            # reports its own through _serve_role's handler)
            "census": {**_census.snapshot(), "tasks": tasks},
        },
        "grv_proxy0": {
            "role": "grv_proxy",
            "qos": pipeline.grv_saturation(),
        },
    }


async def wire_cluster_status(
    roles: dict[str, transport.RpcConnection],
    pipeline: "ProxyPipeline" = None,
    *,
    lag_target: float = 2_000_000.0,
) -> dict:
    """The reference-shaped status document of a wire cluster: one
    StatusRequest a role process, plus the parent pipeline's own proxy
    blocks, assembled through the same qos math as the sim
    `cluster_status()` (cluster/status.py assemble_status)."""
    from foundationdb_tpu_torch.cluster.status import assemble_status

    procs: dict[str, dict] = {}
    for name, conn in roles.items():
        try:
            reply = await conn.call(
                TOKEN_STATUS, StatusRequest(pad=0), timeout=30.0
            )
        except (transport.TransportError, ConnectionError,
                asyncio.TimeoutError) as e:
            # a status poll of one dead role names the role instead of
            # raising a bare socket error
            raise transport.RemoteError(
                f"status poll of role {name!r} failed: {e!r}"
            ) from e
        procs[name] = json.loads(reply.payload)
    if pipeline is not None:
        procs.update(_pipeline_status_blocks(pipeline))
    return assemble_status(procs, lag_target=lag_target)


def serve_status(
    socket_dir: str, pipeline: "ProxyPipeline"
) -> transport.RpcServer:
    """The parent's status endpoint: an RpcServer on proxy0.sock in the
    role socket dir, answering StatusRequest with the pipeline's own
    proxy blocks, so a poller of the socket dir sees the commit and GRV
    proxy sensors beside the role processes'. The caller starts it
    (`await server.start()`) and closes it at teardown."""
    address = os.path.join(socket_dir, "proxy0.sock")
    server = transport.RpcServer(address, tls=_tls_from_env())

    async def status(_req: StatusRequest) -> StatusReply:
        blocks = _pipeline_status_blocks(pipeline)
        payload = blocks["proxy0"]
        # the GRV block rides along (one socket, both proxy roles)
        payload["grv_proxy"] = blocks["grv_proxy0"]
        return StatusReply(payload=json.dumps(payload))

    server.register(TOKEN_STATUS, status)
    return server


def main() -> None:
    from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS

    # the launcher's knob settings reach this fresh interpreter through
    # FDBTPU_KNOB_OVERRIDES
    SERVER_KNOBS.apply_env_overrides()
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", required=True)
    ap.add_argument("--address", required=True,
                    help="the Unix socket path to serve")
    ap.add_argument("--backend", default="cuda",
                    choices=("cuda", "cpu", "native", "knob"),
                    help="resolver: cuda: TorchConflictSet on --device; "
                         "knob: the RESOLVER_BACKEND knob's choice, gated "
                         "by RESOLVER_CUDA_MIN_BATCH; cpu: the host "
                         "oracle; native: the C++ skip list")
    ap.add_argument("--device", default=None,
                    help="resolver, worker: the TorchConflictSet's device "
                         "(default: the card)")
    ap.add_argument("--data-dir", default=None,
                    help="tlog / storage: the directory they persist in "
                         "(none: memory only)")
    ap.add_argument("--tlog-address", default=None,
                    help="storage: catch up from this tlog before serving")
    ap.add_argument("--storage-engine", default="memory",
                    choices=("memory", "lsm"))
    ap.add_argument("--encrypt", action="store_true",
                    help="tlog / storage: seal the data dir (keys from "
                         "the REST KMS at FDB_TPU_KMS, else the sim KMS)")
    ap.add_argument("--trace-file", default=None,
                    help="a JSONL trace sink for this process")
    ap.add_argument("--peers", default=None,
                    help="ratekeeper: comma list of the peer role sockets "
                         "whose StatusRequest sensors it polls")
    ap.add_argument("--controller", default=None,
                    help="worker / ratekeeper: the cluster controller's "
                         "socket (workers register, the ratekeeper takes "
                         "its peers from the topology)")
    ap.add_argument("--worker-id", default=None,
                    help="worker: its identity in RegisterWorker")
    ap.add_argument("--cluster-conf", default=None,
                    help="controller: a JSON file with the declarative "
                         "topology (resolvers, backend, data dirs)")
    ap.add_argument("--state-file", default=None,
                    help="controller: the persisted epoch (the "
                         "coordinated-state analog), so a restarted "
                         "controller recovers into a newer generation")
    args = ap.parse_args()
    asyncio.run(
        _serve_role(
            args.role,
            args.address,
            None if args.backend == "knob" else args.backend,
            data_dir=args.data_dir,
            tlog_address=args.tlog_address,
            storage_engine=args.storage_engine,
            encrypt=args.encrypt,
            trace_file=args.trace_file,
            peers=args.peers.split(",") if args.peers else None,
            controller=args.controller,
            worker_id=args.worker_id,
            cluster_conf=args.cluster_conf,
            state_file=args.state_file,
            device=args.device,
        )
    )


if __name__ == "__main__":
    main()
