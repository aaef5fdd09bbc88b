"""The wire commit path: roles as OS processes over the serialized wire
(the port's own copy of foundationdb_tpu.cluster.multiprocess's roles,
messages, launcher and ProxyPipeline).

The reference runs every role in its own `fdbserver` process connected
by FlowTransport (fdbserver/worker.actor.cpp:2305-2811 spawns the role
actors). Here

    python -m foundationdb_tpu_torch.cluster.multiprocess \\
        --role {resolver,tlog,storage,sequencer} --address /path/x.sock \\
        [--backend cuda] [--data-dir DIR] [--storage-engine lsm] \\
        [--tlog-address /path/tlog0.sock] [--trace-file x.jsonl]

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

Not ported yet: the ratekeeper, worker and controller roles
(`UNPORTED_ROLES`, which raise ValueError), the proxy as a worker role,
the cluster client and the status assembly; and encryption at rest:
`encrypt=True`, `--encrypt` and an `encryption` object raise ValueError
before anything is opened, and a store written encrypted is refused by
its ENCRYPTION_MODE marker with RuntimeError, as in the JAX package.
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
from foundationdb_tpu_torch.wire import codec, transport

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
# the sequencer role (version-batch allotment)
TOKEN_GET_COMMIT_VERSION = 0x0801
TOKEN_REPORT_COMMITTED = 0x0802
TOKEN_SEQUENCER_VERSION = 0x0803

#: the JAX module's other roles, not ported yet
UNPORTED_ROLES = ("ratekeeper", "worker", "controller")

ENCRYPTION_NOT_PORTED = "at-rest encryption is not ported yet"

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
                 window: int = 5_000_000, epoch: int = 0, device=None):
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
            reply = self._resolve_now(req)
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


# ---------------------------------------------------------------------------
# The log, sequencer and storage roles.


def _refuse_encryption(encryption) -> None:
    """Encryption at rest is not ported: asking for it raises before
    any file is opened, never opens a store without the cipher."""
    if encryption is not None:
        raise ValueError(ENCRYPTION_NOT_PORTED)


def _looks_sealed(blob: bytes) -> bool:
    """A record sealed by the JAX package's cipher (the header sniff:
    defence in depth behind the ENCRYPTION_MODE marker)."""
    from foundationdb_tpu_torch.crypto.blob_cipher import is_encrypted

    return is_encrypted(blob)


def _check_encryption_marker(data_dir: str) -> None:
    """The persisted encryption mode (the reference persists
    encryptionAtRestMode and refuses mode flips, DatabaseConfiguration.h):
    a store written encrypted is never opened unencrypted, or sealed
    bytes would be served as data. The marker is deterministic where a
    record sniff alone could mistake user bytes for a header."""
    if os.path.exists(os.path.join(data_dir, "ENCRYPTION_MODE")):
        raise RuntimeError(
            f"{data_dir} was written with encryption-at-rest; "
            "restart the role with --encrypt (and the same KMS)"
        )


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

        _refuse_encryption(encryption)
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
        #: disk-queue seq a pushed version: the pop boundary lookup
        self._seq_by_version: list[tuple[int, int]] = []
        self._data_dir = data_dir
        if data_dir:
            from foundationdb_tpu_torch.native import DiskQueue

            os.makedirs(data_dir, exist_ok=True)
            _check_encryption_marker(data_dir)
            self._dq = DiskQueue(os.path.join(data_dir, "tlog"))
            for seq, blob in self._dq.recovered:
                if _looks_sealed(blob):
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
            seq = self._dq.push(codec.encode(req))
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

        _refuse_encryption(encryption)
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
            _check_encryption_marker(data_dir)
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

    def _replay_local_log(self) -> None:
        """Restart: replay the log tail above the checkpoint, at a cost
        in proportion to the tail, not the dataset."""
        for seq, blob in self._dq.recovered:
            if _looks_sealed(blob):
                # codec records never start with the cipher's magic: a
                # sealed blob here means a lost marker
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
                reqs = [
                    StorageApply(version=v, mutations=muts)
                    for v, muts in zip(rep.versions, rep.groups)
                    if v > self.version
                ]
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
        if req.version > self.version and self._dq is not None:
            await self._log_durably([req])
        return await self._apply_logged(req)

    async def apply_batch(self, req: StorageApplyBatch) -> StorageApplyReply:
        """Version-ordered group apply (the applier's drain): one
        write-ahead group fsync (when persistent) and one ordered
        in-memory sweep for the whole chunk.

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
        }

    async def get(self, req: StorageGet) -> StorageGetReply:
        from foundationdb_tpu_torch.cluster.sampling import tag_of_key

        self.read_tags.note(tag_of_key(req.key), len(req.key))
        cond = self._cond_lazy()
        async with cond:
            await cond.wait_for(lambda: self.version >= req.version)
        if self._lsm is not None:
            # disk reads off the event loop: a cold read must not stall
            # unrelated requests
            value = await asyncio.get_event_loop().run_in_executor(
                None, self._lsm.get, req.key, req.version
            )
            return StorageGetReply(value=value)
        return StorageGetReply(value=self._get_at(req.key, req.version))

    def _get_at(self, key: bytes, version: int):
        """The newest value at or below `version` in the memory history."""
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
                return [lsm.get(k, rv)
                        for k, rv in zip(req.keys, req.versions)]

            values = await asyncio.get_event_loop().run_in_executor(
                None, read_all
            )
            return StorageGetBatchReply(values=values)
        return StorageGetBatchReply(values=[
            self._get_at(k, rv) for k, rv in zip(req.keys, req.versions)
        ])

    async def snapshot(self, req: StorageSnapshotReq) -> StorageSnapshotReply:
        cond = self._cond_lazy()
        async with cond:
            await cond.wait_for(lambda: self.version >= req.version)
        if self._lsm is not None:
            kvs = await asyncio.get_event_loop().run_in_executor(
                None, self._lsm.range, b"", b"", req.version
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
        return StorageSnapshotReply(version=self.version, kvs=kvs)


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
    device=None,
) -> None:
    """Serve one role on `address` until cancelled. The role (a
    resolver's warm-up, a storage's catch-up from `tlog_address`) is
    built before the socket binds: a role that cannot serve never binds."""
    if role_name in UNPORTED_ROLES:
        raise ValueError(f"role {role_name!r} is not ported yet")
    if encrypt:
        raise ValueError(ENCRYPTION_NOT_PORTED)
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
    tokens: dict = {}
    if role_name == "resolver":
        role = ResolverRole(backend=backend, device=device)
        tokens[TOKEN_RESOLVE] = role.resolve

        async def rv(req: RoleVersionReq) -> RoleVersionReply:
            return RoleVersionReply(version=role.version)

        tokens[TOKEN_RESOLVER_VERSION] = rv
    elif role_name == "tlog":
        role = TLogRole(data_dir=data_dir)
        tokens.update({
            TOKEN_TLOG_PUSH: role.push,
            TOKEN_TLOG_PEEK: role.peek,
            TOKEN_TLOG_PEEK_BATCH: role.peek_batch,
            TOKEN_TLOG_VERSION: role.get_version,
            TOKEN_TLOG_LOCK: role.lock,
            TOKEN_TLOG_POP: role.pop,
        })
    elif role_name == "storage":
        role = StorageRole(data_dir=data_dir, engine=storage_engine)
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
        if role_name == "resolver":
            from foundationdb_tpu_torch import kernels

            # the kernel launches of this process so far (kernels.COUNTS)
            blk["kernel_launches"] = kernels.counts()
        return StatusReply(payload=json.dumps(blk))

    server.register(TOKEN_PING, ping)
    server.register(TOKEN_STATUS, status)
    for token, handler in tokens.items():
        server.register(token, handler)
    await server.start()
    try:
        await asyncio.Event().wait()  # until killed
    finally:
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
    non-zero before it binds when there is none. `backend` and `device`
    only matter to a resolver; `peers`, `controller`, `worker_id`,
    `cluster_conf` and `state_file` to the unported roles, which the
    child refuses. `encrypt` raises ValueError before anything starts."""
    if encrypt:
        raise ValueError(ENCRYPTION_NOT_PORTED)
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
                    help="resolver: the TorchConflictSet's device "
                         "(default: the card)")
    ap.add_argument("--data-dir", default=None,
                    help="tlog / storage: the directory they persist in "
                         "(none: memory only)")
    ap.add_argument("--tlog-address", default=None,
                    help="storage: catch up from this tlog before serving")
    ap.add_argument("--storage-engine", default="memory",
                    choices=("memory", "lsm"))
    ap.add_argument("--encrypt", action="store_true",
                    help="encryption at rest: not ported, refused")
    ap.add_argument("--trace-file", default=None,
                    help="a JSONL trace sink for this process")
    ap.add_argument("--peers", default=None,
                    help="ratekeeper (not ported): the peer role sockets")
    ap.add_argument("--controller", default=None,
                    help="worker / ratekeeper (not ported): the "
                         "controller's socket")
    ap.add_argument("--worker-id", default=None,
                    help="worker (not ported): its identity")
    ap.add_argument("--cluster-conf", default=None,
                    help="controller (not ported): the topology file")
    ap.add_argument("--state-file", default=None,
                    help="controller (not ported): the persisted epoch")
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
            device=args.device,
        )
    )


if __name__ == "__main__":
    main()
