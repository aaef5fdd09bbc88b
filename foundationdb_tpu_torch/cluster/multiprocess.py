"""The wire-served resolver: a Resolver role as an OS process (the port's
own copy of the resolver part of foundationdb_tpu.cluster.multiprocess).

The reference runs every role in its own `fdbserver` process connected
by FlowTransport (fdbserver/worker.actor.cpp:2305-2811 spawns the role
actors). Here

    python -m foundationdb_tpu_torch.cluster.multiprocess \\
        --role resolver --address /path/resolver0.sock [--backend cuda]

serves one ResolverRole over wire.transport on a Unix socket, and `spawn_role` / `connect` launch and reach it
from a parent. A proxy sends it ResolveTransactionBatchRequest or
ResolveBatchColumnar frames on TOKEN_RESOLVE; the frames, tokens and
message ids are the JAX package's, so a JAX ProxyPipeline commits
through port resolver processes and a port proxy through JAX ones.

The backends, against the JAX package's:

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
are a tensor axis on the one device.

A role built on a TorchConflictSet warms up before its socket binds:
it loads the built kernel libraries (on the card), runs one throwaway
resolve on a scratch set of the same config (its constructor runs K20's
self-check) and records the seconds (`ResolverWarmCompile`). A "cuda"
role without a card fails there, before it binds, and exits non-zero.
`connect(address, proc=...)` fails as soon as the child has exited
instead of spending its retries.

Only the resolver role is ported; every other role of the JAX module
raises ValueError here.
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
TOKEN_PING = 0x0401
TOKEN_STATUS = 0x0501

#: the JAX module's other roles, not ported yet
UNPORTED_ROLES = ("tlog", "storage", "sequencer", "ratekeeper", "worker",
                  "controller")

# ---------------------------------------------------------------------------
# Small wire messages, declared field by field (explicit layouts, stable
# ids).

_WRITERS = {
    "u8": codec.w_u8,
    "i64": codec.w_i64,
    "bytes": codec.w_bytes,
    "str": codec.w_str,
}
_READERS = {
    "u8": codec.r_u8,
    "i64": codec.r_i64,
    "bytes": codec.r_bytes,
    "str": codec.r_str,
}


def _message(type_id: int, name: str, fields: list[tuple]):
    # a field is (name, kind); the wire layout is the field order
    cls = dataclasses.make_dataclass(name, [f for f, _kind in fields])
    kinds = list(fields)

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
RoleVersionReq = _message(0x0230, "RoleVersionReq", [("pad", "u8")])
RoleVersionReply = _message(0x0231, "RoleVersionReply", [("version", "i64")])
# saturation telemetry: every role answers StatusRequest with its status
# block as a JSON document (the reference's status JSON)
StatusRequest = _message(0x0240, "StatusRequest", [("pad", "u8")])
StatusReply = _message(0x0241, "StatusReply", [("payload", "str")])


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
# The role process.


async def _serve_role(role_name: str, address, backend: Optional[str],
                      device=None) -> None:
    if role_name in UNPORTED_ROLES:
        raise ValueError(f"role {role_name!r} is not ported yet")
    if role_name != "resolver":
        raise ValueError(f"unknown role {role_name!r}")
    # the role (and its warm-up) before the socket: a role that cannot
    # serve never binds
    role = ResolverRole(backend=backend, device=device)
    server = transport.RpcServer(address, tls=_tls_from_env())

    async def ping(msg: Ping) -> Pong:
        return Pong(payload=msg.payload)

    async def rv(req: RoleVersionReq) -> RoleVersionReply:
        return RoleVersionReply(version=role.version)

    async def status(_req: StatusRequest) -> StatusReply:
        from foundationdb_tpu_torch import kernels
        from foundationdb_tpu_torch.runtime import census as _census

        blk = role.status()
        # this process's own live fds, connections, servers and asyncio
        # tasks, and its kernel launches so far (kernels.COUNTS)
        blk["census"] = {
            **_census.snapshot(),
            "tasks": len(asyncio.all_tasks()),
        }
        blk["kernel_launches"] = kernels.counts()
        return StatusReply(payload=json.dumps(blk))

    server.register(TOKEN_PING, ping)
    server.register(TOKEN_RESOLVE, role.resolve)
    server.register(TOKEN_RESOLVER_VERSION, rv)
    server.register(TOKEN_STATUS, status)
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


def spawn_role(name: str, socket_dir: str, *,
               backend: Optional[str] = "cuda", device=None,
               index: int = 0, env: Optional[dict] = None) -> RoleProcess:
    """Start one role as a child OS process serving a Unix socket in
    `socket_dir`. The child sees the parent's environment (`env` adds to
    it) with PYTHONPATH set to the repository root, and nothing else
    changed: a "cuda" child uses the card the parent would, and exits
    non-zero before it binds when there is none."""
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


async def connect(address, *, proc: RoleProcess, retries: int = 1200,
                  delay: float = 0.1) -> transport.RpcConnection:
    """Connect to the socket of the role `proc` serves, retrying while it
    starts: a resolver warms up (the torch import, the CUDA context, the
    kernel loads, two constructors and a first resolve) before it binds.
    The child is polled between tries and its exit fails the call at once
    (RoleExitedError), not after the retries."""
    conn = transport.RpcConnection(address, tls=_tls_from_env())
    last = None
    for _ in range(retries):
        code = proc.exited()
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
                    help="cuda: TorchConflictSet on --device; knob: the "
                         "RESOLVER_BACKEND knob's choice, gated by "
                         "RESOLVER_CUDA_MIN_BATCH; cpu: the host oracle; "
                         "native: the C++ skip list")
    ap.add_argument("--device", default=None,
                    help="the TorchConflictSet's device (default: the card)")
    args = ap.parse_args()
    asyncio.run(
        _serve_role(
            args.role,
            args.address,
            None if args.backend == "knob" else args.backend,
            device=args.device,
        )
    )


if __name__ == "__main__":
    main()
