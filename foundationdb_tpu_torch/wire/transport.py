"""Token-addressed RPC over real sockets (asyncio): the FlowTransport
analog for multi-process clusters (the port's own copy of
foundationdb_tpu.wire.transport; the handshake, the framing and the
error frames are the JAX package's, so either package's client talks to
either package's server).

The reference's single comm backend is FlowTransport: TCP connections
carrying token-addressed serialized messages, a version-checked
ConnectPacket handshake (fdbrpc/FlowTransport.actor.cpp:427), CRC32
checksums per packet (:1119-1142), and delivery to a local promise keyed
by the endpoint token (`deliver`, :1022). Simulation swaps the wire for
in-process Sim2 connections.

This module keeps the same discipline with asyncio streams:

* **Endpoint token** (u64): the server registers async handlers per
  token; a request frame names the token it targets. Well-known tokens
  (WellKnownEndpoints.h analog) are small constants in cluster code.
* **Handshake**: 8-byte magic + u64 PROTOCOL_VERSION both ways before any
  frame; mismatch closes the connection (the multi-version story lives
  above this layer, as in the reference).
* **Frames**: u32 length | u32 crc32(body) | body. A corrupted frame
  raises and closes the connection rather than delivering garbage.
* **Request/reply**: u64 request ids correlate replies over a shared
  connection; handler exceptions travel back as error frames and re-raise
  client-side as RemoteError.

Unix-domain sockets by default (role processes share a socket dir the
way fdbmonitor-supervised processes share a cluster file); TCP works by
passing ("host", port) addresses.
"""

from __future__ import annotations

import asyncio
import ssl as _ssl
import struct
import sys
import zlib
from typing import Any, Callable

from foundationdb_tpu_torch.runtime import census
from foundationdb_tpu_torch.wire import codec

MAGIC = b"FDBTPUv1"
_HDR = struct.Struct("<II")  # length, crc32
_REQ = struct.Struct("<BQQ")  # kind, reqid, token
_REP = struct.Struct("<BQ")  # kind, reqid

KIND_REQUEST = 0
KIND_REPLY = 1
KIND_ERROR = 2

MAX_FRAME = 256 * 1024 * 1024


class TransportError(ConnectionError):
    pass


class HandshakeError(TransportError):
    pass


class ChecksumError(TransportError):
    pass


class RemoteError(RuntimeError):
    """The remote handler raised; message carries its repr."""


class UnknownEndpointError(RemoteError):
    pass


async def _handshake(reader, writer, protocol_version: int = None) -> None:
    ours = codec.PROTOCOL_VERSION if protocol_version is None else protocol_version
    writer.write(MAGIC + struct.pack("<Q", ours))
    await writer.drain()
    peer = await reader.readexactly(len(MAGIC) + 8)
    if peer[: len(MAGIC)] != MAGIC:
        raise HandshakeError("bad magic from peer")
    (version,) = struct.unpack("<Q", peer[len(MAGIC) :])
    if version != ours:
        raise HandshakeError(
            f"protocol version mismatch: ours {ours:#x}, "
            f"peer {version:#x}"
        )


async def _read_frame(reader) -> memoryview:
    """One frame's body as a memoryview: the payload slice the caller
    hands to codec.decode never copies (readexactly's bytes object is
    the only per-frame allocation on the receive path)."""
    hdr = await reader.readexactly(_HDR.size)
    length, crc = _HDR.unpack(hdr)
    if length > MAX_FRAME:
        raise TransportError(f"oversized frame ({length} bytes)")
    body = await reader.readexactly(length)
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise ChecksumError("frame checksum mismatch")
    return memoryview(body)


class _FrameBuffer:
    """Per-connection reusable frame encoder: header + preamble + codec
    payload packed into ONE WriteBuffer, written with ONE writer.write.

    Frame build and write are synchronous (no await between them), so
    concurrent requests on a shared connection can share the buffer: by
    the time control yields, a plain-socket transport has either sent
    the view or copied the remainder into its own buffer. TLS transports
    retain references in the SSL write backlog, so `zero_copy=False`
    hands them an immutable bytes copy instead. On Python >= 3.12 the
    selector transport buffers the caller's memoryview WITHOUT copying
    under backpressure (gh-91166), so view reuse is disabled there too —
    the next frame would corrupt the queued one.
    """

    __slots__ = ("buf", "zero_copy")

    _VIEW_REUSE_SAFE = sys.version_info < (3, 12)

    def __init__(self, zero_copy: bool):
        self.buf = codec.WriteBuffer()
        self.zero_copy = zero_copy and self._VIEW_REUSE_SAFE

    def send(self, writer, preamble: bytes, msg=None, raw: bytes = None):
        buf = self.buf
        buf.reset()
        hdr = buf.reserve(_HDR.size)
        buf.put_raw(preamble)
        if msg is not None:
            codec.encode_into(buf, msg)
        if raw is not None:
            buf.put_raw(raw)
        body = buf.view()[_HDR.size:]
        buf.patch_u32(hdr, len(body))
        buf.patch_u32(hdr + 4, zlib.crc32(body) & 0xFFFFFFFF)
        writer.write(buf.view() if self.zero_copy else buf.getvalue())


Address = "str | tuple[str, int]"  # UDS path or (host, port)


class RpcServer:
    """Serves registered endpoint tokens over UDS or TCP.

    With `tls` (a crypto.tls.TLSConfig), every connection is MUTUAL
    TLS under the cluster CA — the reference's FlowTransport TLS mode
    (flow/TLSConfig.actor.cpp): a client without a CA-chained cert is
    dropped at handshake, and verify_peers-style subject checks run
    before any frame is served."""

    def __init__(self, address, *, tls=None, protocol_version: int = None):
        self.address = address
        self.tls = tls
        self.protocol_version = protocol_version  # None = current
        self._handlers: dict[int, Callable] = {}
        self._server: asyncio.AbstractServer | None = None
        self._conns: set = set()  # live connection writers
        self._census_live = False  # tracked in census.SERVERS

    def register(self, token: int, handler: Callable) -> None:
        """handler: async (msg) -> reply msg (codec-registered types)."""
        if token in self._handlers:
            raise ValueError(f"token {token:#x} already registered")
        self._handlers[token] = handler

    async def start(self) -> None:
        ssl_ctx = self.tls.server_context() if self.tls else None
        if isinstance(self.address, str):
            # A kill -9'd role leaves its bound socket file behind, and
            # bind() on an existing path fails with EADDRINUSE — a
            # re-spawned role on the same path would crash-loop (or a
            # client could connect to the corpse). Unlink a CORPSE
            # before bind — but only a corpse: probe-connect first, and
            # if somebody accepts (or even hangs — a stalled server
            # still owns its identity), fail loudly instead of silently
            # hijacking a live role's socket.
            import os as _os

            if _os.path.exists(self.address):
                probe_w = None
                try:
                    _pr, probe_w = await asyncio.wait_for(
                        asyncio.open_unix_connection(path=self.address),
                        timeout=0.5,
                    )
                except asyncio.TimeoutError:
                    # MUST precede the OSError clause: on 3.11+
                    # TimeoutError IS an OSError subclass and would
                    # unlink a hung-but-live server's socket. A probe
                    # that hangs means somebody owns the identity —
                    # refuse, don't steal.
                    raise TransportError(
                        f"{self.address} probe timed out (owner alive "
                        "but not accepting); refusing to steal the "
                        "socket"
                    )
                except (ConnectionError, FileNotFoundError, OSError):
                    try:
                        _os.unlink(self.address)
                    except FileNotFoundError:
                        pass
                else:
                    probe_w.close()
                    raise TransportError(
                        f"{self.address} is already served by a live "
                        "process; refusing to steal the socket"
                    )
            self._server = await asyncio.start_unix_server(
                self._serve_conn, path=self.address, ssl=ssl_ctx
            )
        else:
            host, port = self.address
            self._server = await asyncio.start_server(
                self._serve_conn, host=host, port=port, ssl=ssl_ctx
            )
        if not self._census_live:
            self._census_live = True
            census.SERVERS.inc()

    async def close(self) -> None:
        if self._census_live:
            self._census_live = False
            census.SERVERS.dec()
        if self._server is not None:
            self._server.close()
            # drop live connections too: wait_closed() (3.12) waits for
            # every transport, so a close with clients still attached
            # would hang forever — a stopping server hangs up
            for w in list(self._conns):
                w.close()
            await self._server.wait_closed()
            self._server = None

    async def _serve_conn(self, reader, writer) -> None:
        self._conns.add(writer)
        try:
            if self.tls is not None:
                # verify_peers-style subject check on the CLIENT cert
                # (mutual TLS: the context already required one)
                sslobj = writer.get_extra_info("ssl_object")
                self.tls.verify_peer(sslobj)
            await _handshake(reader, writer, self.protocol_version)
            fb = _FrameBuffer(zero_copy=self.tls is None)
            pending: set[asyncio.Task] = set()
            while True:
                body = await _read_frame(reader)
                kind, reqid, token = _REQ.unpack_from(body, 0)
                if kind != KIND_REQUEST:
                    raise TransportError(f"unexpected frame kind {kind}")
                payload = body[_REQ.size :]  # memoryview slice, no copy
                t = asyncio.ensure_future(
                    self._dispatch(writer, reqid, token, payload, fb)
                )
                pending.add(t)
                t.add_done_callback(pending.discard)
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            HandshakeError,
            ChecksumError,
        ):
            pass
        except _ssl.SSLError:
            pass  # failed peer verification / non-TLS client: drop
        finally:
            self._conns.discard(writer)
            writer.close()

    async def _dispatch(
        self, writer, reqid: int, token: int, payload, fb: _FrameBuffer
    ):
        try:
            try:
                handler = self._handlers.get(token)
                if handler is None:
                    raise UnknownEndpointError(f"no endpoint {token:#x}")
                reply = await handler(codec.decode(payload))
                # build+write share the connection's frame buffer: no
                # await between fb.send entry and writer.write (see
                # _FrameBuffer)
                fb.send(writer, _REP.pack(KIND_REPLY, reqid), msg=reply)
            except Exception as e:  # travels back as an error frame
                fb.send(
                    writer, _REP.pack(KIND_ERROR, reqid),
                    raw=repr(e).encode("utf-8"),
                )
            await writer.drain()
        except ConnectionError:
            pass


class RpcConnection:
    """Client side: one connection, correlated request/reply."""

    def __init__(self, address, *, tls=None, protocol_version: int = None):
        self.address = address
        self.tls = tls
        self.protocol_version = protocol_version  # None = current
        self._reader = None
        self._writer = None
        self._next_id = 1
        self._waiters: dict[int, asyncio.Future] = {}
        self._reader_task: asyncio.Task | None = None
        self._fb = _FrameBuffer(zero_copy=tls is None)
        self._loop: asyncio.AbstractEventLoop | None = None
        self._census_live = False  # tracked in census.CONNECTIONS

    async def connect(self, *, retries: int = 50, delay: float = 0.1) -> None:
        last = None
        ssl_ctx = self.tls.client_context() if self.tls else None
        for _ in range(retries):
            try:
                if isinstance(self.address, str):
                    self._reader, self._writer = await asyncio.open_unix_connection(
                        path=self.address, ssl=ssl_ctx,
                        server_hostname="" if ssl_ctx else None,
                    )
                else:
                    host, port = self.address
                    self._reader, self._writer = await asyncio.open_connection(
                        host=host, port=port, ssl=ssl_ctx
                    )
                break
            except _ssl.SSLError as e:
                # a certificate the server refuses (or a plaintext
                # server) will refuse identically on every retry —
                # surface it now instead of burning the retry budget
                raise TransportError(
                    f"TLS handshake with {self.address} failed: {e}"
                )
            except (ConnectionError, FileNotFoundError, OSError) as e:
                last = e
                await asyncio.sleep(delay)
        else:
            raise TransportError(f"cannot connect to {self.address}: {last}")
        if self.tls is not None:
            # verify_peers-style subject check on the SERVER cert
            try:
                self.tls.verify_peer(
                    self._writer.get_extra_info("ssl_object")
                )
            except _ssl.SSLError as e:
                self._writer.close()
                raise TransportError(f"server failed peer verification: {e}")
        try:
            await _handshake(
                self._reader, self._writer, self.protocol_version
            )
        except (asyncio.IncompleteReadError, ConnectionError) as e:
            # the peer hung up mid-handshake — with TLS configured this
            # is typically cert refusal (mutual TLS / verify_peers);
            # without, a TLS server refusing a plaintext client
            self._writer.close()
            raise TransportError(
                f"handshake with {self.address} failed "
                f"(peer closed: {e!r})"
            )
        self._reader_task = asyncio.ensure_future(self._read_loop())
        if not self._census_live:
            self._census_live = True
            census.CONNECTIONS.inc()

    async def close(self) -> None:
        if self._census_live:
            self._census_live = False
            census.CONNECTIONS.dec()
        if self._reader_task:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except (asyncio.CancelledError, Exception):
                pass
            self._reader_task = None
        if self._writer:
            self._writer.close()
            self._writer = None
        for f in self._waiters.values():
            if not f.done():
                f.set_exception(TransportError("connection closed"))
        self._waiters.clear()

    async def _read_loop(self) -> None:
        try:
            while True:
                body = await _read_frame(self._reader)
                kind, reqid = _REP.unpack_from(body, 0)
                fut = self._waiters.pop(reqid, None)
                if fut is None or fut.done():
                    continue
                payload = body[_REP.size :]  # memoryview slice, no copy
                if kind == KIND_REPLY:
                    fut.set_result(codec.decode(payload))
                elif kind == KIND_ERROR:
                    fut.set_exception(
                        RemoteError(bytes(payload).decode("utf-8"))
                    )
                else:
                    fut.set_exception(TransportError(f"bad frame kind {kind}"))
        except (asyncio.IncompleteReadError, ConnectionError, ChecksumError) as e:
            for f in self._waiters.values():
                if not f.done():
                    f.set_exception(TransportError(f"connection lost: {e!r}"))
            self._waiters.clear()
        except asyncio.CancelledError:
            pass

    async def call(self, token: int, msg: Any, *, timeout: float = 30.0) -> Any:
        reqid = self._next_id
        self._next_id += 1
        loop = self._loop
        if loop is None:
            loop = self._loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._waiters[reqid] = fut
        # timeout via call_later, NOT asyncio.wait_for: wait_for wraps
        # every call in an extra Task (expensive at wire rates on
        # 3.10); a timer handle is one heap entry, cancelled on the
        # overwhelmingly common fast path
        handle = (
            loop.call_later(timeout, self._expire_call, reqid)
            if timeout is not None
            else None
        )
        try:
            # request framed in the connection's reusable buffer; one
            # writer.write, no intermediate bytes (see _FrameBuffer)
            self._fb.send(
                self._writer, _REQ.pack(KIND_REQUEST, reqid, token), msg=msg
            )
            await self._writer.drain()
            return await fut
        finally:
            if handle is not None:
                handle.cancel()
            # a timed-out / failed call must not leak its waiter entry
            self._waiters.pop(reqid, None)

    def _expire_call(self, reqid: int) -> None:
        fut = self._waiters.pop(reqid, None)
        if fut is not None and not fut.done():
            fut.set_exception(
                asyncio.TimeoutError(f"rpc {reqid} timed out")
            )
