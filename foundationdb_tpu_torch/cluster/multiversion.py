"""MultiVersion client: protocol negotiation + hot-swap on upgrade.

Capability match for fdbclient/MultiVersionTransaction.actor.cpp + the
multi-version layer of bindings/c/fdb_c.cpp: a client process that may
outlive a cluster upgrade carries SEVERAL client implementations (in
the reference: dynamically loaded libfdb_c versions; here: per-protocol
connection factories), probes which one the cluster speaks, and when
the cluster's protocol CHANGES (upgrade restart), fails outstanding
work with cluster_version_changed — the retryable error the reference
surfaces so transaction loops restart on the freshly selected client —
and reconnects through the newly matching implementation.

The probe mirrors the reference's protocol-version watch
(getClusterProtocol): try the most recent known version first, walk
down on handshake rejection.

The port's own copy of foundationdb_tpu.cluster.multiversion.
"""

from __future__ import annotations

from typing import Callable

from foundationdb_tpu_torch.utils.trace import SEV_WARN, TraceEvent
from foundationdb_tpu_torch.wire import transport


class ClusterVersionChangedError(RuntimeError):
    """error_code_cluster_version_changed: the cluster now speaks a
    different protocol; the operation must retry on the re-selected
    client (MultiVersionTransaction's cluster_version_changed)."""


class MultiVersionClient:
    """Manage one logical connection across protocol versions.

    `versions`: newest-first protocol versions this client ships
    support for. `factory(address, protocol_version)` builds an
    RpcConnection-compatible object (default: the wire transport)."""

    def __init__(self, address, versions: list[int], *,
                 factory: Callable = None, tls=None):
        if not versions:
            raise ValueError("at least one protocol version required")
        self.address = address
        self.versions = list(versions)
        self.tls = tls
        self._factory = factory or (
            lambda addr, pv: transport.RpcConnection(
                addr, tls=tls, protocol_version=pv
            )
        )
        self.conn = None
        self.protocol_version: int | None = None
        self.swaps = 0  # upgrades survived (observability/tests)
        self._connect_lock = None  # single-flight connect (lazy: needs loop)

    async def connect(self, *, retries: int = 20, delay: float = 0.05):
        """Probe supported versions newest-first until one handshakes —
        the reference's protocol discovery. SINGLE-FLIGHT: concurrent
        failed calls reconnect once, not once each (a racing pair would
        overwrite and leak a live connection).
        Returns the connection."""
        import asyncio

        if self._connect_lock is None:
            self._connect_lock = asyncio.Lock()
        async with self._connect_lock:
            if self.conn is not None:
                return self.conn
            return await self._connect_locked(retries, delay)

    async def _connect_locked(self, retries: int, delay: float):
        last = None
        for _ in range(retries):
            for pv in self.versions:
                conn = self._factory(self.address, pv)
                try:
                    await conn.connect(retries=1, delay=delay)
                    if (
                        self.protocol_version is not None
                        and pv != self.protocol_version
                    ):
                        self.swaps += 1
                        TraceEvent(
                            "MultiVersionClientSwapped", severity=SEV_WARN
                        ).detail("From", self.protocol_version).detail(
                            "To", pv
                        ).log()
                    self.conn = conn
                    self.protocol_version = pv
                    return conn
                except transport.TransportError as e:
                    last = e
                    await conn.close()
            import asyncio

            await asyncio.sleep(delay)
        raise transport.TransportError(
            f"no supported protocol version accepted by {self.address} "
            f"(tried {[hex(v) for v in self.versions]}): {last}"
        )

    async def call(self, token: int, msg, *, timeout: float = 30.0):
        """One RPC, AT-MOST-ONCE: a connection loss reconnects (probing
        versions) and then RAISES — ClusterVersionChangedError when the
        cluster moved protocols, TransportError otherwise — rather than
        silently re-sending a request the server may already have
        executed (non-idempotent double-apply). The
        retry decision belongs to the caller's transaction loop, as in
        the reference (MultiVersionTransaction surfaces retryable
        errors to onError)."""
        if self.conn is None:
            await self.connect()
        conn = self.conn
        try:
            return await conn.call(token, msg, timeout=timeout)
        except (transport.TransportError, ConnectionError) as e:
            old_pv = self.protocol_version
            # concurrent calls share the connection and fail together;
            # tear down only the conn THIS call used — by identity, so
            # a second handler never closes the freshly rebuilt one
            if self.conn is conn:
                self.conn = None
                await conn.close()
                await self.connect()  # next call rides the fresh client
            if self.protocol_version != old_pv:
                raise ClusterVersionChangedError(
                    f"cluster protocol moved {old_pv:#x} -> "
                    f"{self.protocol_version:#x}; retry on the new client"
                ) from e
            raise transport.TransportError(
                f"connection to {self.address} lost mid-call; the "
                "request may or may not have executed — caller retries"
            ) from e

    async def close(self):
        if self.conn is not None:
            await self.conn.close()
            self.conn = None
