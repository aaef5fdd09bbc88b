"""Tenants: named, isolated keyspaces.

Behavioral mirror of the reference's tenant support (fdbclient/Tenant.cpp,
TenantManagement.actor.cpp): a tenant is a named prefix allocated in the
system keyspace; transactions opened through a Tenant handle see their
own keyspace (keys transparently prefixed on writes/reads and stripped
on results), and tenant management (create / delete-when-empty / list)
runs as ordinary transactions over `\\xff/tenant/`.

The port's own copy of foundationdb_tpu.cluster.tenant.
"""

from __future__ import annotations

from typing import Optional

TENANT_MAP_PREFIX = b"\xff/tenant/"
TENANT_COUNTER_KEY = b"\xff/tenantCounter"
TENANT_DATA_PREFIX = b"\x1e"  # allocated tenant prefixes live under this


class TenantExists(Exception):
    pass


class TenantNotFound(Exception):
    pass


class TenantNotEmpty(Exception):
    pass


# -- management (TenantManagement.actor.cpp) -------------------------------


async def create_tenant(db, name: bytes) -> bytes:
    """Allocate and record a tenant; returns its prefix."""
    txn = db.create_transaction()
    key = TENANT_MAP_PREFIX + name
    if await txn.get(key) is not None:
        raise TenantExists(name)
    raw = await txn.get(TENANT_COUNTER_KEY)
    n = int.from_bytes(raw, "little") if raw else 0
    txn.set(TENANT_COUNTER_KEY, (n + 1).to_bytes(8, "little"))
    prefix = TENANT_DATA_PREFIX + n.to_bytes(8, "big")
    txn.set(key, prefix)
    await txn.commit()
    return prefix


async def delete_tenant(db, name: bytes) -> None:
    """Delete a tenant; it must be empty (the reference's invariant)."""
    txn = db.create_transaction()
    key = TENANT_MAP_PREFIX + name
    prefix = await txn.get(key)
    if prefix is None:
        raise TenantNotFound(name)
    if await txn.get_range(prefix, prefix + b"\xff", limit=1):
        raise TenantNotEmpty(name)
    txn.clear(key)
    await txn.commit()


async def list_tenants(db) -> list[bytes]:
    txn = db.create_transaction()
    items = await txn.get_range(TENANT_MAP_PREFIX, TENANT_MAP_PREFIX + b"\xff")
    return [k[len(TENANT_MAP_PREFIX):] for k, _ in items]


# -- the tenant handle -----------------------------------------------------


class Tenant:
    """Database-like handle scoped to one tenant's keyspace.

    With authorization enabled on the cluster (a token verifier on
    cluster.token_verifier, crypto/token_sign.TokenVerifier), every
    transaction against the tenant requires a signed token granting
    this tenant — the reference's tenant authorization
    (design/authorization.md, fdbrpc/TokenSign): no token, an expired
    one, or one naming other tenants is permission_denied before any
    key resolves."""

    def __init__(self, db, name: bytes, *, token: bytes = None):
        self.db = db
        self.name = name
        self.token = token
        self._prefix: Optional[bytes] = None

    def _authorize(self) -> None:
        verifier = getattr(
            getattr(self.db, "cluster", None), "token_verifier", None
        )
        if verifier is not None:
            # expiry against the SCHEDULER clock, not wall time: under
            # deterministic simulation a wall-clock comparison would
            # make token expiry nondeterministic across re-runs
            verifier.check(self.token, self.name, now=self.db.sched.now())

    async def _resolve(self) -> bytes:
        self._authorize()
        if self._prefix is None:
            txn = self.db.create_transaction()
            prefix = await txn.get(TENANT_MAP_PREFIX + self.name)
            if prefix is None:
                raise TenantNotFound(self.name)
            self._prefix = prefix
        return self._prefix

    def create_transaction(self) -> "TenantTransaction":
        self._authorize()
        return TenantTransaction(self, self.db.create_transaction())

    async def run(self, fn, **kw):
        async def wrapped(txn):
            return await fn(TenantTransaction(self, txn))

        return await self.db.run(wrapped, **kw)


class TenantTransaction:
    """A Transaction whose keys live under the tenant prefix."""

    def __init__(self, tenant: Tenant, txn):
        self._tenant = tenant
        self._txn = txn

    async def _k(self, key: bytes) -> bytes:
        return await self._tenant._resolve() + key

    async def get(self, key: bytes, **kw):
        return await self._txn.get(await self._k(key), **kw)

    async def get_range(self, begin: bytes, end: bytes, **kw):
        p = await self._tenant._resolve()
        items = await self._txn.get_range(p + begin, p + end, **kw)
        return [(k[len(p):], v) for k, v in items]

    async def set(self, key: bytes, value: bytes) -> None:
        self._txn.set(await self._k(key), value)

    async def clear(self, key: bytes) -> None:
        self._txn.clear(await self._k(key))

    async def clear_range(self, begin: bytes, end: bytes) -> None:
        p = await self._tenant._resolve()
        self._txn.clear_range(p + begin, p + end)

    async def atomic_op(self, op: str, key: bytes, param: bytes) -> None:
        self._txn.atomic_op(op, await self._k(key), param)

    async def watch(self, key: bytes):
        return await self._txn.watch(await self._k(key))

    async def commit(self) -> int:
        return await self._txn.commit()

    @property
    def committed_version(self):
        return self._txn.committed_version
