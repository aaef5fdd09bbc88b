"""Metacluster: tenant management across multiple data clusters.

Capability match for fdbclient/Metacluster*.cpp +
MetaclusterManagement.actor.h: one MANAGEMENT cluster stores the
registry of data clusters (capacity, connection info) and the
tenant->cluster assignment; tenant creation picks a data cluster with
free capacity, creates the tenant THERE, and records the assignment in
the management cluster; clients open a tenant by name through the
metacluster and get a handle bound to the right data cluster.

Concurrency/atomicity discipline (the reference's multi-step tenant
states, MetaclusterManagement CreateTenantImpl):

* Load accounting has ONE source of truth — the assignment rows
  themselves, counted inside the SAME transaction that writes a new
  assignment (read conflicts make concurrent creates serialize; no
  counter rows to drift).
* Cross-cluster steps are staged: the assignment is committed in state
  CREATING first, then the tenant is created on the data cluster
  (idempotently), then the assignment flips to READY — a crash between
  steps leaves a CREATING row that the next create/open repairs or
  surfaces, never an orphaned unreachable tenant.
* register_cluster writes the data cluster's registration marker FIRST
  (the double-registration guard must exist before the registry entry
  does); a partial failure is repaired by re-registering under the
  SAME name.

The port's own copy of foundationdb_tpu.cluster.metacluster.
"""

from __future__ import annotations

import json

from foundationdb_tpu_torch.cluster import tenant as T

_CLUSTERS = b"\xff/metacluster/clusters/"
_TENANTS = b"\xff/metacluster/tenants/"
_REGISTRATION = b"\xff/metacluster/registration"

_CREATING = b"\x00creating/"  # assignment-value prefix while staging


class ClusterExists(Exception):
    pass


class ClusterNotFound(Exception):
    pass


class ClusterNotEmpty(Exception):
    pass


class ClusterAlreadyRegistered(Exception):
    pass


class MetaclusterCapacityExceeded(Exception):
    pass


class Metacluster:
    """The management-cluster API. `data_dbs` maps cluster name ->
    Database handle (the reference stores ClusterConnectionString; in
    one process the handle IS the connection)."""

    def __init__(self, management_db):
        self.db = management_db
        self.data_dbs: dict[bytes, object] = {}

    # -- data-cluster registry (MetaclusterManagement register/remove) --

    async def register_cluster(self, name: bytes, data_db,
                               *, capacity: int = 10) -> None:
        # precheck the registry so a NAME COLLISION never writes the
        # marker (a poisoned marker would block the data cluster under
        # every name); the marker then lands before
        # the registry entry (crash between the two re-registers under
        # the SAME name and repairs), and a post-commit ClusterExists
        # rolls the marker back.
        rtxn = data_db.create_transaction()
        existing = await rtxn.get(_REGISTRATION)
        if existing is not None and json.loads(existing)["name"] != (
            name.decode()
        ):
            raise ClusterAlreadyRegistered(
                f"data cluster already registered as "
                f"{json.loads(existing)['name']!r}"
            )
        pre = self.db.create_transaction()
        if await pre.get(_CLUSTERS + name) is not None:
            raise ClusterExists(name)
        if existing is None:
            rtxn.set(
                _REGISTRATION, json.dumps({"name": name.decode()}).encode()
            )
            await rtxn.commit()
        try:
            async def write_registry(txn):
                if await txn.get(_CLUSTERS + name) is not None:
                    raise ClusterExists(name)
                txn.set(
                    _CLUSTERS + name,
                    json.dumps({"capacity": capacity}).encode(),
                )

            # idempotent: a CommitUnknownResult whose commit APPLIED
            # must not re-read its own write and self-ClusterExists
            # (which would roll back a marker that should stand)
            await self.db.run(write_registry, idempotent=True)
        except ClusterExists:
            if existing is None:  # roll the fresh marker back
                rb = data_db.create_transaction()
                rb.clear(_REGISTRATION)
                await rb.commit()
            raise
        self.data_dbs[name] = data_db

    async def remove_cluster(self, name: bytes) -> None:
        async def remove(txn):
            meta = await txn.get(_CLUSTERS + name)
            if meta is None:
                raise ClusterNotFound(name)
            # assignment rows are the truth; the reads add conflict
            # ranges so a racing create_tenant serializes against the
            # removal
            assigned = await txn.get_range(_TENANTS, _TENANTS + b"\xff")
            hosted = [
                k for k, v in assigned
                if v == name or v == _CREATING + name
            ]
            if hosted:
                raise ClusterNotEmpty(
                    f"{name!r} still hosts {len(hosted)} tenants"
                )
            txn.clear(_CLUSTERS + name)

        # idempotent: an applied-but-unknown clear must not retry into
        # a spurious ClusterNotFound that skips the marker cleanup below
        await self.db.run(remove, idempotent=True)
        data_db = self.data_dbs.pop(name, None)
        if data_db is not None:
            rtxn = data_db.create_transaction()
            rtxn.clear(_REGISTRATION)
            await rtxn.commit()

    async def list_clusters(self) -> dict[bytes, dict]:
        txn = self.db.create_transaction()
        rows = await txn.get_range(_CLUSTERS, _CLUSTERS + b"\xff")
        assigned = await txn.get_range(_TENANTS, _TENANTS + b"\xff")
        out = {}
        for k, v in rows:
            cname = k[len(_CLUSTERS):]
            meta = json.loads(v)
            meta["tenants"] = sum(
                1 for _t, c in assigned
                if c == cname or c == _CREATING + cname
            )
            out[cname] = meta
        return out

    # -- tenant management (createTenant through the metacluster) --------

    async def create_tenant(self, name: bytes) -> bytes:
        """Assign the tenant to the least-loaded data cluster with free
        capacity, create it there, record the assignment. Staged:
        CREATING assignment -> data-cluster create -> READY."""
        # phase 1: commit the CREATING assignment. Reads of the
        # registry + every assignment ride THE COMMITTING transaction,
        # so two concurrent creates (or a racing remove_cluster)
        # conflict and serialize; Database.run supplies the standard
        # retry loop (the reference's management ops run under
        # runTransaction too: no hand-rolled weaker retry).
        async def phase1(txn):
            cur = await txn.get(_TENANTS + name)
            if cur is not None and not cur.startswith(_CREATING):
                raise T.TenantExists(name)
            if cur is not None:
                return cur[len(_CREATING):]  # crashed mid-create: repair
            clusters = await txn.get_range(_CLUSTERS, _CLUSTERS + b"\xff")
            assigned = await txn.get_range(_TENANTS, _TENANTS + b"\xff")
            load: dict[bytes, int] = {}
            for _t, c in assigned:
                c = c[len(_CREATING):] if c.startswith(_CREATING) else c
                load[c] = load.get(c, 0) + 1
            candidates = sorted(
                (load.get(k[len(_CLUSTERS):], 0), k[len(_CLUSTERS):])
                for k, v in clusters
                if load.get(k[len(_CLUSTERS):], 0) < json.loads(v)["capacity"]
            )
            if not candidates:
                raise MetaclusterCapacityExceeded(
                    "no data cluster has free tenant capacity"
                )
            chosen = candidates[0][1]
            txn.set(_TENANTS + name, _CREATING + chosen)
            return chosen

        chosen = await self.db.run(phase1)
        # phase 2: create on the data cluster — idempotent: a repair
        # pass finding it already there proceeds to phase 3
        try:
            await T.create_tenant(self.data_dbs[chosen], name)
        except T.TenantExists:
            pass
        # phase 3: flip to READY
        async def phase3(txn):
            txn.set(_TENANTS + name, chosen)

        await self.db.run(phase3)
        return chosen

    async def delete_tenant(self, name: bytes) -> None:
        txn = self.db.create_transaction()
        cname = await txn.get(_TENANTS + name)
        if cname is None:
            raise T.TenantNotFound(name)
        if cname.startswith(_CREATING):
            cname = cname[len(_CREATING):]
        # data-cluster delete FIRST (raises TenantNotEmpty with the
        # assignment intact); tolerate a repair pass where the tenant
        # never finished creating
        try:
            await T.delete_tenant(self.data_dbs[cname], name)
        except T.TenantNotFound:
            pass

        async def clear_assignment(txn):
            # re-read under THIS transaction: the read conflict makes a
            # concurrent delete+re-create abort us instead of the blind
            # clear silently erasing the NEW assignment
            cur = await txn.get(_TENANTS + name)
            if cur == cname or cur == _CREATING + cname:
                txn.clear(_TENANTS + name)

        await self.db.run(clear_assignment)

    async def list_tenants(self) -> dict[bytes, bytes]:
        txn = self.db.create_transaction()
        rows = await txn.get_range(_TENANTS, _TENANTS + b"\xff")
        return {
            k[len(_TENANTS):]: (
                v[len(_CREATING):] if v.startswith(_CREATING) else v
            )
            for k, v in rows
        }

    async def open_tenant(self, name: bytes) -> T.Tenant:
        """A tenant handle bound to its assigned data cluster. A
        CREATING assignment (crash mid-create) is repaired first."""
        txn = self.db.create_transaction()
        cname = await txn.get(_TENANTS + name)
        if cname is None:
            raise T.TenantNotFound(name)
        if cname.startswith(_CREATING):
            try:
                await self.create_tenant(name)  # finish the staged create
            except T.TenantExists:
                pass  # a concurrent repair won the race — equally done
            cname = cname[len(_CREATING):]
        return T.Tenant(self.data_dbs[cname], name)
