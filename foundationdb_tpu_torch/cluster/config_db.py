"""Dynamic knob configuration: versioned overrides broadcast to roles.

Behavioral mirror of the reference's dynamic-knobs subsystem
(design/dynamic-knobs.md; fdbserver/ConfigNode.actor.cpp +
PaxosConfigConsumer.actor.cpp + ConfigBroadcaster.actor.cpp +
LocalConfiguration.actor.cpp), using this build's own primitives:

* The AUTHORITATIVE override set lives on the coordinators through
  CoordinatedState (PaxosConfigStore below) — the reference's ConfigNode
  quorum. Knob data therefore survives coordinator minority loss and
  does not depend on the data plane (tlogs/storage) being recoverable.
* Each committed change is then broadcast by writing the overrides into
  the `\\xff/conf/` keyspace and bumping a generation key; every
  process's LocalConfiguration watches the generation key and re-applies
  the full override set to its live Knobs object when it changes — roles
  see knob changes without restarts, in commit order (the
  ConfigBroadcaster push path).
* After a data-plane wipe/recovery, `restore_broadcast` re-seeds the
  keyspace from the quorum (PaxosConfigConsumer catching a broadcaster
  up from the ConfigNodes).
"""

from __future__ import annotations

from foundationdb_tpu_torch.runtime.flow import ActorCancelled, Scheduler
from foundationdb_tpu_torch.utils.knobs import Knobs
from foundationdb_tpu_torch.utils.probes import code_probe, declare

declare(
    "config.quorum_write",
    "config.quorum_write_raced",
    "config.quorum_write_retried",
    "config.restored_from_quorum",
)

CONF_PREFIX = b"\xff/conf/"
CONF_GENERATION = b"\xff/confGeneration"
#: quorum generation of the last broadcast landed in the keyspace —
#: orders racing broadcasts (see _broadcast)
CONF_QUORUM_GEN = b"\xff/confQuorumGeneration"


class PaxosConfigStore:
    """Quorum-held knob overrides (fdbserver/ConfigNode.actor.cpp).

    The value in CoordinatedState is {"generation": int, "overrides":
    {name: repr(value)}}. Mutations are read-modify-write rounds;
    StaleGeneration (a racing writer / deposed generation) retries with
    a fresh read, exactly like PaxosConfigTransaction's commit loop.
    """

    RETRIES = 8
    #: transient-outage budget: a coordinator majority may be down for a
    #: recovery window; the soak kills majorities for ~0.8s virtual, so
    #: the capped-exponential backoff sum (~12s) rides it out easily
    QUORUM_RETRIES = 12
    QUORUM_BACKOFF = 0.05
    QUORUM_BACKOFF_MAX = 2.0

    def __init__(self, sched, coordinators, client_id: str = "config"):
        from foundationdb_tpu_torch.cluster.coordination import CoordinatedState

        self._sched = sched
        self._cs = CoordinatedState(sched, coordinators, client_id)

    async def snapshot(self) -> tuple[int, dict]:
        val = await self._cs.read()
        if not val:
            return 0, {}
        return val["generation"], dict(val["overrides"])

    async def _mutate(self, fn) -> tuple[int, dict]:
        from foundationdb_tpu_torch.cluster.coordination import (
            QuorumUnreachable,
            StaleGeneration,
        )

        # Two independent retry budgets: RMW races (StaleGeneration —
        # another writer won, retry immediately with a fresh read) and
        # transient quorum outages (QuorumUnreachable — a coordinator
        # majority is down, back off and wait for revival). An earlier
        # soak let the second escape the actor entirely: 264 unhandled
        # `config_db.set` tracebacks across 2000 seeds, zero failures —
        # the class the scheduler's unhandled-error ledger now makes
        # loud.
        stale_attempts = 0
        quorum_attempts = 0
        backoff = self.QUORUM_BACKOFF
        while True:
            try:
                gen, overrides = await self.snapshot()
                fn(overrides)
                # a real client pays at least a network round between its
                # read and its write; the in-process Coordinator stubs never
                # suspend, so without this yield two RMW rounds could never
                # interleave and the raced path would be unreachable in sim
                await self._sched.delay(0)
                await self._cs.write(
                    {"generation": gen + 1, "overrides": overrides}
                )
            except StaleGeneration:
                code_probe(True, "config.quorum_write_raced")
                stale_attempts += 1
                if stale_attempts >= self.RETRIES:
                    raise StaleGeneration(
                        "knob write outran %d times" % self.RETRIES
                    )
                continue
            except QuorumUnreachable:
                quorum_attempts += 1
                if quorum_attempts >= self.QUORUM_RETRIES:
                    raise  # outage outlived the budget: fail loudly
                code_probe(True, "config.quorum_write_retried")
                await self._sched.delay(backoff)
                backoff = min(backoff * 2, self.QUORUM_BACKOFF_MAX)
                continue
            code_probe(True, "config.quorum_write")
            return gen + 1, overrides

    async def set(self, name: str, raw: bytes) -> tuple[int, dict]:
        return await self._mutate(lambda o: o.__setitem__(name, raw))

    async def clear(self, name: str) -> tuple[int, dict]:
        return await self._mutate(lambda o: o.pop(name, None))


def _quorum_store(db) -> "PaxosConfigStore | None":
    cluster = getattr(db, "cluster", None)
    if cluster is None or not getattr(cluster, "config_nodes", None):
        return None
    store = getattr(cluster, "_config_store", None)
    if store is None:
        store = PaxosConfigStore(cluster.sched, cluster.config_nodes)
        cluster._config_store = store
    return store


async def _broadcast(db, gen: int, overrides: dict, *,
                     force: bool = False) -> None:
    """Commit the FULL override set into `\\xff/conf/` + bump the
    generation key (the ConfigBroadcaster push: watchers re-apply).

    Ordered by the QUORUM generation: the snapshot read of
    CONF_QUORUM_GEN is a conflict range, so two racing broadcasts
    serialize — the one carrying the older quorum state either aborts
    and re-reads or sees a newer stored generation and stands down.
    Without this, a slower writer's clear_range+rewrite could land
    AFTER a newer one and silently un-apply an acked knob cluster-wide.
    """
    from foundationdb_tpu_torch.cluster.commit_proxy import NotCommitted

    for _attempt in range(8):
        txn = db.create_transaction()
        cur_raw = await txn.get(CONF_QUORUM_GEN)
        cur = int.from_bytes(cur_raw, "big") if cur_raw else 0
        if cur >= gen and not force:
            return  # a broadcast at least this new already landed
        txn.clear_range(CONF_PREFIX, CONF_PREFIX + b"\xff")
        for name, raw in overrides.items():
            txn.set(CONF_PREFIX + name.encode(), raw)
        txn.set(CONF_QUORUM_GEN, gen.to_bytes(8, "big"))
        txn.add(CONF_GENERATION, 1)
        try:
            await txn.commit()
            return
        except NotCommitted:
            continue  # raced: re-read the stored generation
    raise NotCommitted("knob broadcast raced out 8 times")


async def set_knob(db, name: str, value) -> None:
    """Commit one knob override (fdbcli `setknob`): quorum first —
    the write is durable once the coordinators accept it — then the
    keyspace broadcast."""
    store = _quorum_store(db)
    if store is None:  # no coordinators (bare DB): keyspace only
        txn = db.create_transaction()
        txn.set(CONF_PREFIX + name.encode(), repr(value).encode())
        txn.add(CONF_GENERATION, 1)
        await txn.commit()
        return
    gen, overrides = await store.set(name, repr(value).encode())
    await _broadcast(db, gen, overrides)


async def clear_knob(db, name: str) -> None:
    store = _quorum_store(db)
    if store is None:
        txn = db.create_transaction()
        txn.clear(CONF_PREFIX + name.encode())
        txn.add(CONF_GENERATION, 1)
        await txn.commit()
        return
    gen, overrides = await store.clear(name)
    await _broadcast(db, gen, overrides)


async def restore_broadcast(db) -> dict:
    """Re-seed `\\xff/conf/` from the coordinator quorum — the recovery
    path after data-plane loss (the broadcaster's snapshot-from-
    ConfigNodes catch-up). Returns the restored overrides."""
    store = _quorum_store(db)
    if store is None:
        return {}
    gen, overrides = await store.snapshot()
    code_probe(bool(overrides), "config.restored_from_quorum")
    # force: the keyspace copy may have been wiped while the stored
    # CONF_QUORUM_GEN survived (partial loss) — restore must overwrite
    # regardless; the read still serializes racing broadcasts
    await _broadcast(db, gen, overrides, force=True)
    return await read_overrides(db)


async def read_overrides(db, txn=None) -> dict[str, object]:
    # pass `txn` to read at ITS read version (LocalConfiguration.refresh
    # reads overrides + generation in one transaction)
    if txn is None:
        txn = db.create_transaction()
    items = await txn.get_range(CONF_PREFIX, CONF_PREFIX + b"\xff")
    import ast

    return {
        k[len(CONF_PREFIX):].decode(): ast.literal_eval(v.decode())
        for k, v in items
    }


class LocalConfiguration:
    """Per-process knob view: defaults + broadcast overrides
    (LocalConfiguration.actor.cpp)."""

    def __init__(self, db, knobs: Knobs):
        self.db = db
        self.knobs = knobs
        self.generation = 0
        self._task = None

    def start(self) -> None:
        self._task = self.db.sched.spawn(self._watch(), name="local-config")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()

    async def refresh(self) -> None:
        # overrides and generation read in ONE transaction (one read
        # version): self.generation is exactly the generation of the
        # override set just applied, so the watch loop's gen compare
        # can detect any commit this refresh missed
        txn = self.db.create_transaction()
        overrides = await read_overrides(self.db, txn=txn)
        raw = await txn.get(CONF_GENERATION, snapshot=True)
        self.knobs.reset()
        for name, value in overrides.items():
            try:
                self.knobs.set(name, value)
            except KeyError:
                pass  # unknown knob: ignored, as the reference does
        self.generation = int.from_bytes(raw or b"\0" * 8, "little")

    async def _watch(self) -> None:
        try:
            await self.refresh()
            while True:
                # read-compare-then-watch, all at ONE read version: a
                # generation bump BETWEEN the last refresh's read
                # version and this transaction's is caught by the
                # compare (refresh again, no watch armed); a bump AFTER
                # this read version fires the watch, whose expected
                # value was read at the same version. The old
                # arm-without-comparing loop silently lost any commit
                # landing in the refresh->watch window until the NEXT
                # bump — exposed when adaptive batching shifted
                # GRV/commit timing in the sims.
                txn = self.db.create_transaction()
                raw = await txn.get(CONF_GENERATION, snapshot=True)
                gen = int.from_bytes(raw or b"\0" * 8, "little")
                if gen != self.generation:
                    await self.refresh()
                    continue
                fut = await txn.watch(CONF_GENERATION)
                await fut
                await self.refresh()
        except ActorCancelled:
            raise
