"""Cluster recovery: rebuild the transaction system in a new generation.

Behavioral mirror of `fdbserver/ClusterRecovery.actor.cpp` +
`ClusterController.actor.cpp` (states in RecoveryState.h:31-41),
compressed to the essentials:

* A ClusterController actor watches the transaction-path roles; any
  commit-proxy failure (our `proxy.failed` latch — the stand-in for
  waitFailure) triggers a full recovery, exactly as in the reference:
  the transaction system is recovered as a unit, never patched.
* Recovery: stop the old generation's proxies/GRV, pick the recovery
  version (the durable log's version — reads stay correct), recruit NEW
  resolvers with EMPTY conflict state (the reference's key fact:
  resolvers are stateless across recoveries, Resolver.actor.cpp builds a
  fresh ConflictSet; correctness holds because in-flight transactions
  with pre-recovery read snapshots are aborted conservatively), recruit
  new proxies at the next epoch, and re-open for business.
* Conservative abort of in-flight txns: the first batch of the new
  generation carries a blind write over the whole keyspace, so any
  transaction whose snapshot predates recovery conflicts — the same
  effect the reference gets from the recovery transaction's version
  bump + lastEpochEnd conflict range (ApplyMetadataMutation /
  CommitProxyServer recovery handling).

Storage servers and the TLog survive recovery untouched (their state is
durable); only the stateless roles are rebuilt.

The port's own copy of foundationdb_tpu.cluster.recovery.
"""

from __future__ import annotations

from foundationdb_tpu_torch.cluster.commit_proxy import CommitProxy
from foundationdb_tpu_torch.cluster.coordination import LeaderElection
from foundationdb_tpu_torch.utils.probes import code_probe, declare

declare("recovery.epoch_lock_failed", "recovery.completed",
        "recovery.leadership_lost")
from foundationdb_tpu_torch.cluster import generation as gen
from foundationdb_tpu_torch.cluster.generation import GenerationState
from foundationdb_tpu_torch.cluster.grv_proxy import GrvProxy
from foundationdb_tpu_torch.cluster.sequencer import Sequencer
from foundationdb_tpu_torch.models.types import ResolveTransactionBatchRequest
from foundationdb_tpu_torch.resolver import Resolver
from foundationdb_tpu_torch.runtime.flow import ActorCancelled, Scheduler, all_of
from foundationdb_tpu_torch.utils.metrics import CounterCollection
from foundationdb_tpu_torch.utils.trace import TraceEvent


class ClusterController:
    """Failure watcher + recovery driver (the CC's recovery loop).

    The generation/epoch state machine is SHARED with the wire cluster
    controller (cluster/generation.py — the wire twin lives in
    cluster/multiprocess.py ClusterControllerRole): same recovery-state
    vocabulary, same recovery-version rule, same conservative-abort
    range, same MasterRecoveryState trace shape — so the sim and wire
    recoveries cannot drift."""

    def __init__(self, cluster, *, check_interval: float = 0.05,
                 cc_id: str = "cc0"):
        self.cluster = cluster
        self.check_interval = check_interval
        self.gen = GenerationState(epoch=1, clock=cluster.sched.now)
        self.counters = CounterCollection("CCMetrics", ["recoveries", "checks"])
        self._task = None
        self._recovering = False
        # Leadership + epoch locks go through the coordination quorum
        # (Coordination.actor.cpp / LeaderElection.actor.cpp): recovery is
        # gated on holding the lease and committing the epoch bump through
        # a majority of coordinators.
        self.elector = LeaderElection(
            cluster.sched, cluster.coordinators, cc_id,
            lease=50 * check_interval,
        )
        self.lease = None

    @property
    def epoch(self) -> int:
        return self.gen.epoch

    @epoch.setter
    def epoch(self, value: int) -> None:
        self.gen.epoch = value

    def start(self) -> None:
        self._task = self.cluster.sched.spawn(
            self._watch(), name="cluster-controller"
        )

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()

    async def _watch(self) -> None:
        try:
            while True:
                await self.cluster.sched.delay(self.check_interval)
                self.counters.add("checks")
                if self._recovering:
                    continue
                # hold (or regain) the leader lease before acting as CC
                if self.lease is None:
                    self.lease = await self.elector.try_become_leader()
                    if self.lease is None:
                        continue  # quorum down or another leader is live
                elif self.lease.expires < self.cluster.sched.now() + \
                        10 * self.check_interval:
                    # _watch is self.lease's only writer: renew()
                    # round-trips the current lease through the elector
                    # with no concurrent mutator to lose an update to
                    self.lease = await self.elector.renew(self.lease)  # flowcheck: ignore[flow.rmw-across-wait]
                    if self.lease is None:
                        code_probe(True, "recovery.leadership_lost")
                        continue  # deposed; must re-win before recovering
                if any(p.failed is not None for p in self.cluster.commit_proxies):
                    await self.recover()
        except ActorCancelled:
            raise

    async def recover(self) -> int:
        """Run one full recovery; returns the new epoch."""
        self._recovering = True
        try:
            cluster = self.cluster
            sched: Scheduler = cluster.sched
            # 0. Epoch lock through the coordination quorum: commit the
            #    bumped epoch (riding the leader lease register) through a
            #    majority BEFORE touching the transaction system. A
            #    deposed CC fails here and must not recover; a minority of
            #    dead coordinators does not block this.
            if self.lease is None:
                self.lease = await self.elector.try_become_leader()
            bumped = None
            if self.lease is not None:
                bumped = await self.elector.bump_epoch(self.lease)
            if bumped is None:
                code_probe(True, "recovery.epoch_lock_failed")
                TraceEvent("RecoveryEpochLockFailed").detail(
                    "Epoch", self.epoch).log()
                self.lease = None
                self._recovering = False
                return self.epoch
            self.lease = bumped
            # the shared state machine: bump to max(epoch+1, quorum
            # epoch) and emit reading_transaction_system_state
            self.gen.begin_recovery(floor=bumped.epoch - 1)
            self.counters.add("recoveries")

            # 1. Stop the old generation and LOCK the log system: pushes
            #    from the old epoch now fail with tlog_stopped, so no old
            #    in-flight batch can slip in a commit after this point
            #    (the reference's coordinated-state lock + tlog epoch
            #    lock). Their clients get commit_unknown_result.
            self.gen.transition(gen.LOCKING_OLD_TRANSACTION_SERVERS)
            for p in cluster.commit_proxies:
                p.stop()
            cluster.grv_proxy.stop()
            cluster.balancer.stop()
            cluster.tlog.lock(self.epoch)

            # 2. Recovery version: strictly above anything the old
            #    generation could have allocated, plus a safety gap
            #    (lastEpochEnd + MAX_VERSIONS_IN_FLIGHT in the reference)
            #    so old and new versions can never collide — the rule is
            #    the shared generation.recovery_version_for.
            recovery_version = gen.recovery_version_for(
                cluster.tlog.version.get(), cluster.sequencer.version
            )
            self.gen.recovery_version = recovery_version
            # Complete the old epoch at the recovery version so the first
            # new-generation push chains (lastEpochEnd).
            cluster.tlog.lock(self.epoch, recovery_version)
            cluster.sequencer = Sequencer(
                sched, recovery_version=recovery_version
            )

            # 3. New resolvers, empty conflict state.
            self.gen.transition(gen.RECRUITING_TRANSACTION_SERVERS,
                                RecoveryVersion=recovery_version)
            cfg = cluster.config
            cluster.resolvers = [
                Resolver(
                    sched,
                    cfg.kernel_config,
                    resolver_id=i,
                    resolver_count=cfg.n_resolvers,
                    commit_proxy_count=cfg.n_commit_proxies,
                    init_version=-1,
                    backend=cfg.resolver_backend,
                    device=cfg.device,
                )
                for i in range(cfg.n_resolvers)
            ]
            boots = [
                sched.spawn(
                    r.resolve(
                        ResolveTransactionBatchRequest(
                            prev_version=-1,
                            version=recovery_version,
                            last_received_version=-1,
                            transactions=[],
                        )
                    )
                ).done
                for r in cluster.resolvers
            ]
            await all_of(boots)

            # 4. Recruit the new generation's proxies and GRV.
            cluster.build_proxies(epoch=self.epoch)
            for p in cluster.commit_proxies:
                p.last_received_version = recovery_version
                # Conservative abort of pre-recovery snapshots: the first
                # batch writes the whole keyspace (the shared range —
                # the wire ProxyRole commits the same write as its
                # recovery transaction).
                p.conservative_writes.append(gen.CONSERVATIVE_ABORT_RANGE)
                p.start()
            cluster.grv_proxy = GrvProxy(
                sched, cluster.sequencer, ratekeeper=cluster.ratekeeper
            )
            cluster.grv_proxy.start()
            cluster.ratekeeper.sequencer = cluster.sequencer
            cluster.balancer.resolvers = cluster.resolvers
            cluster.balancer.commit_proxies = cluster.commit_proxies
            cluster.balancer.start()

            # 5. The recovery transaction: an immediate empty commit
            #    pushes the log (and so every storage server) past the
            #    recovery version — without it, reads at the new read
            #    version would stall until the first client commit
            #    (the reference's recoveryTransactionVersion commit).
            self.gen.transition(gen.RECOVERY_TRANSACTION)
            from foundationdb_tpu_torch.models.types import CommitTransaction

            await cluster.commit_proxies[0].commit(CommitTransaction()).future

            code_probe(True, "recovery.completed")
            self.gen.transition(gen.ACCEPTING_COMMITS)
            self.gen.transition(gen.FULLY_RECOVERED)
            return self.epoch
        finally:
            self._recovering = False
