"""Cluster assembly: every role wired into one runnable transaction system.

The single-process analog of the reference's simulated cluster
(fdbserver/SimulatedCluster.actor.cpp): Sequencer (master), GrvProxy,
CommitProxies, Resolvers (each wrapping a conflict set: the kernels on the
card, their plain versions on the CPU, or the host oracle), one
TLog, and key-range-sharded StorageServers — connected by the same
version chains the real system uses. The client stack
(cluster/client.py) runs real transactions against it.

Role recruitment order mirrors recovery (fdbserver/ClusterRecovery.
actor.cpp): resolvers get the master's initial batch (prev_version < 0),
tlog/storage start at the recovery version, then proxies open for
business.

The port's own copy of foundationdb_tpu.cluster.database.
"""

from __future__ import annotations

import dataclasses

from foundationdb_tpu_torch.cluster.client import Database
from foundationdb_tpu_torch.cluster.commit_proxy import CommitProxy, KeyPartition
from foundationdb_tpu_torch.cluster.grv_proxy import GrvProxy
from foundationdb_tpu_torch.cluster.sequencer import Sequencer
from foundationdb_tpu_torch.cluster.storage import StorageServer
from foundationdb_tpu_torch.cluster.tlog import TLog
from foundationdb_tpu_torch.config import KernelConfig, TEST_CONFIG
from foundationdb_tpu_torch.models.types import ResolveTransactionBatchRequest
from foundationdb_tpu_torch.resolver import Resolver
from foundationdb_tpu_torch.runtime.flow import Scheduler, all_of


@dataclasses.dataclass
class ClusterConfig:
    n_commit_proxies: int = 1
    n_grv_proxies: int = 1          # v0: one GRV proxy
    n_resolvers: int = 1
    n_storage: int = 2
    # replicas per shard (storage teams); 1 = no replication
    replication_factor: int = 1
    # transaction log replicas (LogSystem); 1 = single log
    n_tlogs: int = 1
    # satellite log replicas (a second failure domain INSIDE the primary
    # region): commits ack only after satellites durably hold the
    # mutation stream, so a whole-primary-DC death loses nothing once a
    # remote region recovers the suffix from them (RPO=0 —
    # ha-write-path.rst + TagPartitionedLogSystem.actor.cpp)
    n_satellite_logs: int = 0
    # coordination quorum size (CoordinatedState/LeaderElection); recovery
    # requires a majority of these alive
    n_coordinators: int = 3
    # optional failure-domain topology: server id -> LocalityData, plus a
    # replication policy (cluster/locality.py) that storage teams must
    # satisfy (PolicyAcross zones/DCs — fdbrpc/ReplicationPolicy.cpp)
    storage_localities: dict = None
    replication_policy: object = None
    # TSS mirror pairs (design/tss.md): TSS i mirrors storage server i
    # for i < n_tss — same log tag, so identical content by
    # construction; clients duplicate a read sample for comparison
    n_tss: int = 0
    # When set, role-to-role calls go through a SimNetwork with this seed
    # (deterministic latency; clogging/partition fault injection).
    sim_seed: int = None
    resolver_boundaries: list = None  # len n_resolvers-1; default even bytes
    storage_boundaries: list = None   # len n_storage-1
    # Versions advance at ~1e6/s of (virtual) time (Sequencer), so the MVCC
    # window must be the reference's time-window equivalent (5s = 5e6
    # versions, fdbclient/ServerKnobs.cpp:43), not the unit-test default.
    # Keys get headroom over the unit-test config (point-write conflict
    # ranges append \x00 to the key).
    kernel_config: KernelConfig = TEST_CONFIG.scaled(
        window_versions=5_000_000, max_key_bytes=16
    )
    # resolver_backend: "cuda" (the port's conflict set, never gated) or
    # "cpu" (host model). Unlike the JAX package's knob default, the
    # cluster never reads SERVER_KNOBS.RESOLVER_BACKEND: it resolves on
    # the card unless the caller asks for the CPU.
    resolver_backend: str = "cuda"
    # where every resolver's conflict set lives: None = the card (a
    # "cuda" backend raises without one); "cpu" runs the plain PyTorch
    # versions of the kernels
    device: str = None
    commit_batch_interval: float = 0.005
    window_versions: int = None      # default: kernel_config.window_versions
    # periodic per-role trace_counters flush cadence (virtual seconds) —
    # the reference's CounterCollection::traceCounters loop, scaled to
    # sim-seed time horizons (the reference default is 5s wall)
    counter_flush_interval: float = 1.0

    def __post_init__(self):
        if self.resolver_backend not in ("cuda", "cpu"):
            raise ValueError(
                f"resolver_backend {self.resolver_backend!r}: "
                "expected 'cuda' or 'cpu'"
            )
        if self.replication_policy is not None:
            if self.storage_localities is None:
                raise ValueError("replication_policy requires storage_localities")
            bad = [s for s in self.storage_localities if not (
                isinstance(s, int) and 0 <= s < self.n_storage)]
            if bad:
                raise ValueError(
                    f"storage_localities ids {bad} out of range for "
                    f"n_storage={self.n_storage}"
                )
            missing = [s for s in range(self.n_storage)
                       if s not in self.storage_localities]
            if missing:
                # teams are built from localities keys; an uncovered
                # server would silently own zero shards forever
                raise ValueError(
                    f"storage_localities missing ids {missing}: every "
                    f"server needs a declared failure domain"
                )
            if self.replication_policy.min_replicas != self.replication_factor:
                raise ValueError(
                    f"replication_factor={self.replication_factor} != "
                    f"policy.min_replicas="
                    f"{self.replication_policy.min_replicas}: team size is "
                    "the policy's — make them agree explicitly"
                )
        if self.replication_factor > self.n_storage:
            raise ValueError(
                f"replication_factor {self.replication_factor} > "
                f"n_storage {self.n_storage}"
            )
        if self.resolver_boundaries is None:
            self.resolver_boundaries = _even_boundaries(self.n_resolvers)
        if self.storage_boundaries is None:
            self.storage_boundaries = _even_boundaries(self.n_storage)
        if self.window_versions is None:
            self.window_versions = self.kernel_config.window_versions


def _even_boundaries(n: int) -> list:
    """n-way even split of the one-byte-prefix keyspace."""
    return [bytes([int(256 * (i + 1) / n)]) for i in range(n - 1)]


class Cluster:
    def __init__(self, sched: Scheduler, config: ClusterConfig = None):
        self.sched = sched
        self.config = config or ClusterConfig()
        cfg = self.config

        from foundationdb_tpu_torch.cluster.shardmap import ShardMap

        self.sequencer = Sequencer(sched)
        self.key_resolvers = KeyPartition(list(cfg.resolver_boundaries))
        self.key_servers = ShardMap.even(
            list(cfg.storage_boundaries),
            replication=cfg.replication_factor,
            n_servers=cfg.n_storage,
            localities=cfg.storage_localities,
            policy=cfg.replication_policy,
        )
        self.resolvers = [
            Resolver(
                sched,
                cfg.kernel_config,
                resolver_id=i,
                resolver_count=cfg.n_resolvers,
                commit_proxy_count=cfg.n_commit_proxies,
                backend=cfg.resolver_backend,
                device=cfg.device,
            )
            for i in range(cfg.n_resolvers)
        ]
        from foundationdb_tpu_torch.cluster.logsystem import LogSystem

        self.tlog = LogSystem(
            sched, cfg.n_tlogs, n_satellites=cfg.n_satellite_logs
        )
        self.storage_servers = [
            StorageServer(
                sched, self.tlog, tag=s, window_versions=cfg.window_versions,
                # per-server byteSample seed, derived from the sim seed:
                # deterministic per (seed, tag), distinct across servers
                sample_seed=((cfg.sim_seed or 0) << 8) ^ s,
            )
            for s in range(cfg.n_storage)
        ]
        # TSS mirrors: same tag as their paired server => the
        # tag-partitioned log delivers them the identical mutation
        # stream (cluster/tss.py; fdbserver/storageserver.actor.cpp TSS)
        self.tss_servers = {
            s: StorageServer(
                sched, self.tlog, tag=s,
                window_versions=cfg.window_versions,
                consumer=f"tss{s}",
            )
            for s in range(cfg.n_tss)
        }
        # failure-monitor view of storage liveness (clients skip dead
        # replicas; see fdbrpc/FailureMonitor.actor.cpp)
        self.storage_live = [True] * cfg.n_storage
        self.txn_state_store: dict[bytes, bytes] = {}

        self.net = None
        if cfg.sim_seed is not None:
            from foundationdb_tpu_torch.sim.network import SimNetwork

            self.net = SimNetwork(sched, seed=cfg.sim_seed)

        from foundationdb_tpu_torch.cluster.coordination import Coordinator

        self.coordinators = [
            Coordinator(f"coord{i}") for i in range(cfg.n_coordinators)
        ]
        # Dynamic-knob quorum registers (fdbserver/ConfigNode.actor.cpp):
        # a SEPARATE generation-disciplined register per coordinator host
        # — the leader-election register above holds the LeaderLease and
        # cannot double as the knob store. Killed/revived with their
        # coordinator (colocated role).
        self.config_nodes = [
            Coordinator(f"confignode{i}") for i in range(cfg.n_coordinators)
        ]

        self.build_proxies(epoch=1)
        from foundationdb_tpu_torch.cluster.balancer import ResolutionBalancer
        from foundationdb_tpu_torch.cluster.ratekeeper import Ratekeeper

        self.balancer = ResolutionBalancer(
            sched, self.resolvers, self.key_resolvers, self.commit_proxies
        )
        # The multi-input admission controller: every saturation sensor
        # the telemetry substrate exposes feeds the control law —
        # tlog queue bytes, storage version lag, resolver occupancy +
        # queue depth, proxy queue depth, and the GRV proxies' observed
        # admission rate. Proxy/GRV lists are SUPPLIERS because recovery
        # rebuilds the proxy generation (build_proxies reassigns).
        self.ratekeeper = Ratekeeper(
            sched, self.sequencer, self.storage_servers,
            liveness=self.storage_live,
            tlog_system=self.tlog,
            resolvers=self.resolvers,
            proxies=lambda: self.commit_proxies,
            grv_proxies=lambda: [self.grv_proxy],
        )
        self.grv_proxy = GrvProxy(sched, self.sequencer, ratekeeper=self.ratekeeper)
        # What clients actually talk to (network-wrapped under simulation).
        self.client_storages = [
            self._wrapped(
                "client", f"storage{s}", ss, ["get_value", "get_key_values"]
            )
            for s, ss in enumerate(self.storage_servers)
        ]
        self.client_tss = {
            s: self._wrapped(
                "client", f"tss{s}", ss, ["get_value", "get_key_values"]
            )
            for s, ss in self.tss_servers.items()
        }
        from foundationdb_tpu_torch.cluster.data_distribution import DataDistributor
        from foundationdb_tpu_torch.cluster.failure_monitor import FailureMonitor
        from foundationdb_tpu_torch.cluster.recovery import ClusterController

        # Address-level failure monitor (fdbrpc/FailureMonitor.actor.cpp):
        # pings every storage endpoint (through the SimNetwork when one
        # exists, so partitions look like death from the controller's
        # vantage) and maintains the shared storage_live view every
        # consumer reads. Client requests that hit a dead process report
        # it immediately (the loadBalance fast path).
        self.failure_monitor = FailureMonitor(sched)
        for s, ss in enumerate(self.storage_servers):
            self.failure_monitor.register(
                f"storage{s}",
                self._wrapped("cc", f"storage{s}", ss, ["ping"]).ping,
            )

        def _on_liveness_change(addr: str, failed: bool) -> None:
            if addr.startswith("storage"):
                self.storage_live[int(addr[len("storage"):])] = not failed

        self.failure_monitor.on_change(_on_liveness_change)
        self.controller = ClusterController(self)
        self.data_distributor = DataDistributor(self)
        self._started = False
        self._next_client_id = 0
        self._metrics_task = None

    async def _trace_counters_loop(self) -> None:
        """Periodic per-role counter flush on the VIRTUAL clock
        (CounterCollection::traceCounters): every role's counters land
        in the active TraceLog as structured events, so a soak or
        wire-pipeline run carries continuous per-role telemetry —
        not just bench.py's end-of-run ledger. Counter values are
        deterministic per (seed, perturb), so traced output stays
        bit-reproducible; wall-clock stage samples deliberately stay
        out of these events (see KernelStageMetrics)."""
        from foundationdb_tpu_torch.utils import trace as _trace

        while True:
            await self.sched.delay(self.config.counter_flush_interval)
            _trace.trace_counters(
                _trace.g_trace, "GrvProxyMetrics", "grv_proxy0",
                self.grv_proxy.counters,
            )
            for p in self.commit_proxies:
                _trace.trace_counters(
                    _trace.g_trace, "ProxyMetrics", p.proxy_id, p.counters
                )
            for r in self.resolvers:
                _trace.trace_counters(
                    _trace.g_trace, "ResolverMetrics",
                    f"resolver{r.resolver_id}", r.counters,
                )
                cs = r.conflict_set
                if cs is not None and getattr(cs, "metrics", None) is not None:
                    _trace.trace_counters(
                        _trace.g_trace, "ResolverKernelMetrics",
                        f"resolver{r.resolver_id}", cs.metrics.counters,
                    )

    def next_client_id(self) -> int:
        """Monotonic per-cluster client-handle id (the idempotency-id
        nonce component — cluster/client.py Database)."""
        self._next_client_id += 1
        return self._next_client_id

    def _wrapped(self, src, dst, obj, methods):
        if self.net is None:
            return obj
        return self.net.wrap(src, dst, obj, methods)

    def build_proxies(self, epoch: int) -> None:
        """(Re)recruit the commit-proxy generation (recovery re-enters)."""
        cfg = self.config
        self.commit_proxies = [
            CommitProxy(
                self.sched,
                f"proxy{p}.{epoch}" if epoch > 1 else f"proxy{p}",
                self.sequencer,
                [
                    self._wrapped(f"proxy{p}", f"resolver{i}", r, ["resolve"])
                    for i, r in enumerate(self.resolvers)
                ],
                self._wrapped(f"proxy{p}", "tlog0", self.tlog, ["commit"]),
                self.key_resolvers,
                self.key_servers,
                epoch=epoch,
                batch_interval=cfg.commit_batch_interval,
                # a batch must fit the kernel's static txn capacity
                max_batch_txns=cfg.kernel_config.max_txns,
                on_state_mutation=self._apply_state_mutation,
                txn_state_view=self.txn_state_store,
            )
            for p in range(cfg.n_commit_proxies)
        ]

    def reboot_storage(self, s: int) -> None:
        """Kill storage server s and bring up a replacement from its durable
        state — the SaveAndKill/restart-test path (SURVEY.md §4): the new
        process resumes pulling the log from its durable version."""
        old = self.storage_servers[s]
        old.stop()
        new = StorageServer(
            self.sched, self.tlog, tag=s,
            window_versions=self.config.window_versions,
            sample_seed=((self.config.sim_seed or 0) << 8) ^ s,
        )
        new.restore(old.snapshot())
        self.storage_servers[s] = new
        self.storage_live[s] = True
        # the replacement process answers pings now; re-point the
        # monitor's probe at it and clear the failure state
        self.failure_monitor.register(
            f"storage{s}",
            self._wrapped("cc", f"storage{s}", new, ["ping"]).ping,
        )
        self.failure_monitor.report_alive(f"storage{s}")
        if self.net is None:
            self.client_storages[s] = new
        else:
            self.client_storages[s] = self.net.wrap(
                "client", f"storage{s}", new, ["get_value", "get_key_values"]
            )
        if self._started:
            new.start()

    def kill_coordinator(self, i: int) -> None:
        # the ConfigNode register is colocated with the coordinator
        # (one host in the reference deployment): it dies with it
        self.coordinators[i].kill()
        self.config_nodes[i].kill()

    def revive_coordinator(self, i: int) -> None:
        self.coordinators[i].revive()
        self.config_nodes[i].revive()

    def kill_tlog(self, i: int) -> None:
        """Mark a log replica dead; commits continue on the survivors."""
        self.tlog.kill(i)

    def crash_reboot_tlog(self, i: int, rng=None) -> None:
        """Power-loss + DiskQueue recovery scan + peer catch-up for one
        log replica (sim disk stack — AsyncFileNonDurable semantics)."""
        self.tlog.crash_and_reboot(i, rng)

    def kill_storage(self, s: int) -> None:
        """Kill a storage server with an immediate failure report (the
        path a client's errored request takes); reads fail over to team
        peers at once."""
        self.storage_servers[s].stop()
        self.failure_monitor.report_failed(f"storage{s}")

    def kill_storage_silent(self, s: int) -> None:
        """Kill a storage server WITHOUT telling anyone: only the
        failure monitor's ping loop (or a client's errored read) can
        discover it — the detection path the reference exercises with
        machine kills (fdbrpc/FailureMonitor.actor.cpp)."""
        self.storage_servers[s].stop()

    def _apply_state_mutation(self, m) -> None:
        from foundationdb_tpu_torch.models.types import apply_state_mutation

        apply_state_mutation(self.txn_state_store, m)

    async def _bootstrap(self) -> None:
        # The master's initial resolver batch (prev_version < 0) — creates
        # the master entry every resolver's proxy map needs.
        futs = []
        for r in self.resolvers:
            futs.append(
                self.sched.spawn(
                    r.resolve(
                        ResolveTransactionBatchRequest(
                            prev_version=-1,
                            version=0,
                            last_received_version=-1,
                            transactions=[],
                        )
                    )
                ).done
            )
        await all_of(futs)

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self.sched.run_until(self.sched.spawn(self._bootstrap()).done)
        for ss in self.storage_servers:
            ss.start()
        for ss in self.tss_servers.values():
            ss.start()
        for cp in self.commit_proxies:
            cp.start()
        self.grv_proxy.start()
        self.ratekeeper.start()
        self.balancer.start()
        self.controller.start()
        self.data_distributor.start()
        self.failure_monitor.start()
        self._metrics_task = self.sched.spawn(
            self._trace_counters_loop(), name="metrics-flush"
        )

    def stop(self) -> None:
        if self._metrics_task is not None:
            self._metrics_task.cancel()
            self._metrics_task = None
        self.failure_monitor.stop()
        self.data_distributor.stop()
        self.controller.stop()
        self.balancer.stop()
        for ss in self.storage_servers:
            ss.stop()
        for ss in self.tss_servers.values():
            ss.stop()
        for cp in self.commit_proxies:
            cp.stop()
        self.grv_proxy.stop()
        self.ratekeeper.stop()
        self._started = False

    def database(self) -> Database:
        return Database(self)


def open_cluster(config: ClusterConfig = None, *, sched: Scheduler = None):
    """Build and start a simulated cluster; returns (sched, cluster, db).

    Its resolvers resolve on the card by default (`resolver_backend`
    "cuda", `device` None; a host without a card raises), on the CPU
    through the plain PyTorch versions when `config.device` is "cpu",
    and on the host oracle when `config.resolver_backend` is "cpu"."""
    sched = sched or Scheduler(sim=True)
    cluster = Cluster(sched, config)
    cluster.start()
    return sched, cluster, cluster.database()
