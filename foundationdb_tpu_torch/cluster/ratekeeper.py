"""Ratekeeper: cluster-wide admission control.

Behavioral mirror of `fdbserver/Ratekeeper.actor.cpp`: a control loop
samples the health of the whole write pipeline and computes a
transactions-per-second budget; GRV proxies fetch the budget
(`GetRateInfoRequest`, served at :475) and release read versions no
faster than that, which throttles new transactions at the front door —
the one place a transaction can be delayed without violating MVCC.

The control law is the reference's multi-input shape, consuming the
saturation sensors end to end:

* per-tlog smoothed queue bytes vs `TLOG_QUEUE_BYTES_TARGET`
  (TLogQueueInfo -> limitReason log_server_write_queue),
* per-storage version lag vs the MVCC window (StorageQueueInfo ->
  storage_server_durability_lag),
* per-resolver busy fraction (the occupancy Smoother over compute
  seconds — resolver_busy) and version-chain queue depth
  (resolver_queue),
* per-commit-proxy queued requests (commit_proxy_queue).

Each limiter derives a TPS limit; the budget is the MIN across
limiters, the binding limiter is named with the SAME reason vocabulary
as the status section's `performance_limited_by`
(cluster/status.py QOS_REASONS), and budget movement is smoothed with
hysteresis (engage past target, release only below `release_frac` of
target; multiplicative decrease, bounded increase) so the loop cannot
flap between full speed and clamp across a noisy sensor.

Robustness contract: the loop itself fails SAFE. A stale sensor feed
(`sensor dropout`) decays the budget toward a conservative floor
(`failsafe_tps`) instead of freezing at full speed; an all-dead storage
set clamps to `min_tps` (a cluster with zero live replicas must not
admit at `max_tps` because its dead sensors read zero lag); and the
CONSUMERS (sim GrvProxy, wire ProxyPipeline) apply the same decay when
the Ratekeeper itself dies or stops answering — see
`GrvProxy._starter` and `ProxyPipeline._rate_fetcher`.

The pure law lives in `AdmissionController` so the sim `Ratekeeper`
(direct object sensors) and the wire `RatekeeperRole`
(cluster/multiprocess.py, StatusRequest-polled sensors) share one
implementation.

The port's own copy of foundationdb_tpu.cluster.ratekeeper.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

from foundationdb_tpu_torch.cluster.status import (
    PROXY_QUEUE_TARGET,
    RESOLVER_QUEUE_TARGET,
    TLOG_QUEUE_BYTES_TARGET,
)
from foundationdb_tpu_torch.runtime.flow import ActorCancelled, Scheduler
from foundationdb_tpu_torch.utils.metrics import CounterCollection, Smoother
from foundationdb_tpu_torch.utils.probes import code_probe, declare

declare(
    "ratekeeper.throttled",
    "ratekeeper.auto_tag_throttled",
    "ratekeeper.auto_tag_lifted",
    "ratekeeper.failsafe",
)

#: resolver busy-fraction (occupancy Smoother) at which resolution is
#: the limiter; 1.0 == compute occupies the entire wall clock
RESOLVER_BUSY_TARGET = 0.85

#: e-folding time of the fail-safe budget decay — ONE constant for all
#: three decay paths (the law's own stale-feed decay, the sim
#: GrvProxy's dead-ratekeeper decay, the wire ProxyPipeline's
#: fetch-failure decay; the wire consumer receives it in the
#: GetRateInfo payload so tuning the law tunes every consumer)
FAILSAFE_TAU = 0.5


class AdmissionController:
    """The multi-input admission-control law, deployment-agnostic.

    `update(slots, current_tps=...)` consumes one reading of the
    cluster's qos sensor blocks (the same per-role `saturation()` dicts
    `cluster/status.qos_pressures` scores) and moves the budget;
    `decay(...)` is the fail-safe direction for a stale feed. State:
    the smoothed budget, the per-reason hysteresis engagement set, and
    the binding-limiter attribution (`limited_by`, one vocabulary with
    status `performance_limited_by`).
    """

    def __init__(
        self,
        *,
        clock: Callable[[], float],
        max_tps: float = 1e7,
        min_tps: float = 10.0,
        lag_target: float = 2_000_000.0,   # versions (~2s)
        lag_limit: float = 4_500_000.0,    # near the 5s MVCC window
        tlog_queue_target: float = float(TLOG_QUEUE_BYTES_TARGET),
        resolver_busy_target: float = RESOLVER_BUSY_TARGET,
        resolver_queue_target: float = float(RESOLVER_QUEUE_TARGET),
        proxy_queue_target: float = float(PROXY_QUEUE_TARGET),
        release_frac: float = 0.8,
        growth_factor: float = 2.0,
        failsafe_tps: float = None,
        failsafe_tau: float = FAILSAFE_TAU,
    ):
        self.clock = clock
        self.max_tps = max_tps
        self.min_tps = min_tps
        self.lag_target = lag_target
        self.lag_limit = lag_limit
        self.tlog_queue_target = tlog_queue_target
        self.resolver_busy_target = resolver_busy_target
        self.resolver_queue_target = resolver_queue_target
        self.proxy_queue_target = proxy_queue_target
        #: hysteresis: a limiter engages at pressure >= 1.0 and releases
        #: only once pressure drops below release_frac — oscillation
        #: across the target boundary cannot flap the budget
        self.release_frac = release_frac
        self.growth_factor = growth_factor
        #: the conservative fail-safe floor the budget decays toward
        #: when the sensor feed is stale (never below min_tps, never a
        #: full-speed freeze)
        self.failsafe_tps = (
            failsafe_tps
            if failsafe_tps is not None
            else max(min_tps, max_tps * 1e-3)
        )
        self.failsafe_tau = failsafe_tau
        self.tps_budget = max_tps
        #: engaged limiters (hysteresis state), keyed by reason id
        self._engaged: set[str] = set()
        self.limited_by = {
            "name": "workload",
            "reason_server_id": "",
            "tps_limit": max_tps,
        }
        #: consecutive control intervals the SAME limiter has been
        #: binding — the elasticity trigger's input (a
        #: resolver_busy streak past the controller's threshold recruits
        #: another resolver; one counter in the law so sim and wire
        #: consumers read the identical signal). "workload" streaks are
        #: tracked too (they read as "nothing is binding for N
        #: intervals" — the scale-down signal nothing spends yet).
        self.binding_streak = {"name": "workload", "intervals": 0}
        self.stale = False
        self._decay_from = clock()

    # -- limiter scoring ---------------------------------------------------

    def _hard_limit(self, value: float, target: float, limit: float) -> bool:
        return limit > target and value >= limit

    def _candidates(self, slots: dict) -> list[tuple[str, str, float, float]]:
        """(reason, process, value, target) per sensor reading — the
        same (process, reason, score) shape status.qos_pressures emits,
        with the raw value kept so the hard-clamp check can compare
        against an absolute limit (storage lag vs the MVCC window)."""
        out = []
        for name, q in (slots.get("tlogs") or {}).items():
            out.append((
                "log_server_write_queue", name,
                float(q.get("smoothed_queue_bytes", 0.0)),
                self.tlog_queue_target,
            ))
        for name, q in (slots.get("storages") or {}).items():
            out.append((
                "storage_server_durability_lag", name,
                float(q.get("version_lag_versions",
                            q.get("apply_lag_versions", 0))),
                self.lag_target,
            ))
        for name, q in (slots.get("resolvers") or {}).items():
            out.append((
                "resolver_busy", name,
                float(q.get("occupancy", 0.0)),
                self.resolver_busy_target,
            ))
            out.append((
                "resolver_queue", name,
                float(q.get("queue_depth", 0)),
                self.resolver_queue_target,
            ))
        for name, q in (slots.get("proxies") or {}).items():
            out.append((
                "commit_proxy_queue", name,
                float(q.get("queued_requests", 0)),
                self.proxy_queue_target,
            ))
        return out

    # -- the control step --------------------------------------------------

    def update(
        self,
        slots: Optional[dict],
        *,
        current_tps: float = 0.0,
        live_storage: Optional[int] = None,
    ) -> float:
        """One control interval: score every limiter, move the budget.

        `slots` is {"tlogs"/"storages"/"resolvers"/"proxies": {name:
        qos block}} or None for a stale/absent sensor feed (fail-safe).
        `current_tps` is the observed admission rate (the GRV proxies'
        released txn/s) — the base the multiplicative decrease scales,
        the reference's actualTps. `live_storage` (when known) guards
        the all-dead case: zero live replicas is a fail-safe clamp, not
        a zero-lag green light.
        """
        now = self.clock()
        if slots is None:
            return self._decay_locked(now)
        self._decay_from = now
        if live_storage is not None and live_storage == 0:
            # every storage replica dead: worst_lag over an empty live
            # set reads 0.0, which the old law took as "healthy" and
            # admitted at max_tps — an all-dead cluster must clamp to
            # the floor until a replica reports back (fail-safe)
            self.stale = False
            self._engaged.add("ratekeeper_failsafe")
            self.tps_budget = self.min_tps
            self.limited_by = {
                "name": "ratekeeper_failsafe",
                "reason_server_id": "",
                "tps_limit": self.min_tps,
            }
            self._note_binding("ratekeeper_failsafe")
            code_probe(True, "ratekeeper.failsafe")
            return self.tps_budget
        self.stale = False
        self._engaged.discard("ratekeeper_failsafe")

        base = min(self.tps_budget, max(current_tps, self.min_tps))
        raw = self.max_tps
        binding = ("workload", "", self.max_tps)
        for reason, proc, value, target in self._candidates(slots):
            if target <= 0:
                continue
            pressure = value / target
            hard = (
                reason == "storage_server_durability_lag"
                and self._hard_limit(value, self.lag_target, self.lag_limit)
            )
            # hysteresis state is per (reason, PROCESS): one healthy
            # tlog must not release the engagement its overloaded peer
            # holds in the band between release_frac and the target
            key = f"{reason}@{proc}"
            if pressure >= 1.0 or hard:
                self._engaged.add(key)
            elif pressure < self.release_frac:
                self._engaged.discard(key)
            if key not in self._engaged:
                continue
            if hard:
                limit = self.min_tps
            else:
                # multiplicative: scale the observed admission rate by
                # the overshoot (the reference's queue-model form:
                # limitTps ~ actualTps * target/actual); while engaged
                # below target this drifts the budget UP gently
                # (factor > 1) instead of snapping to full speed
                limit = max(
                    self.min_tps,
                    base * min(self.growth_factor, 1.0 / max(pressure, 0.5)),
                )
            if limit < raw:
                raw = limit
                binding = (reason, proc, limit)
        if raw < self.tps_budget:
            # throttle fast: the budget drops to the binding limit at
            # once (queues are already over target)
            self.tps_budget = max(self.min_tps, raw)
        else:
            # recover MULTIPLICATIVELY (anti-windup is bounded, not
            # instant): at most growth_factor x per interval, so
            # release after a long clamp doubles back toward capacity
            # instead of leaping to max_tps and re-collapsing — full
            # speed returns within ~log2(max/min) intervals (~20 for
            # the defaults) once every limiter releases
            self.tps_budget = min(
                raw,
                self.max_tps,
                self.tps_budget * self.growth_factor + self.min_tps,
            )
        if self.tps_budget >= self.max_tps:
            binding = ("workload", "", self.max_tps)
        self.limited_by = {
            "name": binding[0],
            "reason_server_id": binding[1],
            "tps_limit": binding[2],
        }
        self._note_binding(binding[0])
        return self.tps_budget

    def _note_binding(self, name: str) -> None:
        """Advance the binding-limiter streak: +1 while the same reason
        stays binding, reset to 1 on a change. Streaks key on the
        REASON only (not the process): two saturated resolvers trading
        the worst-occupancy crown are one continuous resolver_busy
        signal, which is exactly when recruiting another helps."""
        if self.binding_streak["name"] == name:
            self.binding_streak["intervals"] += 1
        else:
            self.binding_streak = {"name": name, "intervals": 1}

    def _decay_locked(self, now: float) -> float:
        dt = max(0.0, now - self._decay_from)
        self._decay_from = now
        if self.tps_budget > self.failsafe_tps:
            self.tps_budget = max(
                self.failsafe_tps,
                self.tps_budget * math.exp(-dt / self.failsafe_tau),
            )
        self.stale = True
        self.limited_by = {
            "name": "ratekeeper_failsafe",
            "reason_server_id": "",
            "tps_limit": self.tps_budget,
        }
        # a stale feed interrupts whatever streak was building: the
        # elasticity trigger must never recruit off dead sensors
        self._note_binding("ratekeeper_failsafe")
        code_probe(True, "ratekeeper.failsafe")
        return self.tps_budget

    def decay(self) -> float:
        """Fail-safe: no (fresh) sensors this interval — the budget
        decays toward the conservative floor instead of freezing at its
        last (possibly full-speed) value."""
        return self._decay_locked(self.clock())

    def rate_info(self) -> dict:
        """The GetRateInfo reply payload (sim and wire share it)."""
        return {
            "transactions_per_second_limit": self.tps_budget,
            "budget_limited_by": dict(self.limited_by),
            "binding_streak": dict(self.binding_streak),
            "budget_stale": self.stale,
            "failsafe_tps": self.failsafe_tps,
            "failsafe_tau": self.failsafe_tau,
            "max_tps": self.max_tps,
            "min_tps": self.min_tps,
        }


class Ratekeeper:
    def __init__(
        self,
        sched: Scheduler,
        sequencer,
        storage_servers: list,
        *,
        interval: float = 0.25,
        lag_target: float = 2_000_000,   # versions (~2s)
        lag_limit: float = 4_500_000,    # near the 5s MVCC window: hard clamp
        max_tps: float = 1e7,
        min_tps: float = 10.0,
        liveness: list = None,  # shared storage_live list (or None = all live)
        tlog_system=None,        # cluster LogSystem (queue-bytes sensors)
        resolvers: list = None,  # Resolver objects (occupancy sensors)
        proxies: Callable[[], list] = None,  # live commit-proxy list supplier
        grv_proxies: Callable[[], list] = None,  # admission-rate source
    ):
        self.sched = sched
        self.sequencer = sequencer
        self.storage_servers = storage_servers
        self.liveness = liveness
        self.interval = interval
        self.law = AdmissionController(
            clock=sched.now,
            max_tps=max_tps,
            min_tps=min_tps,
            lag_target=lag_target,
            lag_limit=lag_limit,
        )
        self.tlog_system = tlog_system
        self.resolvers = resolvers or []
        self._proxies = proxies or (lambda: [])
        self._grv_proxies = grv_proxies or (lambda: [])
        #: fault hook (sensor_dropout scenarios): True makes the loop's
        #: sensor read return None, so the fail-safe decay engages
        self.sensor_dropout = False
        #: virtual-clock timestamp of the last completed control loop —
        #: consumers (GrvProxy) treat an old value as a dead/flapping
        #: Ratekeeper and decay their budget toward the fail-safe floor
        self.last_loop_time = sched.now()
        self.counters = CounterCollection("RkMetrics", ["loops", "throttled"])
        # smoothed observed admission rate (GRV released txn/s) — the
        # law's actualTps input
        self._admit_smoother = Smoother(2.0 * interval, clock=sched.now)
        self._admit_last = 0
        # GlobalTagThrottler: per-transaction-tag TPS quotas. Two tiers,
        # like the reference (fdbserver/GlobalTagThrottler.actor.cpp):
        # MANAGEMENT quotas (set_tag_quota) and AUTO quotas derived from
        # observed busyness — when the pipeline is stressed (lag past
        # target), a tag dominating admissions gets throttled to its
        # fair share scaled by the stress factor; healthy intervals
        # relax the auto quota back until it lifts. Enforcement stays at
        # the GRV proxies; get_tag_quota returns the tighter tier.
        self.tag_quotas: dict[str, float] = {}
        self.auto_tag_quotas: dict[str, float] = {}
        #: a tag is "dominant" past this share of interval admissions
        self.auto_throttle_share = 0.4
        self.min_tag_tps = 1.0
        self._tag_admissions: dict[str, int] = {}
        self._task = None

    # law-config passthroughs: existing consumers (soak's slow_storage
    # scenario, tests) tune rk.lag_target / rk.max_tps directly
    @property
    def lag_target(self) -> float:
        return self.law.lag_target

    @lag_target.setter
    def lag_target(self, v: float) -> None:
        self.law.lag_target = v

    @property
    def lag_limit(self) -> float:
        return self.law.lag_limit

    @lag_limit.setter
    def lag_limit(self, v: float) -> None:
        self.law.lag_limit = v

    @property
    def max_tps(self) -> float:
        return self.law.max_tps

    @max_tps.setter
    def max_tps(self, v: float) -> None:
        self.law.max_tps = v

    @property
    def min_tps(self) -> float:
        return self.law.min_tps

    @min_tps.setter
    def min_tps(self, v: float) -> None:
        self.law.min_tps = v

    @property
    def failsafe_tps(self) -> float:
        return self.law.failsafe_tps

    @property
    def failsafe_tau(self) -> float:
        return self.law.failsafe_tau

    @property
    def tps_budget(self) -> float:
        return self.law.tps_budget

    @tps_budget.setter
    def tps_budget(self, v: float) -> None:
        self.law.tps_budget = v

    def start(self) -> None:
        self._task = self.sched.spawn(self._loop(), name="ratekeeper")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def worst_lag(self) -> float:
        # dead replicas don't count: their frozen versions would throttle
        # the cluster forever (the reference excludes failed servers from
        # rate computation the same way). The all-dead direction is NOT
        # handled here — an empty live set returns 0.0, which the law
        # must treat as fail-safe, never as "no lag" (see update()).
        head = self.sequencer.live_committed.get()
        return max(
            (
                head - ss.version.get()
                for i, ss in enumerate(self.storage_servers)
                if self.liveness is None or self.liveness[i]
            ),
            default=0.0,
        )

    def _live_storage_count(self) -> Optional[int]:
        if self.liveness is None:
            return None
        return sum(1 for alive in self.liveness if alive)

    def get_rate_info(self) -> float:
        """GetRateInfoRequest: the current per-second txn budget."""
        return self.law.tps_budget

    def rate_info(self) -> dict:
        """The full GetRateInfo payload (budget + binding limiter)."""
        return self.law.rate_info()

    def budget_age(self, now: float) -> float:
        """Seconds since the control loop last ran — the consumers'
        staleness signal (a dead Ratekeeper's budget must not be
        trusted at full speed forever)."""
        return max(0.0, now - self.last_loop_time)

    def _read_sensors(self) -> Optional[dict]:
        """One reading of every role's saturation sensors, shaped as
        the law's slot dict. None when the feed is down (fault hook)."""
        if self.sensor_dropout:
            return None
        head = self.sequencer.live_committed.get()
        slots: dict = {"tlogs": {}, "storages": {}, "resolvers": {},
                       "proxies": {}}
        if self.tlog_system is not None:
            for i, t in enumerate(self.tlog_system.tlogs):
                if self.tlog_system.live[i]:
                    slots["tlogs"][f"tlog{i}"] = {
                        "smoothed_queue_bytes":
                            t.smoothed_queue_bytes.smooth_total(),
                    }
        for i, ss in enumerate(self.storage_servers):
            if self.liveness is None or self.liveness[i]:
                slots["storages"][f"storage{i}"] = {
                    "version_lag_versions": max(
                        0.0, head - ss.version.get()
                    ),
                }
        for i, r in enumerate(self.resolvers):
            slots["resolvers"][f"resolver{i}"] = {
                "occupancy": r.occupancy.smooth_rate(),
                "queue_depth": r.version.num_waiting(),
            }
        for i, p in enumerate(self._proxies()):
            slots["proxies"][getattr(p, "proxy_id", f"proxy{i}")] = {
                "queued_requests": p.saturation().get("queued_requests", 0),
            }
        return slots

    def _observed_admit_tps(self) -> float:
        released = sum(
            g.counters.get("txnRequestOut") for g in self._grv_proxies()
        )
        self._admit_smoother.add_delta(max(0, released - self._admit_last))
        self._admit_last = released
        return self._admit_smoother.smooth_rate()

    def status(self) -> dict:
        """The Ratekeeper's slice of the status `qos` section (the
        reference surfaces transactions_per_second_limit and the
        throttled-tag set the same way, Status.actor.cpp): the live
        budget, its bounds, the binding limiter (one vocabulary with
        performance_limited_by), the control inputs, and both quota
        tiers — so the admission-control loop is observable."""
        lag = self.worst_lag()
        return {
            **self.law.rate_info(),
            "worst_storage_lag_versions": lag,
            "lag_target_versions": self.lag_target,
            "lag_limit_versions": self.lag_limit,
            "admit_tps": self._admit_smoother.smooth_rate(),
            "throttled_intervals": self.counters.get("throttled"),
            "control_loops": self.counters.get("loops"),
            "tag_quotas": dict(self.tag_quotas),
            "auto_tag_quotas": dict(self.auto_tag_quotas),
        }

    def set_tag_quota(self, tag: str, tps: float) -> None:
        """Management surface: cap a transaction tag's start rate."""
        self.tag_quotas[tag] = tps

    def get_tag_quota(self, tag: str) -> float:
        return min(
            self.tag_quotas.get(tag, float("inf")),
            self.auto_tag_quotas.get(tag, float("inf")),
        )

    def note_tag_admission(self, tag: str) -> None:
        """GRV proxies report each admitted tagged request: the busyness
        signal the auto throttler derives quotas from."""
        self._tag_admissions[tag] = self._tag_admissions.get(tag, 0) + 1

    def _auto_quota_floor(self, tag: str) -> float:
        """The auto tier's floor for one tag: never below min_tag_tps,
        and never undercutting an EXPLICIT management quota — repeated
        stressed intervals used to ratchet the auto quota monotonically
        below what the operator deliberately granted via
        set_tag_quota (the management tier already caps the tag; auto
        pushing further starves it with no operator action to blame)."""
        floor = self.min_tag_tps
        mgmt = self.tag_quotas.get(tag)
        if mgmt is not None:
            floor = max(floor, mgmt)
        return floor

    def _update_auto_tag_quotas(self, lag: float) -> None:
        admissions = self._tag_admissions
        self._tag_admissions = {}
        total = sum(admissions.values())
        if lag > self.lag_target and total > 0:
            stress = min(
                1.0,
                (lag - self.lag_target) / (self.lag_limit - self.lag_target),
            )
            for tag, n in admissions.items():
                if n / total < self.auto_throttle_share:
                    continue
                rate = n / self.interval
                floor = self._auto_quota_floor(tag)
                # throttle the dominant tag toward its stressed fair
                # share; repeated stressed intervals ratchet it down —
                # but never through the floor (min_tag_tps, and any
                # explicit management quota)
                target = max(floor, rate * (1.0 - stress) * 0.5)
                cur = self.auto_tag_quotas.get(tag, float("inf"))
                self.auto_tag_quotas[tag] = max(floor, min(cur, target))
                code_probe(True, "ratekeeper.auto_tag_throttled")
        elif lag <= self.lag_target and self.auto_tag_quotas:
            # healthy interval: relax each auto quota; lift it once it
            # stops binding (2x headroom over the tag's observed rate)
            for tag in list(self.auto_tag_quotas):
                q = self.auto_tag_quotas[tag] * 2.0
                rate = admissions.get(tag, 0) / self.interval
                if q > max(rate * 2.0, self.min_tag_tps * 4):
                    del self.auto_tag_quotas[tag]
                    code_probe(True, "ratekeeper.auto_tag_lifted")
                else:
                    self.auto_tag_quotas[tag] = q

    async def _loop(self) -> None:
        try:
            while True:
                await self.sched.delay(self.interval)
                self.counters.add("loops")
                lag = self.worst_lag()
                self._update_auto_tag_quotas(lag)
                self.law.update(
                    self._read_sensors(),
                    current_tps=self._observed_admit_tps(),
                    live_storage=self._live_storage_count(),
                )
                self.last_loop_time = self.sched.now()
                if self.law.tps_budget < self.law.max_tps:
                    self.counters.add("throttled")
                    code_probe(True, "ratekeeper.throttled")
        except ActorCancelled:
            raise
