"""Per-replica latency model + backup-request load balancing.

Behavioral mirror of fdbrpc/QueueModel.cpp + LoadBalance.actor.h: the
client keeps an EWMA latency estimate and an outstanding-request count
per storage endpoint; reads go to the replica with the smallest expected
latency, and a BACKUP request is armed on the next-best replica when the
primary hasn't answered within a multiple of its expected latency —
first reply wins, and the duplicated loser runs to completion so its
eventual latency is still observed. A slow-but-alive replica
therefore stops receiving the bulk of reads without any failure-monitor
involvement (it is throttled by its own measured latency), while a
recovered replica is re-probed after its estimate goes stale.

The reference's TSS mirror-pairing rides the same machinery
(fdbrpc/LoadBalance.actor.h loadBalance); not implemented here.

The port's own copy of foundationdb_tpu.cluster.queue_model.
"""

from __future__ import annotations

import dataclasses

from foundationdb_tpu_torch.utils.probes import code_probe, declare

declare(
    "loadbalance.backup_request",
    "loadbalance.backup_won",
    "loadbalance.slow_replica_shunned",
)


@dataclasses.dataclass
class _EndpointStats:
    latency: float      # EWMA seconds
    outstanding: int
    last_update: float  # sched time of the last observation


class QueueModel:
    """Latency estimates per endpoint (fdbrpc/QueueModel.cpp).

    expected() = EWMA latency x (1 + outstanding): queued requests
    inflate the estimate exactly like the reference's penalty so a
    pile-up on one replica sheds to its peers before replies even come
    back. An UNTRIED endpoint estimates 0 — unknown servers are probed
    first, the reference's loadBalance discipline (otherwise a single
    fast reply would lock in the first-tried replica forever). Estimates
    older than STALE_AFTER decay back to the untried prior so a
    recovered replica gets re-probed.
    """

    ALPHA = 0.25          # EWMA weight of a new observation
    PRIOR = 0.0           # untried endpoints are assumed fast: probe them
    STALE_AFTER = 2.0     # seconds without data -> treat as cold again
    #: absolute per-outstanding-request charge: an endpoint with an
    #: unanswered request in flight must lose ties against idle peers
    #: even while its EWMA is still zero/cold (QueueModel.cpp's queue
    #: penalty is likewise additive)
    QUEUE_PENALTY = 0.001

    def __init__(self, sched):
        self.sched = sched
        self._stats: dict[object, _EndpointStats] = {}

    def expected(self, ep) -> float:
        st = self._stats.get(ep)
        if st is None:
            return self.PRIOR
        if self.sched.now() - st.last_update > self.STALE_AFTER:
            # stale: decay PERSISTENTLY to the untried prior — the next
            # observation must re-seed the EWMA from cold, not from the
            # old (possibly slow-era) value, or one successful re-probe
            # would immediately re-shun a recovered replica
            st.latency = min(st.latency, self.PRIOR)
        return (
            st.latency * (1 + st.outstanding)
            + st.outstanding * self.QUEUE_PENALTY
        )

    def order(self, endpoints) -> list:
        """Endpoints sorted by expected latency. The sort is STABLE and
        the key is the estimate alone, so the caller's rotation of the
        candidate list spreads ties (cold replicas) round-robin."""
        return sorted(endpoints, key=self.expected)

    def start(self, ep) -> float:
        st = self._stats.get(ep)
        if st is None:
            st = self._stats[ep] = _EndpointStats(
                self.PRIOR, 0, self.sched.now()
            )
        st.outstanding += 1
        return self.sched.now()

    def finish(self, ep, t0: float, failed: bool = False) -> None:
        st = self._stats.get(ep)
        if st is None:
            return
        st.outstanding = max(0, st.outstanding - 1)
        obs = self.sched.now() - t0
        if failed:
            # a failed request says nothing about queue latency; keep the
            # estimate but stamp the time so it does not instantly decay
            st.last_update = self.sched.now()
            return
        st.latency = (1 - self.ALPHA) * st.latency + self.ALPHA * obs
        st.last_update = self.sched.now()


#: arm the backup request at this multiple of the primary's expected
#: latency (LoadBalance.actor.h's backup delay discipline)
BACKUP_DELAY_MULT = 4.0
BACKUP_DELAY_MIN = 0.002


async def load_balanced_call(sched, model: QueueModel, replicas: list,
                             issue):
    """One logical request over ordered replicas with a backup request.

    `replicas`: candidate endpoints (already filtered for liveness).
    `issue(ep)`: coroutine factory performing the request against ep.
    Returns the first successful reply. If the primary is slower than
    BACKUP_DELAY_MULT x its expected latency, the request is DUPLICATED
    to the next replica and the first reply wins (the reference's
    backup-request discipline — duplication, not failover, so a stalled
    primary costs nothing extra when it eventually answers). The losing
    request is NOT cancelled: it runs to completion so its eventual
    latency lands in the model (that observation is what marks a
    stalled replica slow). Errors surface from whichever request fails
    last-standing.
    """
    from foundationdb_tpu_torch.runtime.flow import ActorCancelled, any_of

    order = model.order(replicas)
    primary = order[0]
    # absolute floor: with a cold primary (expected 0) any nonzero
    # peer estimate would otherwise read as a "shun"
    code_probe(
        len(order) > 1
        and model.expected(order[-1])
        > max(10 * model.expected(primary), 0.005),
        "loadbalance.slow_replica_shunned",
    )
    # expected() BEFORE start(): the request's own outstanding penalty
    # must not inflate its backup delay
    primary_expected = model.expected(primary)
    t0 = model.start(primary)
    pt = sched.spawn(issue(primary), name="lb-primary")
    if len(order) == 1:
        try:
            r = await pt.done
            model.finish(primary, t0)
            return r
        except BaseException:
            model.finish(primary, t0, failed=True)
            raise

    backup_after = max(
        BACKUP_DELAY_MULT * primary_expected, BACKUP_DELAY_MIN
    )
    try:
        await any_of([pt.done, sched.delay(backup_after)])
    except ActorCancelled:
        model.finish(primary, t0, failed=True)
        raise  # cancellation must not leak the outstanding increment
    # a primary error is handled by inspecting pt.done below, where the
    # failure updates the model before re-raising — nothing is dropped
    except BaseException:  # flowcheck: ignore[actor.swallow]
        pass
    if pt.done.is_ready:
        try:
            r = pt.done.get()
            model.finish(primary, t0)
            return r
        except BaseException:
            model.finish(primary, t0, failed=True)
            raise

    # primary is slow: duplicate to the next-best replica
    code_probe(True, "loadbalance.backup_request")
    secondary = order[1]
    t1 = model.start(secondary)
    bt = sched.spawn(issue(secondary), name="lb-backup")
    try:
        await any_of([pt.done, bt.done])
    except ActorCancelled:
        model.finish(primary, t0, failed=True)
        model.finish(secondary, t1, failed=True)
        raise
    # per-request errors are handled below (first/other inspection):
    # both futures' outcomes are consumed either way
    except BaseException:  # flowcheck: ignore[actor.swallow]
        pass
    first, other = (pt, bt) if pt.done.is_ready else (bt, pt)
    f_ep, f_t0, o_ep, o_t0 = (
        (primary, t0, secondary, t1)
        if first is pt
        else (secondary, t1, primary, t0)
    )
    try:
        r = first.done.get()
        model.finish(f_ep, f_t0)
        code_probe(first is bt, "loadbalance.backup_won")
        # the duplicated request keeps running (reads are idempotent);
        # record its EVENTUAL latency — that observation is exactly what
        # marks a stalled-but-alive replica slow and sheds future load
        _observe_when_done(model, o_ep, o_t0, other)
        return r
    except BaseException:
        model.finish(f_ep, f_t0, failed=True)
        # first responder failed: the other request is still in flight
        try:
            r = await other.done
            model.finish(o_ep, o_t0)
            return r
        except BaseException:
            model.finish(o_ep, o_t0, failed=True)
            raise


def _observe_when_done(model: QueueModel, ep, t0: float, task) -> None:
    def cb(fut):
        try:
            fut.get()
        except BaseException:
            model.finish(ep, t0, failed=True)
        else:
            model.finish(ep, t0)

    task.done.add_done_callback(cb)
