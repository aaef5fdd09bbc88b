"""DataDistribution: shard tracking and the MoveKeys protocol.

Behavioral mirror of the reference's DD subsystem in miniature
(fdbserver/DataDistribution.actor.cpp shard tracker + DDRelocationQueue;
fdbserver/MoveKeys.actor.cpp for the authoritative move protocol;
storage-side fetchKeys at storageserver.actor.cpp:7378):

MoveKeys of [begin, end) from its owner to `dest`:
  1. **Dual-tag**: commit proxies start tagging the range's mutations to
     BOTH owners (the reference's serverKeys intermediate state), so the
     destination's log stream is complete from some version Vd onward.
  2. **Fence**: a barrier commit through a proxy pins Vd and guarantees
     every later commit is dual-tagged.
  3. **fetchKeys**: the destination buffers its incoming mutations for
     the range and fetches a snapshot at Vf >= Vd from the old owner.
  4. **Install**: snapshot + buffered mutations > Vf replay in order;
     the destination is now complete and current.
  5. **Flip**: the keyServers ShardMap routes the range to `dest`;
     dual-tagging stops; the old owner drops the range's data.

The control loop balances by key count (the reference balances by bytes
via storage metrics): when the largest storage server holds more than
`imbalance_ratio` times the smallest's keys, its largest shard moves.

The port's own copy of foundationdb_tpu.cluster.data_distribution.
"""

from __future__ import annotations

from foundationdb_tpu_torch.models.types import CommitTransaction
from foundationdb_tpu_torch.runtime.flow import ActorCancelled, Scheduler
from foundationdb_tpu_torch.utils.metrics import CounterCollection
from foundationdb_tpu_torch.utils.trace import TraceEvent


class DataDistributor:
    def __init__(self, cluster, *, interval: float = 1.0,
                 imbalance_ratio: float = 2.0):
        self.cluster = cluster
        self.sched: Scheduler = cluster.sched
        self.interval = interval
        self.imbalance_ratio = imbalance_ratio
        self.counters = CounterCollection("DDMetrics", ["loops", "moves"])
        self._task = None
        self._moving = False

    def start(self) -> None:
        self._task = self.sched.spawn(self._loop(), name="data-distributor")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()

    # -- MoveKeys ---------------------------------------------------------

    async def _fence(self) -> int:
        """Commit an empty barrier transaction through a LIVE proxy and
        return its version. A 2000-seed ensemble found the original
        fence (pinned to commit_proxies[0]) hanging forever when that
        proxy was killed mid-move — with the flip already done, the old
        owners then never dropped and served stale data indefinitely.
        This fence retries across proxies AND across proxy generations
        (recovery rebuilds cluster.commit_proxies), with a timeout on
        each attempt: a proxy that dies mid-commit leaves its reply
        future unresolved forever.

        One fence version V* suffices to bound ALL earlier commits: the
        tlog's prev_version chain totally orders versions, so a storage
        server at version >= V* has applied every commit below V*."""
        from foundationdb_tpu_torch.runtime.flow import any_of

        while True:
            live = [
                p for p in self.cluster.commit_proxies
                if getattr(p, "failed", None) is None
            ]
            for p in live:
                fut = p.commit(CommitTransaction()).future
                try:
                    await any_of([fut, self.sched.delay(0.5)])
                except Exception:
                    # this proxy failed the barrier; count it and try the
                    # next (a fence that spins here shows up in counters)
                    self.counters.add("fence_retries")
                    continue
                if fut.is_ready:
                    try:
                        return fut.get().version
                    except Exception:
                        self.counters.add("fence_retries")
                        continue
                # timed out (proxy died mid-commit): next candidate
            # no live proxy answered: recovery is (or will be)
            # recruiting a new generation — wait and re-read the list
            await self.sched.delay(0.05)

    async def move_shard(self, begin: bytes, end: bytes, dest) -> None:
        """Move [begin, end) to team `dest` — an int or a tuple of server
        ids (end=None -> +inf). Each joining member fetches the segment;
        each leaving member drops it after the post-flip fence."""
        from foundationdb_tpu_torch.cluster.shardmap import _team

        cluster = self.cluster
        shard_map = cluster.key_servers
        dest_team = _team(dest)
        fence_end = end if end is not None else b"\xff" * 64
        # (segment, old_team, joining members) — only joiners fetch;
        # members already on the team keep applying normally
        moving = []
        for b, e, team in shard_map.segments_in(begin, fence_end):
            joiners = tuple(s for s in dest_team if s not in team)
            if team != dest_team:
                moving.append((b, e, team, joiners))
        if not moving:
            return
        self._moving = True
        tagged = False
        flipped = False
        fetching: list[tuple[bytes, bytes, int]] = []
        try:
            # 1+2. dual-tag the moving segments to every joiner (on the
            # SHARED shard map: every proxy of every generation consults
            # it) + start buffering, then fence so Vd is pinned.
            for b, e, _team, joiners in moving:
                for j in joiners:
                    shard_map.extra_tag_ranges.append((b, e, j))
                    cluster.storage_servers[j].begin_fetch(b, e)
                    fetching.append((b, e, j))
            tagged = True
            vd = await self._fence()

            # 3+4. fetch each segment's snapshot at Vd from a live old
            # member and install it on every joiner. A fully-dead old
            # team means the data is unrecoverable — fail (and unwind)
            # rather than hang on a frozen server.
            from foundationdb_tpu_torch.cluster.storage import TransactionTooOld

            for b, e, team, joiners in moving:
                for _attempt in range(8):
                    src_id = next(
                        (s for s in team if cluster.storage_live[s]), None
                    )
                    if src_id is None:
                        raise RuntimeError(
                            f"no live replica of [{b!r}, {e!r}) to fetch from"
                        )
                    src = cluster.client_storages[src_id]
                    try:
                        items = await src.get_key_values(b, e, vd)
                        break
                    except TransactionTooOld:
                        # the source GC'd past Vd while we waited on it
                        # (a lagging replica catches up a > MVCC-window
                        # span in one pull batch): re-fence and fetch at
                        # a fresher version — fetchKeys' retry-with-
                        # higher-version loop (storageserver.actor.cpp
                        # fetchKeys / fetch_keys_too_old). Dual-tagging
                        # is already in force, so any newer fence stays
                        # a consistent snapshot point for this segment.
                        vd = await self._fence()
                else:
                    raise RuntimeError(
                        f"fetch of [{b!r}, {e!r}) kept falling below the "
                        f"source's MVCC window"
                    )
                for j in joiners:
                    cluster.storage_servers[j].install_shard(b, e, items, vd)
                    fetching.remove((b, e, j))

            # 5a. CEDE before the flip: versions not yet in the log may
            # have their mutations tagged AFTER the flip (allocation and
            # tagging are separate steps in the proxy), i.e. to the new
            # team only — so leavers must refuse reads above the LOGGED
            # version (WrongShardServerError -> client re-resolves).
            # Everything at or below the logged version was tagged while
            # the old map was in force, so the leaver is complete there.
            # The sequencer's allocation counter is NOT a safe ceiling:
            # a 2000-seed ensemble caught a commit whose version was
            # allocated pre-flip but tagged post-flip slipping under it.
            # Without any ceiling, a read between the flip and the
            # eventual drop returned silently stale data.
            v_cede = cluster.tlog.version.get()
            for b, e, team, _joiners in moving:
                for leaver in team:
                    if leaver not in dest_team:
                        cluster.storage_servers[leaver].cede_shard(
                            b, e, v_cede
                        )
            # 5b. flip routing; stop dual-tagging.
            shard_map.move(begin, end, dest_team)
            flipped = True
            for b, e, _team, joiners in moving:
                for j in joiners:
                    if (b, e, j) in shard_map.extra_tag_ranges:
                        shard_map.extra_tag_ranges.remove((b, e, j))

            # 6. Leaving members drop their data — but only once they
            #    have applied every mutation tagged to them before the
            #    flip. One post-flip fence version bounds them (the
            #    tlog's prev_version chain totally orders commits), and
            #    _fence survives dead proxies and generation changes.
            vmax = await self._fence()
            for b, e, team, _joiners in moving:
                for leaver in team:
                    if leaver not in dest_team:
                        # deliberate fire-and-forget: the move is complete
                        # either way; a crashed drop surfaces through the
                        # scheduler's unhandled-error ledger (soak fails
                        # the seed) and the consistency check
                        self.sched.spawn(  # flowcheck: ignore[actor.fire-and-forget]
                            self._drop_after(leaver, b, e, vmax),
                            name=f"dd-drop-{leaver}",
                        )
            self.counters.add("moves")
            TraceEvent("RelocateShard").detail("Begin", begin).detail(
                "End", fence_end
            ).detail("Dest", str(dest_team)).log()
        except BaseException:
            if tagged:
                for b, e, _team, joiners in moving:
                    for j in joiners:
                        if (b, e, j) in shard_map.extra_tag_ranges:
                            shard_map.extra_tag_ranges.remove((b, e, j))
            if flipped:
                # cancelled AFTER the flip (e.g. mid post-flip fence):
                # the new team is authoritative and the leavers already
                # ceded — they must still DROP, or they hold the range's
                # live keys forever (consistency check failure). Waiting
                # to v_cede is sound: every tagged-to-leaver version is
                # at or below it from the flip on, and a drop is safe
                # any time after the flip (reads re-resolve loudly).
                for b, e, team, _joiners in moving:
                    for leaver in team:
                        if leaver not in dest_team:
                            # same fire-and-forget contract as the main
                            # path above (unhandled-error ledger)
                            self.sched.spawn(  # flowcheck: ignore[actor.fire-and-forget]
                                self._drop_after(leaver, b, e, v_cede),
                                name=f"dd-drop-{leaver}",
                            )
            else:
                # nothing flipped: the old team remains authoritative —
                # discard fetch buffers
                for b, e, j in fetching:
                    cluster.storage_servers[j].cancel_fetch(b, e)
            raise
        finally:
            self._moving = False

    async def _drop_after(self, owner: int, b: bytes, e: bytes, version: int):
        # Re-resolve the CURRENT server object each wait: a reboot
        # replaces cluster.storage_servers[owner], and a waiter pinned
        # to the dead object would never drop — the rebooted server
        # would then serve the moved range's stale values to clients
        # with stale location caches.
        while self.cluster.storage_servers[owner].version.get() < version:
            # poll, never pin: an unbounded when_at_least on an object
            # that dies mid-wait would strand this waiter forever
            await self.sched.delay(0.02)
        self.cluster.storage_servers[owner].drop_shard(b, e)

    async def repair(self, dead: int, replacement: int = None) -> int:
        """Re-replicate every shard that lost `dead` (DDTeamCollection's
        team repair after a storage failure): each affected segment gets
        a live server not already on its team — the preferred
        `replacement` when possible, any other live server otherwise, or
        the team simply shrinks when no candidate exists. Returns the
        number of segments repaired."""
        cluster = self.cluster
        sm = cluster.key_servers
        repaired = 0
        for b, e, team in list(sm.ranges()):
            if dead not in team:
                continue
            if not any(cluster.storage_live[s] for s in team):
                # every replica dead: unrecoverable without a reboot —
                # leave the team for reboot_storage to revive
                TraceEvent("TeamUnrecoverable").detail("Begin", b).log()
                continue
            candidates = [
                s for s in range(len(cluster.storage_servers))
                if cluster.storage_live[s] and s not in team
            ]
            # locality-aware repair: prefer replacements that keep the
            # team satisfying the replication policy (PolicyAcross zones)
            policy = getattr(cluster.config, "replication_policy", None)
            localities = getattr(cluster.config, "storage_localities", None)
            if policy is not None and localities is not None:
                from foundationdb_tpu_torch.cluster.locality import validate_team

                keep = tuple(s for s in team if s != dead)
                good = [
                    c for c in candidates
                    if validate_team(keep + (c,), localities, policy)
                ]
                if good:
                    candidates = good
            if replacement in candidates:
                pick = replacement
            elif candidates:
                pick = candidates[0]
            else:
                pick = None  # no spare server: drop to a smaller team
            new_team = tuple(
                pick if s == dead else s for s in team
                if not (s == dead and pick is None)
            )
            await self.move_shard(b, e, new_team)
            repaired += 1
        if repaired and all(dead not in t for t in sm.owners):
            # fully decommissioned: release the dead tag's log backlog
            # (the reference's exclusion -> tlog pop path)
            cluster.tlog.pop(dead, 1 << 62)
        return repaired

    # -- shard tracker / balancer loop ------------------------------------

    def key_counts(self) -> list[int]:
        # live keys only — the versioned store retains cleared keys'
        # histories until GC, which must not count as load
        return [ss._live_count for ss in self.cluster.storage_servers]

    async def _loop(self) -> None:
        try:
            while True:
                await self.sched.delay(self.interval)
                self.counters.add("loops")
                if self._moving:
                    continue
                # auto-balancing only steers single-replica maps; with
                # teams, rebalancing choices belong to team repair logic
                if any(len(t) > 1 for t in self.cluster.key_servers.owners):
                    continue
                counts = self.key_counts()
                if len(counts) < 2 or sum(counts) == 0:
                    continue
                big = max(range(len(counts)), key=lambda i: counts[i])
                small = min(range(len(counts)), key=lambda i: counts[i])
                if counts[big] <= self.imbalance_ratio * max(counts[small], 1):
                    continue
                # move the upper half of the big server's LARGEST segment
                ss = self.cluster.storage_servers[big]
                data = ss._data  # live view
                best, best_keys = None, []
                for b, e, owner in self.cluster.key_servers.ranges():
                    if owner != (big,):
                        continue
                    keys = sorted(
                        k for k in data if k >= b and (e is None or k < e)
                    )
                    if len(keys) > len(best_keys):
                        best, best_keys = (b, e), keys
                if best is None or len(best_keys) < 2:
                    continue
                mid = best_keys[len(best_keys) // 2]
                await self.move_shard(mid, best[1], small)
        except ActorCancelled:
            raise
