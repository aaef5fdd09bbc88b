"""The Sequencer (Master) role: strictly-increasing commit versions (the
port's own copy of foundationdb_tpu.cluster.sequencer).

Behavioral mirror of `fdbserver/masterserver.actor.cpp`:

* `get_commit_version` (getVersion :154-239): each proxy batch gets a
  half-open (prev_version, version] pair; version advance is
  clamp(VERSIONS_PER_SECOND * elapsed, 1, MAX_READ_TRANSACTION_LIFE_
  VERSIONS) so versions track wall-clock at ~1e6/s — the MVCC window is
  a time window (fdbclient/ServerKnobs.cpp:36-44).
* Request ordering by (requestNum, mostRecentProcessedRequestNum): a
  proxy's out-of-order version requests are queued; duplicates replay the
  cached reply (:160-178 requestNum bookkeeping).
* `report_live_committed_version` / `get_live_committed_version`
  (masterserver.actor.cpp provideVersions/serveLiveCommittedVersion):
  proxies report fully-committed versions; GRV proxies read the max.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from foundationdb_tpu_torch.runtime.flow import Notified, Scheduler

VERSIONS_PER_SECOND = 1_000_000
MAX_READ_TRANSACTION_LIFE_VERSIONS = 5_000_000
MAX_VERSION_RATE_MODIFIER = 0.1


@dataclasses.dataclass
class CommitVersionReply:
    version: int
    prev_version: int
    request_num: int
    # resolver partition changes would ride here (GetCommitVersionReply.
    # resolverChanges, ResolutionBalancer.actor.cpp:36) — static in v0.


class _ProxyVersionState:
    __slots__ = ("latest_request_num", "replies")

    def __init__(self):
        # Proxies number requests from 1; 0 means "none processed yet".
        self.latest_request_num = 0
        self.replies: dict[int, CommitVersionReply] = {}


class Sequencer:
    """Allocates the global commit-version order."""

    def __init__(self, sched: Scheduler, *, recovery_version: int = 0):
        self.sched = sched
        self.version = recovery_version          # last allocated
        self.last_version_time = sched.now()
        self.live_committed = Notified(recovery_version)
        self.committed_version = Notified(recovery_version)  # reported by proxies
        self._proxies: dict[str, _ProxyVersionState] = {}
        self.reference_version: Optional[int] = None

    # -- commit version allocation (getVersion :154-239) -----------------

    async def get_commit_version(
        self, proxy_id: str, request_num: int, most_recent_processed: int
    ) -> Optional[CommitVersionReply]:
        st = self._proxies.setdefault(proxy_id, _ProxyVersionState())
        # Drop replies the proxy has fully processed.
        for rn in [r for r in st.replies if r < most_recent_processed]:
            del st.replies[rn]

        if request_num <= st.latest_request_num:
            # Duplicate / stale: replay if cached, else ignore (the reference
            # sends Never() for requests below the window).
            return st.replies.get(request_num)

        # Wait for in-order request numbers (the reference queues these).
        while request_num > st.latest_request_num + 1:
            await self.sched.delay(0.001)
            if request_num <= st.latest_request_num:
                return st.replies.get(request_num)

        now = self.sched.now()
        elapsed = now - self.last_version_time
        self.last_version_time = now
        to_add = max(
            1,
            min(
                MAX_READ_TRANSACTION_LIFE_VERSIONS,
                int(VERSIONS_PER_SECOND * elapsed),
            ),
        )
        prev = self.version
        self.version = prev + to_add
        st.latest_request_num = request_num
        reply = CommitVersionReply(
            version=self.version, prev_version=prev, request_num=request_num
        )
        st.replies[request_num] = reply
        return reply

    # -- live committed version (GRV path) -------------------------------

    def report_live_committed_version(self, version: int) -> None:
        if version > self.live_committed.get():
            self.live_committed.set(version)

    def get_live_committed_version(self) -> int:
        return self.live_committed.get()
