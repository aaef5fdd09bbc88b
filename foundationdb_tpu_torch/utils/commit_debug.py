"""The commit-path Location strings the Resolver role, the wire commit
path, the simulated cluster's roles and its client emit, and the
reconstructor the soak's span-chain gate runs (the port's own copy of
the constants, `version_id`, `Timeline`, `TraceIndex`, `check_chains`,
`check_spans` and `load_jsonl` of foundationdb_tpu.utils.commit_debug).

The reference debugs its commit path with `g_traceBatch` micro-events
(name, id, Location) and contrib/commit_debug.py joins them on these
exact strings (Resolver.actor.cpp:244,266,320,509;
CommitProxyServer.actor.cpp's commitBatch marks), so the emitters read
them from here and never spell them inline. The timeline reconstructor
of the JAX module reads the port's trace files as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

from foundationdb_tpu_torch.utils.probes import code_probe, declare

declare("trace.span_chain_gate_tripped")

GRV_BEFORE = "NativeAPI.getConsistentReadVersion.Before"
GRV_AFTER = "NativeAPI.getConsistentReadVersion.After"
GRV_REPLY = "GrvProxyServer.transactionStarter.ReplyToStartedTransactions"
COMMIT_BEFORE = "NativeAPI.commit.Before"
COMMIT_AFTER = "NativeAPI.commit.After"
BATCH_BEFORE = "CommitProxy.commitBatch.Before"
BATCH_GETTING_VERSION = "CommitProxy.commitBatch.GettingCommitVersion"
BATCH_GOT_VERSION = "CommitProxy.commitBatch.GotCommitVersion"
BATCH_AFTER_RESOLUTION = "CommitProxy.commitBatch.AfterResolution"
BATCH_AFTER_LOG_PUSH = "CommitProxy.commitBatch.AfterLogPush"
#: the proxy finished packing the batch's conflict metadata into the
#: columnar frame (flat arrays and one key blob)
PROXY_COLUMNAR_PACK = "CommitProxy.commitBatch.ColumnarPack"
RESOLVER_BEFORE = "Resolver.resolveBatch.Before"
RESOLVER_AFTER_QUEUE = "Resolver.resolveBatch.AfterQueueSizeCheck"
RESOLVER_AFTER_ORDERER = "Resolver.resolveBatch.AfterOrderer"
#: the columnar frame has become the conflict backend's input (kernel
#: tensors, or rebuilt objects on the object fallback): with
#: AfterOrderer as the opening mark it brackets exactly the decode
RESOLVER_COLUMNAR_DECODE = "Resolver.resolveBatch.ColumnarDecode"
RESOLVER_AFTER = "Resolver.resolveBatch.After"
TLOG_BEFORE_WAIT = "TLog.tLogCommit.BeforeWaitForVersion"
TLOG_AFTER_COMMIT = "TLog.tLogCommit.AfterTLogCommit"
STORAGE_APPLIED = "StorageServer.update.Applied"

#: ident prefix for version-keyed events (storage applies happen below
#: the debug-id horizon; the CommitDebugVersion record joins them)
VERSION_ID_PREFIX = "@"


#: the stages a committed transaction's batch must have traversed —
#: missing any of these = a broken chain (the soak gate's contract)
REQUIRED_BATCH_LOCATIONS = (
    BATCH_BEFORE,
    BATCH_GOT_VERSION,
    BATCH_AFTER_RESOLUTION,
    BATCH_AFTER_LOG_PUSH,
    RESOLVER_BEFORE,
    RESOLVER_AFTER,
    TLOG_AFTER_COMMIT,
)

MICRO_EVENT_TYPES = ("CommitDebug", "TransactionDebug", "CommitAttachID")


def version_id(version: int) -> str:
    return f"{VERSION_ID_PREFIX}{version}"


@dataclasses.dataclass
class Timeline:
    """One committed transaction's reconstructed commit-path timeline."""

    debug_id: str
    batch_id: Optional[str]
    version: Optional[int]
    #: (time, location) across every stage, time-ascending
    events: list[tuple[float, str]]

    def locations(self) -> set[str]:
        return {loc for _t, loc in self.events}

    def first(self, location: str) -> Optional[float]:
        for t, loc in self.events:
            if loc == location:
                return t
        return None

    def stage_durations(self) -> dict[str, float]:
        """The waterfall row: per-stage seconds, NaN-free (absent stages
        are simply omitted)."""
        marks = {}
        for t, loc in self.events:
            marks.setdefault(loc, t)
        out: dict[str, float] = {}

        def stage(name, a, b):
            if a in marks and b in marks and marks[b] >= marks[a]:
                out[name] = marks[b] - marks[a]

        stage("grv", GRV_BEFORE, GRV_AFTER)
        stage("batching", COMMIT_BEFORE, BATCH_BEFORE)
        stage("get_version", BATCH_BEFORE, BATCH_GOT_VERSION)
        # columnar wire path: proxy-side pack and resolver-side
        # decode attributed explicitly inside the resolution window —
        # absent on object-path runs, so an --aggregate A/B shows
        # exactly where the microseconds went
        stage("columnar_pack", BATCH_GOT_VERSION, PROXY_COLUMNAR_PACK)
        stage("columnar_decode", RESOLVER_AFTER_ORDERER,
              RESOLVER_COLUMNAR_DECODE)
        stage("resolution", BATCH_GOT_VERSION, BATCH_AFTER_RESOLUTION)
        stage("logging", BATCH_AFTER_RESOLUTION, BATCH_AFTER_LOG_PUSH)
        stage("reply", BATCH_AFTER_LOG_PUSH, COMMIT_AFTER)
        stage("total", COMMIT_BEFORE, COMMIT_AFTER)
        return out


class TraceIndex:
    """Parsed trace records, indexed for reconstruction."""

    def __init__(self, records: Iterable[dict]):
        #: id -> [(time, location)], micro-events only, insertion order
        self.micro: dict[str, list[tuple[float, str]]] = {}
        #: txn debug id -> batch debug id (attach records)
        self.attach: dict[str, str] = {}
        #: batch debug id -> (version, message count)
        self.batch_version: dict[str, tuple[int, int]] = {}
        #: exported span records (the Span sink's shape)
        self.spans: list[dict] = []
        for rec in records:
            rtype = rec.get("Type")
            if rtype == "CommitDebugVersion":
                self.batch_version[rec["ID"]] = (
                    int(rec["Version"]), int(rec.get("Messages", 0))
                )
            elif rtype == "Span":
                self.spans.append(rec)
            elif rtype in MICRO_EVENT_TYPES and "Location" in rec:
                ident, loc = rec["ID"], rec["Location"]
                if loc.startswith("attach:"):
                    self.attach[ident] = loc[len("attach:"):]
                else:
                    self.micro.setdefault(ident, []).append(
                        (float(rec["Time"]), loc)
                    )

    # -- reconstruction --------------------------------------------------

    def committed_ids(self) -> list[str]:
        """Debug ids whose client observed a successful commit."""
        return sorted(
            ident for ident, evs in self.micro.items()
            if any(loc == COMMIT_AFTER for _t, loc in evs)
        )

    def timeline(self, debug_id: str) -> Timeline:
        events = list(self.micro.get(debug_id, []))
        batch_id = self.attach.get(debug_id)
        version = msg_count = None
        if batch_id is not None:
            events += self.micro.get(batch_id, [])
            bv = self.batch_version.get(batch_id)
            if bv is not None:
                version, msg_count = bv
                events += self.micro.get(version_id(version), [])
        events.sort()
        return Timeline(
            debug_id=debug_id, batch_id=batch_id, version=version,
            events=events,
        )

    def timelines(self) -> list[Timeline]:
        return [self.timeline(i) for i in self.committed_ids()]


# -- the chain-integrity gate -------------------------------------------


def check_chains(index: TraceIndex) -> list[str]:
    """Violations of the commit-chain contract: every committed
    transaction must show the full GRV -> commit -> resolve -> tlog ->
    storage pipeline. Returns human-readable violation strings (empty =
    clean); fires the `trace.span_chain_gate_tripped` probe on any."""
    violations: list[str] = []
    for tl in index.timelines():
        locs = tl.locations()
        if COMMIT_BEFORE not in locs:
            violations.append(
                f"{tl.debug_id}: {COMMIT_AFTER} without {COMMIT_BEFORE}"
            )
        # a preset read version (sideband-style pinning) legitimately
        # skips GRV; an ISSUED GRV must have completed
        if GRV_BEFORE in locs and GRV_AFTER not in locs:
            violations.append(f"{tl.debug_id}: GRV issued but never answered")
        if tl.batch_id is None:
            violations.append(
                f"{tl.debug_id}: committed but never attached to a batch"
            )
            continue
        missing = [l for l in REQUIRED_BATCH_LOCATIONS if l not in locs]
        if missing:
            violations.append(
                f"{tl.debug_id} (batch {tl.batch_id}): missing pipeline "
                f"stage(s) {missing}"
            )
        if tl.version is None:
            violations.append(
                f"{tl.debug_id} (batch {tl.batch_id}): no "
                "CommitDebugVersion record"
            )
        else:
            _v, msgs = index.batch_version[tl.batch_id]
            if msgs > 0 and STORAGE_APPLIED not in locs:
                violations.append(
                    f"{tl.debug_id} (batch {tl.batch_id}, version "
                    f"{tl.version}): {msgs} storage message tag(s) but no "
                    f"{STORAGE_APPLIED} event"
                )
    violations += check_spans(index.spans)
    code_probe(bool(violations), "trace.span_chain_gate_tripped")
    return violations


def check_spans(spans: list[dict]) -> list[str]:
    """Span sanity over exported records (either the exporter's
    `finished` dicts or their TraceLog "Span" sink shape): no orphan
    parents, no end-before-start in (virtual) time."""
    def field(s, snake, camel):
        return s[snake] if snake in s else s[camel]

    ids = {field(s, "span_id", "SpanID") for s in spans}
    out: list[str] = []
    for s in spans:
        loc = field(s, "location", "Location")
        sid = field(s, "span_id", "SpanID")
        parent = field(s, "parent_id", "ParentID")
        begin, end = field(s, "begin", "Begin"), field(s, "end", "End")
        if parent and parent not in ids:
            out.append(f"span {sid} ({loc}): orphan parent {parent}")
        if end is None or end < begin:
            out.append(
                f"span {sid} ({loc}): end {end} before begin {begin}"
            )
    return out


def load_jsonl(paths: list[str]) -> list[dict]:
    """Read TraceLog JSONL files (pass rolled `.1` files first for a
    complete, time-ordered trace)."""
    import json

    records: list[dict] = []
    for path in paths:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
    return records
