"""Randomized full-client API-correctness workload, model-checked.

The reference proves its resolver AND its client stack together with
randomized workloads cross-checked against an in-memory model
(`fdbserver/workloads/ApiCorrectness.actor.cpp` against
MemoryKeyValueStore; `workloads/ConflictRange.actor.cpp` for the
commit/abort decision itself). The kernel-parity suites here cover the
packed-batch resolver in isolation — this module covers everything the
client path layers on top: the RYW overlay, forward/reverse limited
range reads, atomic ops, versionstamped keys/values, explicit conflict
ranges, snapshot reads, and the retry-loop outcome classification —
concurrently, under the soak ensemble's fault mix, on either resolver
backend.

How the cross-check stays EXACT under concurrency and ambiguity:

* Every mutating transaction carries a versionstamped **marker** write
  (`api/log/<actor>/<n>` := SET_VERSIONSTAMPED_VALUE), so its committed
  value IS the 10-byte commit stamp (8B version + 2B batch order).
  After the run, markers resolve every commit_unknown_result into a
  definite committed/not-committed, and totally order all commits
  exactly as storage applied them — no guessing, no possible-value
  sets.
* The committed transactions replay in stamp order into a
  `SequentialModel` (testing/oracle.py). Every recorded read —
  regardless of whether its transaction later committed, conflicted,
  or died to a fault — is then re-executed against the model state at
  its read version plus an independent reimplementation of the RYW
  overlay (`_TxnView`), and must match byte-for-byte.
* The client's conflict-range and mutation encoding contract is
  re-derived from the op stream and compared against what the
  transaction actually sent (the ConflictRange discipline: a wrongly
  narrowed range would silently weaken isolation without failing any
  read check).
* Commit/abort decisions are audited against the committed set: a
  committed transaction whose read ranges intersect a committed write
  in (read_version, commit_stamp) is a serializability violation and
  fails the seed; under fault-free plans, a NotCommitted with no such
  conflicting writer anywhere fails it too (phantom resolver state
  from killed proxies makes that check unsound under kill faults, so
  it is plan-gated — see `strict_aborts`).

Any divergence raises AssertionError, which fails the soak seed just
like a workload model-check or the unhandled-actor-error gate.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from foundationdb_tpu_torch.utils.atomic import apply_atomic
from foundationdb_tpu_torch.utils.probes import code_probe, declare

declare(
    "workload.api_model_checked",
    "workload.api_reverse_checked",
    "workload.api_system_read_checked",
    "workload.api_unknown_resolved",
)

PREFIX = b"api/"
DATA = PREFIX + b"k/"
MARKER = PREFIX + b"log/"
VS = PREFIX + b"vs/"
PREFIX_END = PREFIX + b"\xff"

#: op kinds that send a transaction through the RESOLUTION path (and so
#: earn it a versionstamped marker): every data mutation, plus explicit
#: write-conflict ranges — a wcr-only transaction applies nothing but
#: its committed write ranges still enter resolver history and abort
#: concurrent readers, so its outcome MUST be marker-resolvable or the
#: decision audits would blame aborts on an invisible writer. (rcr-only
#: transactions commit client-side — read conflicts alone never reach
#: the resolver.) Clear ranges are confined to the DATA subspace so a
#: workload clear can never erase another txn's marker.
_MUTATING = ("set", "clear_range", "atomic", "vs_value", "vs_key", "wcr")

_ATOMIC_CHOICES = (
    "add", "max", "min", "bit_or", "bit_xor",
    "byte_min", "byte_max", "append_if_fits", "compare_and_clear",
)


def key_after(k: bytes) -> bytes:
    return k + b"\x00"


def _overlap(ranges_a, ranges_b) -> Optional[tuple]:
    """First intersecting ((ab, ae), (bb, be)) pair, else None."""
    for ab, ae in ranges_a:
        for bb, be_ in ranges_b:
            if ab < be_ and bb < ae:
                return ((ab, ae), (bb, be_))
    return None


class _TxnView:
    """Independent reimplementation of the client's read-your-writes
    overlay (cluster/client.py WriteMap), evaluated over a MODEL
    snapshot instead of storage — the two implementations must agree on
    every read or the seed fails. Kept deliberately separate from
    WriteMap so a bug there cannot cancel out here."""

    def __init__(self, snapshot: dict):
        self.snapshot = snapshot
        self.sets: dict = {}
        self.clears: list = []
        self.atomics: dict = {}

    def known(self, k: bytes) -> bool:
        return k in self.sets or any(b <= k < e for b, e in self.clears)

    def _base(self, k: bytes):
        if k in self.sets:
            return self.sets[k]
        if any(b <= k < e for b, e in self.clears):
            return None
        return self.snapshot.get(k)

    def set(self, k: bytes, v: bytes) -> None:
        self.sets[k] = v
        self.atomics.pop(k, None)

    def clear(self, b: bytes, e: bytes) -> None:
        self.sets = {k: v for k, v in self.sets.items() if not b <= k < e}
        self.atomics = {
            k: v for k, v in self.atomics.items() if not b <= k < e
        }
        self.clears.append((b, e))

    def atomic(self, op: str, k: bytes, param: bytes) -> None:
        if self.known(k):
            new = apply_atomic(op, self._base(k), param)
            if new is None:
                self.clear(k, key_after(k))
            else:
                self.set(k, new)
        else:
            self.atomics.setdefault(k, []).append((op, param))

    def vs_value(self, k: bytes) -> None:
        # a pending versionstamped value drops queued atomics for the
        # key but leaves reads seeing the pre-stamp state (the stamp
        # only exists at commit)
        self.atomics.pop(k, None)

    def get(self, k: bytes):
        val = self._base(k)
        for op, param in self.atomics.get(k, []):
            val = apply_atomic(op, val, param)
        return val

    def range(self, b: bytes, e: bytes) -> list:
        out = {k: v for k, v in self.snapshot.items() if b <= k < e}
        for cb, ce in self.clears:
            for k in [k for k in out if cb <= k < ce]:
                del out[k]
        for k, v in self.sets.items():
            if b <= k < e:
                out[k] = v
        for k, ops in self.atomics.items():
            if b <= k < e:
                v = out.get(k)
                for op, param in ops:
                    v = apply_atomic(op, v, param)
                if v is None:
                    out.pop(k, None)
                else:
                    out[k] = v
        return sorted(out.items())


@dataclasses.dataclass
class TxnRecord:
    """One transaction attempt: the ops it ran (with observed read
    results), its outcome, and the conflict/mutation payload it sent."""

    actor: int
    n: int
    ops: list = dataclasses.field(default_factory=list)  # [(op, observed)]
    outcome: str = "incomplete"
    read_version: Optional[int] = None
    version: Optional[int] = None
    stamp: Optional[bytes] = None
    marker_key: Optional[bytes] = None
    read_conflicts: list = dataclasses.field(default_factory=list)
    write_conflicts: list = dataclasses.field(default_factory=list)
    mutations: list = dataclasses.field(default_factory=list)


class ApiWorkload:
    """Seeded multi-actor full-client workload + post-run model check.

    Usage (testing/soak.py wires this into every ensemble seed whose
    plan enables it):

        api = ApiWorkload(sched, db, seed, actors=3, rounds=12)
        tasks += [sched.spawn(c, name=...).done for c in api.actor_coros()]
        ... run, settle ...
        sched.run_until(sched.spawn(api.verify()).done)  # raises on divergence
    """

    def __init__(self, sched, db, seed: int, *, actors: int = 3,
                 rounds: int = 12, keyspace: int = 18,
                 strict_aborts: bool = False):
        from foundationdb_tpu_torch.cluster.commit_proxy import (
            CommitUnknownResult,
            NotCommitted,
            TransactionTooOldError,
        )
        from foundationdb_tpu_torch.cluster.failure_monitor import (
            ProcessFailedError,
        )
        from foundationdb_tpu_torch.cluster.grv_proxy import (
            GrvProxyFailedError,
            GrvThrottledError,
        )

        self.sched = sched
        self.db = db
        self.seed = seed
        self.actors = actors
        self.rounds = rounds
        self.keyspace = keyspace
        self.strict_aborts = strict_aborts
        self.records: list[TxnRecord] = []
        self.stats = {
            "acked": 0, "readonly": 0, "unknown": 0, "conflict": 0,
            "too_old": 0, "retryable": 0, "unknown_resolved": 0,
            "reads_checked": 0,
        }
        self._unknown = CommitUnknownResult
        self._conflict = NotCommitted
        self._too_old = TransactionTooOldError
        self._retryable = (
            GrvProxyFailedError, GrvThrottledError, ProcessFailedError,
            TransactionTooOldError, NotCommitted, CommitUnknownResult,
        )

    # -- generation -------------------------------------------------------

    def _dkey(self, rng) -> bytes:
        return DATA + b"%02d" % int(rng.integers(0, self.keyspace))

    def _drange(self, rng) -> tuple:
        if rng.random() < 0.12:
            # the whole module, markers and versionstamp keys included
            return (PREFIX, PREFIX_END)
        a = int(rng.integers(0, self.keyspace))
        b = int(rng.integers(0, self.keyspace))
        lo, hi = min(a, b), max(a, b) + 1
        return (DATA + b"%02d" % lo, DATA + b"%02d" % hi)

    def _gen_ops(self, rng, actor: int, n: int) -> list:
        from foundationdb_tpu_torch.cluster import system_data as SD

        ops = []
        for i in range(int(rng.integers(2, 7))):
            x = rng.random()
            snap = bool(rng.random() < 0.25)
            if x < 0.06:
                # a mid-transaction stall: widens the (read_version,
                # commit) window so concurrent commits land inside it —
                # the only way the conflict/abort paths get real traffic
                ops.append(("delay", float(rng.uniform(0.01, 0.08))))
            elif x < 0.20:
                ops.append(("get", self._dkey(rng), snap))
            elif x < 0.40:
                b, e = self._drange(rng)
                limit = (
                    int(rng.integers(1, 5))
                    if rng.random() < 0.45 else 1 << 30
                )
                ops.append(
                    ("range", b, e, limit, bool(rng.random() < 0.35), snap)
                )
            elif x < 0.60:
                ops.append(
                    ("set", self._dkey(rng), b"%d.%d.%d" % (actor, n, i))
                )
            elif x < 0.67:
                b, e = self._drange(rng)
                if b == PREFIX:  # clears stay inside the data subspace
                    b, e = DATA, DATA + b"\xff"
                ops.append(("clear_range", b, e))
            elif x < 0.79:
                aop = _ATOMIC_CHOICES[
                    int(rng.integers(0, len(_ATOMIC_CHOICES)))
                ]
                param = (
                    int(rng.integers(1, 50)).to_bytes(8, "little")
                    if aop in ("add", "max", "min")
                    else b"%d.%d" % (int(rng.integers(0, 9)), i)
                )
                ops.append(("atomic", aop, self._dkey(rng), param))
            elif x < 0.85:
                b, e = self._drange(rng)
                kind = "rcr" if rng.random() < 0.5 else "wcr"
                ops.append((kind, b, e))
            elif x < 0.90:
                k = (
                    self._dkey(rng) if rng.random() < 0.5
                    else VS + b"v%02d" % int(rng.integers(0, 8))
                )
                ops.append(("vs_value", k, b"s%d." % actor))
            elif x < 0.94:
                ops.append((
                    "vs_key", VS + b"k%d/" % actor, b"/%03d" % n,
                    b"%d.%d" % (actor, n),
                ))
            else:
                a = bytes([int(rng.integers(0, 255))])
                b = bytes([int(rng.integers(0, 255))])
                lo, hi = (a, b) if a < b else (b, a + b"\xff")
                ops.append((
                    "sysread",
                    SD.KEY_SERVERS_PREFIX + lo,
                    SD.KEY_SERVERS_PREFIX + hi,
                ))
        return ops

    # -- execution --------------------------------------------------------

    async def _attempt(self, actor: int, n: int, ops: list) -> TxnRecord:
        from foundationdb_tpu_torch.cluster import system_data as SD

        txn = self.db.create_transaction()
        rec = TxnRecord(actor=actor, n=n)
        mutating = any(op[0] in _MUTATING for op in ops)
        try:
            for op in ops:
                kind = op[0]
                if kind == "delay":
                    await self.sched.delay(op[1])
                elif kind == "get":
                    _, k, snap = op
                    rec.ops.append((op, await txn.get(k, snapshot=snap)))
                elif kind == "range":
                    _, b, e, limit, rev, snap = op
                    rows = await txn.get_range(
                        b, e, limit=limit, snapshot=snap, reverse=rev
                    )
                    rec.ops.append((op, tuple(rows)))
                elif kind == "sysread":
                    _, b, e = op
                    rows = await txn.get_range(b, e, snapshot=True)
                    for k, v in rows:
                        assert b <= k < e, (
                            f"seed {self.seed}: keyServers scan "
                            f"[{b!r}, {e!r}) returned out-of-range "
                            f"key {k!r}"
                        )
                        SD.decode_key_servers_value(v)
                    code_probe(True, "workload.api_system_read_checked")
                    rec.ops.append((op, None))
                elif kind == "set":
                    _, k, v = op
                    txn.set(k, v)
                    rec.ops.append((op, None))
                elif kind == "clear_range":
                    _, b, e = op
                    txn.clear_range(b, e)
                    rec.ops.append((op, None))
                elif kind == "atomic":
                    _, aop, k, param = op
                    txn.atomic_op(aop, k, param)
                    rec.ops.append((op, None))
                elif kind == "rcr":
                    _, b, e = op
                    txn.add_read_conflict_range(b, e)
                    rec.ops.append((op, None))
                elif kind == "wcr":
                    _, b, e = op
                    txn.add_write_conflict_range(b, e)
                    rec.ops.append((op, None))
                elif kind == "vs_value":
                    _, k, vpre = op
                    txn.set_versionstamped_value(k, vpre)
                    rec.ops.append((op, None))
                elif kind == "vs_key":
                    _, kpre, suffix, value = op
                    txn.set_versionstamped_key(kpre, suffix, value)
                    rec.ops.append((op, None))
                else:
                    raise ValueError(f"unknown op {op!r}")
            if mutating:
                rec.marker_key = MARKER + b"%d/%05d" % (actor, n)
                txn.set_versionstamped_value(rec.marker_key, b"")
            version = await txn.commit()
            rec.version = version
            if mutating:
                rec.outcome = "acked"
                rec.stamp = txn.versionstamp
                assert rec.stamp is not None and int.from_bytes(
                    rec.stamp[:8], "big"
                ) == version, (
                    f"seed {self.seed}: commit reply stamp "
                    f"{rec.stamp!r} disagrees with version {version}"
                )
            else:
                rec.outcome = "readonly"
        except self._unknown:
            rec.outcome = "unknown"
        except self._conflict:
            rec.outcome = "conflict"
        except self._too_old:
            rec.outcome = "too_old"
        except self._retryable:
            rec.outcome = "retryable"
        rec.read_version = txn._read_version
        rec.read_conflicts = list(txn.read_conflicts)
        rec.write_conflicts = list(txn.write_conflicts)
        rec.mutations = list(txn.mutations)
        self.stats[rec.outcome] += 1
        return rec

    async def _actor(self, actor: int) -> None:
        rng = np.random.default_rng(self.seed ^ (0x0A91 + actor * 7919))
        for n in range(self.rounds):
            ops = self._gen_ops(rng, actor, n)
            rec = await self._attempt(actor, n, ops)
            self.records.append(rec)
            if rec.outcome in ("unknown", "conflict", "too_old", "retryable"):
                await self.sched.delay(0.01)
            if rng.random() < 0.3:
                await self.sched.delay(float(rng.uniform(0.005, 0.03)))

    def actor_coros(self) -> list:
        return [self._actor(i) for i in range(self.actors)]

    # -- verification -----------------------------------------------------

    async def _stable_read(self) -> dict:
        for _ in range(40):
            txn = self.db.create_transaction()
            try:
                return dict(await txn.get_range(
                    PREFIX, PREFIX_END, snapshot=True
                ))
            except self._retryable:
                await self.sched.delay(0.05)
        raise AssertionError(
            f"seed {self.seed}: api verify never got a stable read"
        )

    def corrupt_for_selftest(self, cluster) -> None:
        """Divergence-injection hook (the gate's self-test, mirroring
        run_seed's _inject_fault): flip the latest stored value of every
        api data key on every replica, BYPASSING the transaction system.
        verify() must then fail the seed."""
        for ss in cluster.storage_servers:
            for key in list(ss._hist):
                if key.startswith(DATA):
                    hist = ss._hist[key]
                    if hist and hist[-1][1] is not None:
                        v, val = hist[-1]
                        hist[-1] = (v, val + b"\xfe!corrupt")

    async def verify(self) -> None:
        final = await self._stable_read()

        # -- resolve outcomes: markers turn ambiguity into certainty ----
        committed: list[tuple[bytes, TxnRecord]] = []
        for rec in self.records:
            stamp = None
            if rec.outcome == "acked":
                stamp = rec.stamp
                got = final.get(rec.marker_key)
                assert got == stamp, (
                    f"seed {self.seed}: marker {rec.marker_key!r} holds "
                    f"{got!r}, commit reply said {stamp!r}"
                )
            elif rec.outcome == "unknown" and rec.marker_key is not None:
                got = final.get(rec.marker_key)
                if got is not None:
                    assert len(got) == 10, (
                        f"seed {self.seed}: marker {rec.marker_key!r} "
                        f"is not a 10-byte stamp: {got!r}"
                    )
                    stamp = got
                    self.stats["unknown_resolved"] += 1
                    code_probe(True, "workload.api_unknown_resolved")
            if stamp is not None:
                committed.append((stamp, rec))
        committed.sort(key=lambda sr: sr[0])

        # -- replay into the sequential model ---------------------------
        from foundationdb_tpu_torch.testing.oracle import SequentialModel

        model = SequentialModel()
        for stamp, rec in committed:
            model.apply(stamp, rec.mutations)

        # -- final-state equality: lost writes AND phantom writes -------
        expect = model.final_state()
        if final != expect:
            diff = {
                k: (final.get(k), expect.get(k))
                for k in set(final) | set(expect)
                if final.get(k) != expect.get(k)
            }
            raise AssertionError(
                f"seed {self.seed}: api model divergence in final state "
                f"(actual, model), {len(diff)} key(s): "
                f"{dict(sorted(diff.items())[:6])}"
            )

        # -- every recorded read, re-executed against the model ---------
        for rec in self.records:
            if rec.read_version is not None:
                self._check_txn(rec, model)

        # -- commit/abort decision audit --------------------------------
        self._check_decisions(committed)
        code_probe(True, "workload.api_model_checked")

    def _check_txn(self, rec: TxnRecord, model) -> None:
        view = _TxnView(model.state_at(rec.read_version))
        exp_rcr, exp_wcr, exp_muts = [], [], []
        seed = self.seed
        for op, obs in rec.ops:
            kind = op[0]
            if kind == "get":
                _, k, snap = op
                if not snap and not view.known(k):
                    exp_rcr.append((k, key_after(k)))
                expected = view.get(k)
                assert obs == expected, (
                    f"seed {seed}: txn {rec.actor}/{rec.n} "
                    f"({rec.outcome}) get({k!r}) at rv={rec.read_version} "
                    f"observed {obs!r}, model says {expected!r}"
                )
                self.stats["reads_checked"] += 1
            elif kind == "range":
                _, b, e, limit, rev, snap = op
                full = view.range(b, e)
                truncated = limit < len(full)
                if rev:
                    sel = full[len(full) - limit:] if truncated else full
                    expected = list(reversed(sel))
                else:
                    expected = full[:limit]
                assert list(obs) == expected, (
                    f"seed {seed}: txn {rec.actor}/{rec.n} "
                    f"({rec.outcome}) get_range({b!r}, {e!r}, "
                    f"limit={limit}, reverse={rev}) at "
                    f"rv={rec.read_version} observed {list(obs)!r}, "
                    f"model says {expected!r}"
                )
                if not snap:
                    if not truncated:
                        exp_rcr.append((b, e))
                    elif rev:
                        exp_rcr.append((expected[-1][0], e))
                    else:
                        exp_rcr.append((b, key_after(expected[-1][0])))
                if rev:
                    code_probe(True, "workload.api_reverse_checked")
                self.stats["reads_checked"] += 1
            elif kind == "set":
                _, k, v = op
                view.set(k, v)
                exp_wcr.append((k, key_after(k)))
                exp_muts.append(("set", k, v))
            elif kind == "clear_range":
                _, b, e = op
                view.clear(b, e)
                exp_wcr.append((b, e))
                exp_muts.append(("clear", b, e))
            elif kind == "atomic":
                _, aop, k, param = op
                view.atomic(aop, k, param)
                exp_wcr.append((k, key_after(k)))
                exp_muts.append(("atomic", aop, k, param))
            elif kind == "rcr":
                _, b, e = op
                exp_rcr.append((b, e))
            elif kind == "wcr":
                _, b, e = op
                exp_wcr.append((b, e))
            elif kind == "vs_value":
                _, k, vpre = op
                view.vs_value(k)
                exp_wcr.append((k, key_after(k)))
                exp_muts.append(("vs_value", k, vpre))
            elif kind == "vs_key":
                _, kpre, suffix, value = op
                exp_wcr.append((kpre, kpre + b"\xff" * 11))
                exp_muts.append(("vs_key", kpre, suffix, value))
            elif kind == "sysread":
                pass  # materialized schema reads add no conflicts
        if rec.marker_key is not None:
            exp_wcr.append((rec.marker_key, key_after(rec.marker_key)))
            exp_muts.append(("vs_value", rec.marker_key, b""))
        # the client conflict-range/mutation encoding contract
        assert sorted(set(exp_rcr)) == sorted(set(rec.read_conflicts)), (
            f"seed {seed}: txn {rec.actor}/{rec.n} read-conflict contract: "
            f"client sent {sorted(set(rec.read_conflicts))!r}, ops imply "
            f"{sorted(set(exp_rcr))!r}"
        )
        assert sorted(set(exp_wcr)) == sorted(set(rec.write_conflicts)), (
            f"seed {seed}: txn {rec.actor}/{rec.n} write-conflict contract: "
            f"client sent {sorted(set(rec.write_conflicts))!r}, ops imply "
            f"{sorted(set(exp_wcr))!r}"
        )
        assert exp_muts == rec.mutations, (
            f"seed {seed}: txn {rec.actor}/{rec.n} mutation contract: "
            f"client sent {rec.mutations!r}, ops imply {exp_muts!r}"
        )

    def _check_decisions(self, committed: list) -> None:
        infos = [
            (
                stamp,
                int.from_bytes(stamp[:8], "big"),
                sorted(set(rec.write_conflicts)),
                rec,
            )
            for stamp, rec in committed
        ]
        for i, (stamp, _ver, _wcr, rec) in enumerate(infos):
            if rec.read_version is None:
                continue
            rcr = sorted(set(rec.read_conflicts))
            if not rcr:
                continue
            for o_stamp, o_ver, o_wcr, o_rec in infos[:i]:
                if o_ver <= rec.read_version:
                    continue
                hit = _overlap(rcr, o_wcr)
                if hit:
                    raise AssertionError(
                        f"seed {self.seed}: FALSE COMMIT: txn "
                        f"{rec.actor}/{rec.n} committed at {stamp!r} with "
                        f"read range {hit[0]!r} despite txn "
                        f"{o_rec.actor}/{o_rec.n}'s committed write "
                        f"{hit[1]!r} at {o_stamp!r} > rv="
                        f"{rec.read_version}"
                    )
        if self.strict_aborts and not any(
            r.outcome == "unknown" for r in self.records
        ):
            for rec in self.records:
                if rec.outcome != "conflict" or rec.read_version is None:
                    continue
                rcr = sorted(set(rec.read_conflicts))
                explained = any(
                    o_ver > rec.read_version and _overlap(rcr, o_wcr)
                    for _s, o_ver, o_wcr, _r in infos
                )
                assert explained, (
                    f"seed {self.seed}: FALSE ABORT: txn "
                    f"{rec.actor}/{rec.n} got not_committed at rv="
                    f"{rec.read_version} but no committed write ever "
                    f"intersects its read ranges {rcr!r}"
                )

    def signature(self) -> tuple:
        s = self.stats
        return (
            s["acked"], s["readonly"], s["unknown"], s["conflict"],
            s["too_old"], s["retryable"], s["unknown_resolved"],
            s["reads_checked"],
        )
