"""Hot-key and hot-tag sampling, and the key-sample sensor block (the
port's own copy of foundationdb_tpu.cluster.sampling: the byteSample
`ByteSample` with its treap, the busiest-tag tracker `TagCounter`,
`tag_of_key`, the reference knobs, `KEY_SAMPLE_LIMIT`,
`decay_key_sample`, `printable`, `key_sample_qos` and
`attribute_hotspot`).

* ByteSample is StorageMetrics' byteSample
  (fdbserver/StorageMetrics.actor.cpp `isKeyValueInSample`): a written
  key is sampled with probability in proportion to its key+value size
  and stored with the weight that keeps the sample's sum an unbiased
  estimate of the bytes over any key range. Membership comes from a
  keyed hash of the key, so the sample is a pure function of (seed,
  key, size); a wire role seeds it from wall entropy.
* TagCounter is the busiest read/write tag tracker
  (fdbserver/TransactionTagCounter.cpp): per-tag decayed byte rates in
  a bounded table, the top tags and each one's share.
* Tags come from key prefixes (`tenant/...`) at the sensor, so no wire
  frame carries a tag.

The Storage role and the ProxyPipeline report these sensors;
`attribute_hotspot` is the hotspot drill's verdict over an assembled
status document (testing/hotspot.py).
"""

from __future__ import annotations

import hashlib
import struct
from typing import Iterator, Optional

from foundationdb_tpu_torch.utils.probes import code_probe, declare

declare(
    "sampling.byte_sample_gc",
    "sampling.hot_range_attributed",
    "sampling.tag_counter_rollover",
)

#: reference knobs (Knobs.cpp BYTE_SAMPLING_FACTOR / _OVERHEAD): a
#: key+value of `size` bytes is sampled w.p.
#: size / ((key_len + OVERHEAD) * FACTOR)
BYTE_SAMPLING_FACTOR = 250
BYTE_SAMPLING_OVERHEAD = 100
#: sample entries per storage role before the deterministic halving GC
BYTE_SAMPLE_CAPACITY = 32768

#: tag-prefix derivation: `tenant/rest-of-key` -> tag "tenant"
TAG_SEPARATOR = b"/"
MAX_TAG_LENGTH = 24
#: the tenant layer's TENANT_DATA_PREFIX (the tenant layer is not ported)
_TENANT_DATA_PREFIX = b"\x1e"

#: a top-1 tag/range owning at least this fraction of traffic is a
#: HOTSPOT; a uniform workload over >= 3 tags/ranges sits well below it
DOMINANCE_FRAC = 0.5
#: minimum sampled keys behind a hot-RANGE verdict: a 2-key sample can
#: put half its weight anywhere — that's noise, not skew (the tag
#: channel has no such floor; its rates integrate every byte)
HOT_RANGE_MIN_KEYS = 8


def tag_of_key(key: bytes) -> Optional[str]:
    """The transaction tag a key's traffic accrues to: the prefix
    before the first `/` (tenant-layer convention; the `\\x1e` tenant
    data prefix is stripped first). Keys without a short prefix are
    untagged (None) — they count toward totals but never toward a
    tag, so an unprefixed workload can't fake a busiest tag."""
    if key[:1] == _TENANT_DATA_PREFIX:
        key = key[1:]
    i = key.find(TAG_SEPARATOR, 0, MAX_TAG_LENGTH + 1)
    if i <= 0:
        return None
    return printable(key[:i])


def _hash_channels(seed: int, key: bytes) -> tuple[float, int]:
    """Two independent deterministic channels from one keyed digest:
    (membership uniform in [0, 1), treap priority int)."""
    d = hashlib.blake2b(
        key, digest_size=16, key=struct.pack("<Q", seed & (2**64 - 1))
    ).digest()
    u = int.from_bytes(d[:8], "little") / 2.0**64
    prio = int.from_bytes(d[8:], "little")
    return u, prio


# ---------------------------------------------------------------------------
# The augmented treap: ordered map key -> weight with subtree sums.


class _Node:
    __slots__ = ("key", "size", "p", "u", "prio", "weight", "sum",
                 "count", "left", "right")

    def __init__(self, key: bytes, size: int, p: float, u: float,
                 prio: int, weight: float):
        self.key = key
        self.size = size
        self.p = p
        self.u = u
        self.prio = prio
        self.weight = weight
        self.sum = weight
        self.count = 1
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None


def _upd(n: _Node) -> _Node:
    n.sum = n.weight
    n.count = 1
    if n.left is not None:
        n.sum += n.left.sum
        n.count += n.left.count
    if n.right is not None:
        n.sum += n.right.sum
        n.count += n.right.count
    return n


def _merge(a: Optional[_Node], b: Optional[_Node]) -> Optional[_Node]:
    if a is None:
        return b
    if b is None:
        return a
    if a.prio >= b.prio:
        a.right = _merge(a.right, b)
        return _upd(a)
    b.left = _merge(a, b.left)
    return _upd(b)


def _split(n: Optional[_Node], key: bytes):
    """(keys < key, keys >= key)."""
    if n is None:
        return None, None
    if n.key < key:
        l, r = _split(n.right, key)
        n.right = l
        return _upd(n), r
    l, r = _split(n.left, key)
    n.left = r
    return l, _upd(n)


def _walk(n: Optional[_Node]) -> Iterator[_Node]:
    if n is None:
        return
    yield from _walk(n.left)
    yield n
    yield from _walk(n.right)


class ByteSample:
    """Deterministic size-proportional key sample with O(log n)
    sampled-bytes-in-range queries (the StorageMetrics byteSample)."""

    def __init__(self, seed: Optional[int] = None, *,
                 factor: int = BYTE_SAMPLING_FACTOR,
                 overhead: int = BYTE_SAMPLING_OVERHEAD,
                 capacity: int = BYTE_SAMPLE_CAPACITY):
        if seed is None:
            # wire roles: wall entropy, like the reference's per-process
            # hash salt (sim roles MUST pass their derived seed)
            import os

            seed = int.from_bytes(os.urandom(8), "little")  # flowcheck: ignore[determinism]
        self.seed = seed & (2**64 - 1)
        self.factor = factor
        self.overhead = overhead
        self.capacity = capacity
        #: global membership scale: halved by each GC round so the
        #: sample re-converges to capacity instead of thrashing
        self.scale = 1.0
        self.gc_rounds = 0
        self.writes_seen = 0
        self._root: Optional[_Node] = None

    # -- mutation hooks ----------------------------------------------------

    def note_write(self, key: bytes, value: bytes = b"") -> None:
        """A set/atomic landed: resample the key at its new size (the
        old entry, if any, is replaced — sizes change on overwrite)."""
        self.writes_seen += 1
        size = len(key) + len(value)
        p = size / ((len(key) + self.overhead) * self.factor)
        u, prio = _hash_channels(self.seed, key)
        self.erase(key)
        eff = p * self.scale
        if u < eff:
            weight = size / min(1.0, eff)
            l, r = _split(self._root, key)
            self._root = _merge(
                _merge(l, _Node(key, size, p, u, prio, weight)), r
            )
            if self.count > self.capacity:
                self._gc()

    def erase(self, key: bytes) -> None:
        l, r = _split(self._root, key)
        m, r = _split(r, key + b"\x00")
        del m  # the exact-key node, if sampled
        self._root = _merge(l, r)

    def erase_range(self, begin: bytes, end: bytes) -> None:
        l, r = _split(self._root, begin)
        _m, r = _split(r, end)
        self._root = _merge(l, r)

    # -- queries -----------------------------------------------------------

    @property
    def count(self) -> int:
        return self._root.count if self._root is not None else 0

    def total_bytes(self) -> int:
        return int(round(self._root.sum)) if self._root is not None else 0

    def sampled_bytes(self, begin: bytes = b"",
                      end: Optional[bytes] = None) -> int:
        """Estimated true bytes in [begin, end) (end=None: to +inf) —
        the subtree weight sum, O(log n) via two splits."""
        l, r = _split(self._root, begin)
        if end is None:
            m, rest = r, None
        else:
            m, rest = _split(r, end)
        total = m.sum if m is not None else 0.0
        self._root = _merge(_merge(l, m), rest)
        return int(round(total))

    def items(self) -> list[tuple[bytes, float]]:
        """(key, weight) in key order — O(n); status-poll cadence."""
        return [(n.key, n.weight) for n in _walk(self._root)]

    def hot_ranges(self, max_ranges: int = 8) -> list[dict]:
        """Sampled-byte density grouped by key prefix (tag prefix when
        present, first-byte bucket otherwise): the keyspace heatmap's
        rows, sorted hottest first. `frac` is each range's share of
        this sample's total weight."""
        groups: dict[str, list] = {}
        for n in _walk(self._root):
            label = tag_of_key(n.key)
            if label is None:
                label = "%02x" % n.key[0] if n.key else ""
            g = groups.get(label)
            if g is None:
                groups[label] = [n.weight, n.key, n.key, 1]
            else:
                g[0] += n.weight
                g[3] += 1
                if n.key > g[2]:
                    g[2] = n.key
        total = sum(g[0] for g in groups.values())
        rows = [
            {
                "range": label,
                "begin": printable(g[1]),
                "end": printable(g[2]),
                "bytes": int(round(g[0])),
                "keys": g[3],
                "frac": round(g[0] / total, 4) if total > 0 else 0.0,
            }
            for label, g in groups.items()
        ]
        rows.sort(key=lambda r: (-r["bytes"], r["range"]))
        return rows[:max_ranges]

    # -- GC ----------------------------------------------------------------

    def _gc(self) -> None:
        """Deterministic down-sampling: halve the membership scale and
        keep exactly the entries whose hash still clears it — the
        surviving sample is the sample a half-rate collector would have
        built, weights doubled accordingly."""
        while self.count > self.capacity:
            code_probe(True, "sampling.byte_sample_gc")
            before = self.count
            self.scale /= 2.0
            self.gc_rounds += 1
            survivors = [
                n for n in _walk(self._root)
                if n.u < n.p * self.scale
            ]
            self._root = None
            for n in survivors:
                eff = n.p * self.scale
                node = _Node(n.key, n.size, n.p, n.u, n.prio,
                             n.size / min(1.0, eff))
                l, r = _split(self._root, n.key)
                self._root = _merge(_merge(l, node), r)
            from foundationdb_tpu_torch.utils.trace import TraceEvent

            TraceEvent("ByteSampleGC").detail(
                "Before", before
            ).detail("After", self.count).detail(
                "Scale", self.scale
            ).log()

    # -- checkpoint / resume ----------------------------------------------

    def snapshot(self) -> dict:
        """Durable state for a storage reboot (hash channels recompute
        from the seed, so only sizes need persisting)."""
        return {
            "seed": self.seed,
            "factor": self.factor,
            "overhead": self.overhead,
            "capacity": self.capacity,
            "scale": self.scale,
            "gc_rounds": self.gc_rounds,
            "writes_seen": self.writes_seen,
            "items": [(n.key, n.size) for n in _walk(self._root)],
        }

    def restore(self, snap: dict) -> None:
        self.seed = snap["seed"]
        self.factor = snap["factor"]
        self.overhead = snap["overhead"]
        self.capacity = snap["capacity"]
        self.scale = snap["scale"]
        self.gc_rounds = snap["gc_rounds"]
        self.writes_seen = snap["writes_seen"]
        self._root = None
        for key, size in snap["items"]:
            p = size / ((len(key) + self.overhead) * self.factor)
            u, prio = _hash_channels(self.seed, key)
            eff = p * self.scale
            node = _Node(key, size, p, u, prio,
                         size / min(1.0, eff))
            l, r = _split(self._root, key)
            self._root = _merge(_merge(l, node), r)


# ---------------------------------------------------------------------------
# TransactionTagCounter: top-K busiest tags by smoothed byte rate.


class TagCounter:
    """Bounded per-tag byte-rate tracker (the reference's
    TransactionTagCounter). Sim roles inject the virtual clock
    (`clock=sched.now`); wire roles omit it and get TimerSmoother."""

    def __init__(self, *, k: int = 4, capacity: int = 32,
                 folding_time: float = 5.0, clock=None):
        self.k = k
        self.capacity = capacity
        self.folding_time = folding_time
        self._clock = clock
        self._rates: dict[str, object] = {}
        self._total = self._new_smoother()
        self.rollovers = 0
        self.notes = 0
        #: deterministic lifetime byte counter (the perf-ledger input:
        #: no smoothing, so it is a pure function of the workload)
        self.bytes_noted = 0

    def _new_smoother(self):
        from foundationdb_tpu_torch.utils.metrics import Smoother, TimerSmoother

        if self._clock is not None:
            return Smoother(self.folding_time, clock=self._clock)
        return TimerSmoother(self.folding_time)

    def note(self, tag: Optional[str], nbytes: int) -> None:
        self.notes += 1
        self.bytes_noted += nbytes
        self._total.add_delta(nbytes)
        if tag is None:
            return
        sm = self._rates.get(tag)
        if sm is None:
            if len(self._rates) >= self.capacity:
                self._rollover()
            sm = self._rates[tag] = self._new_smoother()
        sm.add_delta(nbytes)

    def _rollover(self) -> None:
        """Tag table overflow: evict the colder half (ties broken by
        name — deterministic under the virtual clock)."""
        code_probe(True, "sampling.tag_counter_rollover")
        ranked = sorted(
            self._rates.items(),
            key=lambda kv: (kv[1].smooth_rate(), kv[0]),
        )
        for tag, _sm in ranked[: max(1, len(ranked) // 2)]:
            del self._rates[tag]
        self.rollovers += 1

    def top(self, k: Optional[int] = None) -> list[dict]:
        total = self._total.smooth_rate()
        rows = sorted(
            (
                {
                    "tag": tag,
                    "bytes_per_s": round(sm.smooth_rate(), 3),
                    "frac": (
                        round(sm.smooth_rate() / total, 4)
                        if total > 1e-12 else 0.0
                    ),
                }
                for tag, sm in self._rates.items()
            ),
            key=lambda r: (-r["bytes_per_s"], r["tag"]),
        )
        return rows[: (k if k is not None else self.k)]

    def busiest(self) -> dict:
        """The top-1 row — schema-stable: always a dict, tag None when
        nothing tagged has flowed yet (fdbtop pins the field)."""
        rows = self.top(1)
        if not rows:
            return {"tag": None, "bytes_per_s": 0.0, "frac": 0.0}
        return rows[0]


# ---------------------------------------------------------------------------
# Conflict-range key sample: the Resolver roles' qos block.

#: key-sample capacity before decay
KEY_SAMPLE_LIMIT = 4096


def decay_key_sample(sample: dict, limit: int = KEY_SAMPLE_LIMIT) -> None:
    """In place: halve every count, dropping zeros; if the key set is
    still too wide, keep the heaviest half. Hot boundaries survive the
    decay while memory stays O(limit)."""
    kept = {k: c // 2 for k, c in sample.items() if c // 2 > 0}
    if len(kept) > limit:
        top = sorted(kept.items(), key=lambda kv: -kv[1])
        kept = dict(top[: limit // 2])
    sample.clear()
    sample.update(kept)


def printable(key: bytes) -> str:
    """JSON/terminal-safe rendering of a key: ascii stays, everything
    else escapes."""
    return "".join(
        chr(c) if 32 <= c < 127 else "\\x%02x" % c for c in key
    )


def key_sample_qos(sample: dict, top_n: int = 4) -> dict:
    """The key-sample sensor block: sample width plus the top
    conflict-range begin keys by touch count (printable, bounded)."""
    top = sorted(sample.items(), key=lambda kv: (-kv[1], kv[0]))[:top_n]
    return {
        "keys": len(sample),
        "top": [{"key": printable(k), "count": c} for k, c in top],
    }


# ---------------------------------------------------------------------------
# Attribution: the skew-drill gate's verdict from an assembled status.


def attribute_hotspot(status: dict, *,
                      threshold: float = DOMINANCE_FRAC) -> dict:
    """Name the dominant tag/range from a status document's cluster
    rollup, or nothing: a top-1 owning >= `threshold` of its traffic
    is attributed, anything flatter is not. Both the zipf drill (must
    attribute the injected tenant) and the uniform drill (must NOT)
    gate on this one rule."""
    cluster = status.get("cluster", status) or {}
    tags = cluster.get("busiest_tags") or []
    ranges = cluster.get("hot_ranges") or []
    hot_tag = (
        tags[0] if tags and tags[0].get("frac", 0.0) >= threshold
        else None
    )
    hot_range = (
        ranges[0]
        if ranges
        and ranges[0].get("frac", 0.0) >= threshold
        # support floor: a near-empty byte sample puts large fractions
        # behind single keys — no verdict without HOT_RANGE_MIN_KEYS
        and ranges[0].get("keys", HOT_RANGE_MIN_KEYS) >= HOT_RANGE_MIN_KEYS
        else None
    )
    attributed = hot_tag is not None or hot_range is not None
    code_probe(attributed, "sampling.hot_range_attributed")
    if attributed:
        from foundationdb_tpu_torch.utils.trace import TraceEvent

        TraceEvent("HotRangeAttributed").detail(
            "Tag", hot_tag["tag"] if hot_tag else None
        ).detail(
            "Range", hot_range["range"] if hot_range else None
        ).log()
    return {
        "attributed": attributed,
        "hot_tag": hot_tag,
        "hot_range": hot_range,
        "threshold": threshold,
    }
