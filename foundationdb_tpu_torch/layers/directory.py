"""The directory layer: hierarchical namespaces over short key prefixes.

Behavioral mirror of the reference bindings' DirectoryLayer
(bindings/python/fdb/directory_impl.py and friends): a directory maps a
path like ("app", "users") to a short allocated prefix, stored in a
node subtree under `\\xfe`; contents live under the allocated prefix via
a Subspace. create/open/move/remove/list compose transactionally with
ordinary operations.

Prefix allocation uses the HCA (high-contention allocator — the
bindings' HighContentionAllocator): a windowed candidate scheme where
concurrent allocators pick RANDOM candidates in the current window and
conflict only when they pick the same one — the window's usage counter
advances via atomic adds (conflict-free) and the window slides forward
once half-used. A transactional fallback counter remains available via
use_hca=False.

The port's own copy of foundationdb_tpu.layers.directory.
"""

from __future__ import annotations

from typing import Optional

from foundationdb_tpu_torch.layers import tuple as fdbtuple
from foundationdb_tpu_torch.layers.tuple import Subspace

NODE_PREFIX = b"\xfe"
COUNTER_KEY = NODE_PREFIX + b"hca"
HCA_COUNTERS = NODE_PREFIX + b"hca/c/"   # window start -> usage count
HCA_RECENT = NODE_PREFIX + b"hca/r/"     # candidate -> taken marker


class HighContentionAllocator:
    """The bindings' HCA: windowed random-candidate allocation.

    * The current window [start, start+size) has a usage counter at
      HCA_COUNTERS+start bumped by ATOMIC add — no read conflict, so
      concurrent allocators never conflict on the counter.
    * Each allocator picks a RANDOM free candidate in the window and
      claims it with a write conflict on that single key: two
      allocations conflict only if they picked the same candidate.
    * When the window is half-used, it slides forward (old counters and
      claims cleared); window sizes grow with the keyspace exactly like
      the reference (64 / 1024 / 8192).
    """

    def __init__(self, rng=None):
        import os

        import numpy as np

        # Per-instance entropy by default: concurrent allocators (separate
        # clients/processes) must draw DIFFERENT candidate sequences or
        # they always collide on the same candidate and the random-probe
        # contention avoidance — the HCA's whole point — degenerates to a
        # serial counter (the reference bindings use random.randrange).
        # The deterministic simulator/soak injects a seeded rng explicitly.
        self.rng = rng if rng is not None else np.random.default_rng(
            # real-client default only: the sim/soak always injects a
            # seeded rng (see docstring above)
            int.from_bytes(os.urandom(8), "little")  # flowcheck: ignore[determinism.unseeded-random]
        )

    @staticmethod
    def _window_size(start: int) -> int:
        if start < 255:
            return 64
        if start < 65535:
            return 1024
        return 8192

    @staticmethod
    def _slide(txn, new_start: int) -> None:
        """Advance the window: clear only BELOW the new start — a
        concurrent allocator may already hold a claim in the new window,
        and wiping it would let its candidate be handed out twice (the
        bindings clear [_, start) the same way)."""
        txn.clear_range(
            HCA_COUNTERS, HCA_COUNTERS + fdbtuple.pack((new_start,))
        )
        txn.clear_range(
            HCA_RECENT, HCA_RECENT + fdbtuple.pack((new_start,))
        )
        txn.atomic_op(
            "add",
            HCA_COUNTERS + fdbtuple.pack((new_start,)),
            (0).to_bytes(8, "little"),
        )

    async def allocate(self, txn) -> int:
        # migration guard: values the legacy transactional counter
        # already handed out (the pre-HCA allocator) are consumed —
        # never open a window below them
        legacy_raw = await txn.get(COUNTER_KEY, snapshot=True)
        legacy = int.from_bytes(legacy_raw, "little") if legacy_raw else 0
        while True:
            start, count = await self._current_window(txn)
            if start < legacy:
                self._slide(txn, legacy)
                continue
            size = self._window_size(start)
            if (count + 1) * 2 >= size:
                self._slide(txn, start + size)
                continue
            txn.atomic_op(
                "add",
                HCA_COUNTERS + fdbtuple.pack((start,)),
                (1).to_bytes(8, "little"),
            )
            for _ in range(size):
                candidate = start + int(self.rng.integers(0, size))
                ck = HCA_RECENT + fdbtuple.pack((candidate,))
                # CONFLICT-ADDING read on just this candidate key: two
                # transactions claiming the same candidate collide via
                # the read-write conflict (write-write alone would NOT
                # conflict under OCC and both would commit — the
                # bindings' HCA reads the candidate non-snapshot for
                # exactly this reason); different candidates never touch
                taken = await txn.get(ck)
                if taken is None:
                    txn.set(ck, b"")
                    return candidate
            # window exhausted under contention: slide and retry
            self._slide(txn, start + size)

    async def _current_window(self, txn):
        """Newest counter key (snapshot read: windows are shared state)."""
        rows = await txn.get_range(
            HCA_COUNTERS, HCA_COUNTERS + b"\xff", snapshot=True
        )
        if not rows:
            return 0, 0
        key, val = rows[-1]
        (start,) = fdbtuple.unpack(key[len(HCA_COUNTERS):])
        return int(start), int.from_bytes(val or b"", "little") if val else 0


class DirectoryAlreadyExists(Exception):
    pass


class DirectoryDoesNotExist(Exception):
    pass


class DirectorySubspace(Subspace):
    def __init__(self, path: tuple, prefix: bytes, layer: "DirectoryLayer"):
        super().__init__((), prefix)
        self.path = path
        self._layer = layer

    async def create_or_open(self, txn, subpath) -> "DirectorySubspace":
        return await self._layer.create_or_open(
            txn, self.path + tuple(subpath)
        )

    async def list(self, txn) -> list:
        return await self._layer.list(txn, self.path)


class DirectoryLayer:
    def __init__(self, *, use_hca: bool = True, rng=None):
        self.use_hca = use_hca
        self._hca = HighContentionAllocator(rng) if use_hca else None
        self._nodes = Subspace((), NODE_PREFIX)

    def _node_key(self, path: tuple) -> bytes:
        return self._nodes.pack(("node",) + tuple(path))

    async def _allocate_prefix(self, txn) -> bytes:
        if self._hca is not None:
            n = await self._hca.allocate(txn)
        else:
            # fallback: transactional monotonic counter (serializes all
            # concurrent allocations through one conflict key). Unsafe on
            # a database the HCA already touched: the counter never
            # advances past HCA claims, so it would re-hand-out prefixes
            # the HCA allocated — silent data corruption. Refuse loudly.
            hca_rows = await txn.get_range(
                HCA_COUNTERS, HCA_COUNTERS + b"\xff", limit=1
            )
            if hca_rows:
                raise RuntimeError(
                    "DirectoryLayer(use_hca=False) on a database already "
                    "allocated by the HCA: the legacy counter could hand "
                    "out prefixes the HCA has claimed. Open with "
                    "use_hca=True."
                )
            raw = await txn.get(COUNTER_KEY)
            n = int.from_bytes(raw, "little") if raw else 0
            txn.set(COUNTER_KEY, (n + 1).to_bytes(8, "little"))
        # short prefixes under \x15... (tuple-int region), like the HCA's
        return b"\x15" + fdbtuple.pack((n,))

    # -- operations -------------------------------------------------------

    async def find(self, txn, path) -> Optional[DirectorySubspace]:
        prefix = await txn.get(self._node_key(tuple(path)))
        if prefix is None:
            return None
        return DirectorySubspace(tuple(path), prefix, self)

    async def create(self, txn, path, *, prefix: bytes = None) -> DirectorySubspace:
        path = tuple(path)
        if await self.find(txn, path) is not None:
            raise DirectoryAlreadyExists(path)
        # parents are created implicitly (reference semantics)
        if len(path) > 1:
            if await self.find(txn, path[:-1]) is None:
                await self.create(txn, path[:-1])
        if prefix is None:
            prefix = await self._allocate_prefix(txn)
        txn.set(self._node_key(path), prefix)
        return DirectorySubspace(path, prefix, self)

    async def create_or_open(self, txn, path) -> DirectorySubspace:
        found = await self.find(txn, tuple(path))
        if found is not None:
            return found
        return await self.create(txn, path)

    async def open(self, txn, path) -> DirectorySubspace:
        found = await self.find(txn, tuple(path))
        if found is None:
            raise DirectoryDoesNotExist(tuple(path))
        return found

    async def list(self, txn, path=()) -> list:
        base = ("node",) + tuple(path)
        b, e = self._nodes.range(base)
        out = []
        for k, _v in await txn.get_range(b, e):
            sub = self._nodes.unpack(k)
            rel = sub[len(base):]
            if len(rel) == 1:  # immediate children only
                out.append(rel[0])
        return out

    async def move(self, txn, old_path, new_path) -> DirectorySubspace:
        old_path, new_path = tuple(old_path), tuple(new_path)
        d = await self.open(txn, old_path)
        if await self.find(txn, new_path) is not None:
            raise DirectoryAlreadyExists(new_path)
        # move the node and every descendant node entry
        b, e = self._nodes.range(("node",) + old_path)
        for k, v in await txn.get_range(b, e):
            sub = self._nodes.unpack(k)
            rel = sub[len(("node",) + old_path):]
            txn.set(self._node_key(new_path + rel), v)
            txn.clear(k)
        txn.clear(self._node_key(old_path))
        txn.set(self._node_key(new_path), d.key)
        return DirectorySubspace(new_path, d.key, self)

    async def remove(self, txn, path) -> None:
        path = tuple(path)
        d = await self.open(txn, path)
        # clear contents of this directory and every descendant
        b, e = self._nodes.range(("node",) + path)
        for k, v in await txn.get_range(b, e):
            txn.clear_range(v, v + b"\xff")
            txn.clear(k)
        txn.clear_range(d.key, d.key + b"\xff")
        txn.clear(self._node_key(path))
