"""State and arguments carried across from the JAX package, as numpy.

The port's counterpart of carrying weights: a conflict set's history
(a JAX `VersionHistory` on the classic path, `TieredState` on the
tiered one, or the stacked [S, ...] `TieredState` of the sharded one,
read out as numpy arrays) becomes the port's state on a
given device, so a resolver can move between the two packages
mid-stream with identical decisions after the move
(`TorchConflictSet.load_state` / `store_state` call these). Everything
here takes and gives numpy only; nothing imports JAX.

Key words are uint32 on the numpy side and int32 bit patterns on the
torch side (ops/keys.py); versions are int32 offsets on both.

`Stager` is the staging pipeline's copy onto the card: a chunk's array
arguments are stacked into a pinned host slab (a ring of depth + 1
slots) and cross in one `non_blocking` copy on a copy stream of their
own, with an event after the copy that the compute stream waits on. `device_args_to_torch`
stays the synchronous, pageable copy of every other path.
"""

from __future__ import annotations

import numpy as np
import torch

from foundationdb_tpu_torch.ops import delta as D
from foundationdb_tpu_torch.ops import history as H

#: scalar arguments the port keeps on the host (floors and versions are
#: host values: the host loop and the GC floors read them without a sync)
HOST_ARGS = ("version", "new_oldest")


def to_torch(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy shares the buffer
        a = a.copy()
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def device_args_to_torch(args: dict, device) -> dict:
    """One `PackedBatch.device_args()` dict (or a stacked one) -> the
    port's argument dict: array leaves as tensors on `device` (tensors
    already there pass through), the HOST_ARGS scalars as numpy on the
    host."""
    return {
        k: (np.asarray(v) if k in HOST_ARGS else to_torch(v, device))
        for k, v in args.items()
    }


def _host_array(v) -> np.ndarray:
    """A numpy argument as the bit pattern torch holds (uint32 keys as
    int32), without a copy."""
    a = np.asarray(v)
    return a.view(np.int32) if a.dtype == np.uint32 else a


#: byte alignment of each argument inside a staging slab (the kernels'
#: vector loads want at least 16)
SLAB_ALIGN = 256


def slab_layout(parts: list, stack: bool):
    """Where each array argument goes in one byte slab. `parts` is a
    list of argument dicts with the same keys and shapes: with `stack`
    they are stacked on a new leading axis, else `parts` is one dict
    placed as it is. Returns (the HOST_ARGS as numpy, [(name, sources,
    shape, byte offset)], slab bytes)."""
    first = parts[0]
    scalars, layout, size = {}, [], 0
    for k in first:
        if k in HOST_ARGS:
            scalars[k] = (np.stack([np.asarray(p[k]) for p in parts])
                          if stack else np.asarray(first[k]))
            continue
        srcs = [_host_array(p[k]) for p in parts]
        shape = (len(parts),) + srcs[0].shape if stack else srcs[0].shape
        layout.append((k, srcs, shape, size))
        size += -(-_nbytes(srcs, shape) // SLAB_ALIGN) * SLAB_ALIGN
    return scalars, layout, size


def _nbytes(srcs, shape) -> int:
    return srcs[0].itemsize * int(np.prod(shape))


def fill_slab(host: np.ndarray, layout) -> None:
    """Copy each argument into its place in a uint8 host slab (a stacked
    one part by part: the stack is built in the slab itself)."""
    for _, srcs, shape, off in layout:
        dst = host[off:off + _nbytes(srcs, shape)].view(
            srcs[0].dtype).reshape(shape)
        if len(srcs) == 1 and dst.shape == srcs[0].shape:
            np.copyto(dst, srcs[0])
        else:
            for j, a in enumerate(srcs):
                np.copyto(dst[j], a)


def slab_views(slab: torch.Tensor, layout) -> dict:
    """The arguments as views of a uint8 slab filled by fill_slab."""
    out = {}
    for k, srcs, shape, off in layout:
        dtype = torch.from_numpy(srcs[0][:0]).dtype
        out[k] = slab[off:off + _nbytes(srcs, shape)].view(dtype).view(shape)
    return out


class Stager:
    """Pinned, asynchronous staging of argument dicts onto a device.

    Each of the depth + 1 ring slots is one pinned byte slab. On the
    staging thread, `fill(parts, stack)` waits until the copy that last
    used the next slot has completed (a slab is never overwritten under
    an in-flight copy) and copies the arguments straight into that slab
    (`slab_layout`, `fill_slab`; a chunk of batches is stacked there,
    with no stacked copy on the host), and `send(ticket)` enqueues one
    copy of the used bytes on the copy stream and records an event after
    it. It returns (args, event): the arguments as views of the device
    copy (`slab_views`) and the HOST_ARGS scalars as numpy. `receive(
    args, event)` runs on the compute thread: the current stream waits
    on the event, and every staged tensor is recorded on that stream, so
    the caching allocator does not hand the copy's memory to the copy
    stream while compute still reads it. No kernel is ever launched on
    the copy stream.

    The slabs are allocated all together, at the first chunk (and again
    only when a chunk outgrows them): a pinned allocation stalls the
    card's other work, so it is kept out of a stream's steady state, and
    a smaller chunk (a stream's last) fits the slabs it finds.

    On a CPU device there are no streams, slabs or events: `fill` stacks
    with numpy, `send` is `device_args_to_torch` and `receive` passes
    the args through.
    """

    def __init__(self, device, depth: int):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.n_slots = max(1, depth) + 1
        #: one pinned uint8 slab a slot (None until the first chunk)
        self.slots: list = [None] * self.n_slots
        self._events: list = [None] * self.n_slots
        self._next = 0
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def reserve(self, size: int) -> None:
        """Allocate every slot's slab at `size` bytes now (after the
        copies in flight from the old ones have completed)."""
        for event in self._events:
            if event is not None:
                event.synchronize()
        self._events = [None] * self.n_slots
        self.slots = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
                      for _ in range(self.n_slots)]

    def fill(self, parts: list, stack: bool = False):
        """The host half: a ticket for `send`."""
        if not self.cuda:
            if not stack:
                return parts[0]
            return {k: np.stack([np.asarray(p[k]) for p in parts])
                    for k in parts[0]}
        scalars, layout, size = slab_layout(parts, stack)
        i = self._next
        self._next = (i + 1) % self.n_slots
        if self.slots[i] is None or self.slots[i].numel() < size:
            self.reserve(size)
        elif self._events[i] is not None:
            self._events[i].synchronize()
        fill_slab(self.slots[i].numpy(), layout)
        return i, scalars, layout, size

    def send(self, ticket):
        """The copy: (args, event)."""
        if not self.cuda:
            return device_args_to_torch(ticket, self.device), None
        i, out, layout, size = ticket
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            dev = self.slots[i][:size].to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self._events[i] = event
        out.update(slab_views(dev, layout))
        return out, event

    def stage(self, host_args: dict):
        """fill + send of one ready argument dict."""
        return self.send(self.fill([host_args]))

    def receive(self, args: dict, event) -> dict:
        if event is None:
            return args
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for v in args.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(stream)
        return args


def history_from_numpy(keys, ver, oldest, overflow, device) -> H.VersionHistory:
    """One tier (a JAX `VersionHistory`'s four leaves as numpy)."""
    return H.VersionHistory(
        main_keys=to_torch(np.asarray(keys, np.uint32), device),
        main_ver=to_torch(np.asarray(ver, np.int32), device),
        oldest=int(oldest),
        overflow=torch.tensor(bool(overflow), device=device),
    )


def tiered_state_from_numpy(main, delta, device) -> D.TieredState:
    """A JAX `TieredState` as numpy -> the port's state on `device`.

    `main` and `delta` are each (keys [N, W] uint32, ver [N] int32,
    oldest, overflow) — the leaf order of the JAX `VersionHistory`, so
    `[np.asarray(x) for x in jax_state.main]` is accepted as it is.
    """
    return D.TieredState(
        main=history_from_numpy(*main, device),
        delta=history_from_numpy(*delta, device),
    )


def history_to_numpy(h: H.VersionHistory):
    """(keys uint32, ver int32, oldest int, overflow bool) on the host."""
    return (
        h.main_keys.cpu().numpy().view(np.uint32),
        h.main_ver.cpu().numpy(),
        int(h.oldest),
        bool(h.overflow),
    )


def tiered_state_to_numpy(state: D.TieredState):
    return history_to_numpy(state.main), history_to_numpy(state.delta)



def sharded_tiered_state_from_numpy(main, delta, device) -> tuple:
    """A JAX stacked sharded `TieredState` as numpy -> the port's S
    shards' states on `device`.

    `main` and `delta` are each the four leaves with a leading [S] axis
    (keys [S, N, W] uint32, ver [S, N] int32, oldest [S], overflow [S]),
    so `[np.asarray(x) for x in jax_state.main]` is accepted as it is.
    """
    n_shards = np.asarray(main[0]).shape[0]
    return tuple(
        D.TieredState(
            main=history_from_numpy(*(np.asarray(x)[s] for x in main),
                                    device),
            delta=history_from_numpy(*(np.asarray(x)[s] for x in delta),
                                     device),
        )
        for s in range(n_shards)
    )


def sharded_tiered_state_to_numpy(states):
    """The S shards' states as the JAX stacked layout: (main leaves,
    delta leaves), each leaf with a leading [S] axis (oldest int32,
    overflow bool)."""
    def stack(tiers):
        leaves = [history_to_numpy(h) for h in tiers]
        return (np.stack([x[0] for x in leaves]),
                np.stack([x[1] for x in leaves]),
                np.array([x[2] for x in leaves], np.int32),
                np.array([x[3] for x in leaves], bool))

    return stack([s.main for s in states]), stack([s.delta for s in states])
