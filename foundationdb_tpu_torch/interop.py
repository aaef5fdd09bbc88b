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
