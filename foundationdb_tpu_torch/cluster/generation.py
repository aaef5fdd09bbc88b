"""Generation fencing's error marker (the port's own copy of
`STALE_EPOCH_MARKER`, `stale_epoch_message` and `is_stale_epoch` from
foundationdb_tpu.cluster.generation).

A role recruited into recovery generation E rejects a request carrying
any other epoch with a retryable error whose message holds the marker;
the message travels inside the transport's RemoteError, and a caller
tells the rejection apart with `is_stale_epoch`. The recovery state
machine itself is not ported yet.
"""

from __future__ import annotations

#: error-message marker for generation fencing; carried inside the
#: RemoteError text across the wire, matched by is_stale_epoch()
STALE_EPOCH_MARKER = "stale_epoch"


def stale_epoch_message(req_epoch: int, current_epoch: int) -> str:
    """The fencing rejection string (travels inside RemoteError)."""
    return (
        f"{STALE_EPOCH_MARKER}: request epoch {req_epoch} != "
        f"current generation {current_epoch}"
    )


def is_stale_epoch(err) -> bool:
    """True if an exception (or its string form) is a generation-fence
    rejection: the retryable signal (refresh the epoch and retry)."""
    return STALE_EPOCH_MARKER in str(err)
