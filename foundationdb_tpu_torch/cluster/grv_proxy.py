"""The GRV front door's shed error (the port's own copy of
`GrvThrottledError` from foundationdb_tpu.cluster.grv_proxy).

The wire ProxyPipeline serves read versions itself and raises this when
its admission queue is past its bound. The batched GrvProxy role waits
for the sim-cluster slice.
"""

from __future__ import annotations


class GrvThrottledError(Exception):
    """Retryable: the GRV queue is over its bound under admission
    control, so the front door sheds the request instead of queueing it
    without bound (the reference's GRV proxy drops requests past
    START_TRANSACTION_MAX_QUEUE_SIZE the same way). Clients back off and
    retry; offered load past capacity becomes delayed admits and
    retryable sheds, never an unbounded queue of promises."""
