"""The saturation budgets of the cluster status document (the port's own
copy of the three constants of foundationdb_tpu.cluster.status that the
Ratekeeper reads).

They turn raw sensor readings into comparable pressure scores (the
reference's analogs live in ServerKnobs: TARGET_BYTES_PER_TLOG, ...).
The status document itself (`cluster_status`) is not ported yet.
"""

from __future__ import annotations

#: retained tlog queue bytes at which the log counts as saturated
#: (the reference throttles toward TARGET_BYTES_PER_TLOG = 2.4 GB; the
#: sim tlog spills to its simdisk long before that, so the budget here
#: is sized to the in-memory retention the spill discipline allows)
TLOG_QUEUE_BYTES_TARGET = 64 << 20
#: resolver batches waiting on the version chain at which resolution is
#: the bottleneck (the wire pipeline caps in-flight batches at the
#: MAX_PIPELINED_COMMIT_BATCHES knob = 8; a full chain means every
#: pipeline slot is parked on the resolver)
RESOLVER_QUEUE_TARGET = 8
#: commit requests queued at one proxy before admission is overdue
PROXY_QUEUE_TARGET = 4096
