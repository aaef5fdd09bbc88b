"""foundationdb_tpu_torch: the PyTorch + CUDA port of foundationdb_tpu.

The Resolver's per-batch MVCC conflict check on the tiered
configuration (exact, and the hot-key and range-scan profiles: fixpoint
latch with exact fallback, read dedup, endpoint sweep, delta spill), on
the classic single-tier one, and across several resolvers over a
keyspace partition (parallel/sharding.py), on an NVIDIA Hopper card,
with hand-written CUDA kernels (kernels/csrc) and plain PyTorch
versions beside them for the CPU. The package imports torch and numpy
only: nothing of JAX or of the JAX package, whose modules it mirrors
path for path.

    from foundationdb_tpu_torch import make_conflict_set
    cs = make_conflict_set(config)                 # on the card
    cs = make_conflict_set(config, device="cpu")   # plain versions
    cs = make_conflict_set(config.scaled(n_shards=4),
                           shard_boundaries=[b"\x40", b"\x80", b"\xc0"])
    cs.resolve_stream_pipelined(batches)           # staged: pinned, async

The Resolver role (`resolver.Resolver`, on the port's own actor runtime
`runtime/flow.py`) serves ResolveTransactionBatchRequests through a
conflict set built by the same factory, or by the resolver_backend knob
(`utils/knobs.SERVER_KNOBS`). The wire commit path
(`cluster/multiprocess.py`: `python -m
foundationdb_tpu_torch.cluster.multiprocess --role
{resolver,tlog,storage,sequencer}`) serves the roles as OS processes
over the JAX package's frames (`wire/`), the resolver's columnar frames
straight into the kernel's arrays, the tlog and storage on the C++
DiskQueue and versioned LSM (`native/`), and its `ProxyPipeline`
commits through them.

The simulated cluster (`open_cluster`, `cluster/database.py`) runs every
role in one process on the deterministic actor runtime: sequencer, GRV
and commit proxies, resolvers, a replicated log system, sharded and
replicated storage servers, coordinators, ratekeeper, balancer, failure
monitor, cluster controller and data distributor, with the client stack
on top:

    from foundationdb_tpu_torch import open_cluster
    from foundationdb_tpu_torch.cluster.database import ClusterConfig
    sched, cluster, db = open_cluster()            # resolvers on the card
    sched, cluster, db = open_cluster(
        ClusterConfig(device="cpu"))               # plain versions
    sched, cluster, db = open_cluster(
        ClusterConfig(resolver_backend="cpu"))     # the host oracle

The cluster never reads the RESOLVER_BACKEND knob: it resolves on the
card unless the caller asks for the CPU, and raises on a host without a
card.
"""

from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.models.conflict_set import (
    HistoryOverflowError,
    TorchConflictSet,
    make_conflict_set,
)



def open_cluster(config=None, *, sched=None):
    """Boot an in-process simulated cluster; returns (scheduler, cluster,
    database). Where its resolvers run: cluster/database.open_cluster."""
    from foundationdb_tpu_torch.cluster.database import open_cluster as _open

    return _open(config, sched=sched)


__all__ = ["KernelConfig", "HistoryOverflowError", "TorchConflictSet",
           "make_conflict_set", "open_cluster"]
