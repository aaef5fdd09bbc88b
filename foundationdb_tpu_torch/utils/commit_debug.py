"""The commit-path Location strings the Resolver role, the wire commit
path, the simulated cluster's roles and its client emit (the port's own
copy of the constants and `version_id` of
foundationdb_tpu.utils.commit_debug).

The reference debugs its commit path with `g_traceBatch` micro-events
(name, id, Location) and contrib/commit_debug.py joins them on these
exact strings (Resolver.actor.cpp:244,266,320,509;
CommitProxyServer.actor.cpp's commitBatch marks), so the emitters read
them from here and never spell them inline. The timeline reconstructor
of the JAX module reads the port's trace files as they are.
"""

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


def version_id(version: int) -> str:
    return f"{VERSION_ID_PREFIX}{version}"
