"""The commit-path Location strings the Resolver role emits (the port's
own copy of the RESOLVER_* constants of foundationdb_tpu.utils.
commit_debug).

The reference debugs its commit path with `g_traceBatch` micro-events
(name, id, Location) and contrib/commit_debug.py joins them on these
exact strings (Resolver.actor.cpp:244,266,320,509), so the emitters
read them from here and never spell them inline.
"""

RESOLVER_BEFORE = "Resolver.resolveBatch.Before"
RESOLVER_AFTER_QUEUE = "Resolver.resolveBatch.AfterQueueSizeCheck"
RESOLVER_AFTER_ORDERER = "Resolver.resolveBatch.AfterOrderer"
#: the columnar frame has become the conflict backend's input (kernel
#: tensors, or rebuilt objects on the object fallback): with
#: AfterOrderer as the opening mark it brackets exactly the decode
RESOLVER_COLUMNAR_DECODE = "Resolver.resolveBatch.ColumnarDecode"
RESOLVER_AFTER = "Resolver.resolveBatch.After"
