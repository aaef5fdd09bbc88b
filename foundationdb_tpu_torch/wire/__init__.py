"""Serialized wire: binary codec and token-addressed RPC transport (the
port's own copy of foundationdb_tpu.wire).

`codec` mirrors the reference's protocol-versioned payload serialization
(flow/serialize.h, flow/flat_buffers.cpp); `transport` mirrors
FlowTransport's token-addressed, checksummed, version-handshaked framing
(fdbrpc/FlowTransport.actor.cpp:427,1022,1119-1142). Frames are
byte-identical to the JAX package's, so processes of either package
speak to each other.
"""

from foundationdb_tpu_torch.wire import codec, transport  # noqa: F401
