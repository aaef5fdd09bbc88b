"""Encryption at rest: the cipher-key cache and authenticated AES-256-CTR
(the port's own copy of foundationdb_tpu.crypto).

The reference's at-rest encryption stack is fdbclient/BlobCipher.cpp
(the cipher-key cache, key derivation, AES-256-CTR with an authenticated
header), served to roles by fdbserver/EncryptKeyProxy.actor.cpp from a
KMS connector (fdbserver/SimKmsConnector.actor.cpp in simulation,
fdbserver/RESTKmsConnector.actor.cpp in production). `tls.py` holds the
transport's mutual TLS and `token_sign.py` the tenant tokens.
"""

from foundationdb_tpu_torch.crypto.blob_cipher import (  # noqa: F401
    AuthTokenError,
    BlobCipherKey,
    BlobCipherKeyCache,
    EncryptHeader,
    decrypt,
    encrypt,
)
