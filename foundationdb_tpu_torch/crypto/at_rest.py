"""At-rest record sealing for the storage roles (the port's own copy of
foundationdb_tpu.crypto.at_rest).

The storage-side encryption discipline of the reference
(fdbserver/KeyValueStoreMemory.actor.cpp encryptedMemoryLog, Redwood's
encrypted pager, fdbclient/GetEncryptCipherKeys.actor.cpp): every
durable record (WAL entries, checkpoint blobs, LSM values) is sealed
under the domain's current cipher before it touches the disk, and opened
through the cipher cache, with a by-id KMS fetch for the generations a
restarted process has never seen.

A difference from the reference, the JAX package's too: every SET value
is sealed once at apply time, so values are ciphertext in the storage
WAL, the LSM's runs and memtable and the checkpoint blobs alike; keys
stay plaintext in all three (run files are ordered by key and the native
engine compares them directly; the reference's Redwood encrypts whole
pages). The tlog's DiskQueue seals whole records (no ordering constraint
there).
"""

from __future__ import annotations

import time

from foundationdb_tpu_torch.crypto.blob_cipher import (
    DEFAULT_DOMAIN_ID,
    SYSTEM_DOMAIN_ID,
    AuthTokenError,
    EncryptHeader,
    decrypt,
    encrypt,
    is_encrypted,
    require_cipher,
)


class StorageEncryption:
    """Seal and open durable records under one encryption domain.

    The auth (HMAC) key is a separate cipher of the system domain: the
    reference's split of textCipherDetails and headerCipherDetails
    (BlobCipher.h BlobCipherEncryptHeader), so a data key never yields
    the power to forge auth tokens. Construction raises ImportError
    without the `cryptography` package: a store that asks for encryption
    never starts without the cipher.

    `stats()` counts the records sealed and opened and their seconds on
    the wall clock (a port addition: the role's status reports the cost
    of sealing a record)."""

    def __init__(self, proxy, domain_id: int = DEFAULT_DOMAIN_ID):
        require_cipher()
        self.proxy = proxy
        self.domain_id = domain_id
        self.seals = 0
        self.seal_seconds = 0.0
        self.opens = 0
        self.open_seconds = 0.0

    def stats(self) -> dict:
        return {"seals": self.seals, "seal_seconds": self.seal_seconds,
                "opens": self.opens, "open_seconds": self.open_seconds,
                "kms_fetches": self.proxy.fetches}

    def prefetch(self) -> None:
        """Warm both cipher identities (data and auth) before a role
        serves, so the seal path never blocks on the KMS."""
        self.proxy.get_latest_cipher(self.domain_id)
        self.proxy.get_latest_cipher(SYSTEM_DOMAIN_ID)

    def seal(self, blob: bytes) -> bytes:
        # non-blocking: a stale key seals while a background refresh
        # runs (the apply path must never stall on the KMS)
        t0 = time.perf_counter()
        key = self.proxy.get_latest_cipher_nonblocking(self.domain_id)
        auth = self.proxy.get_latest_cipher_nonblocking(SYSTEM_DOMAIN_ID)
        out = encrypt(blob, key, auth)
        self.seals += 1
        self.seal_seconds += time.perf_counter() - t0
        return out

    def open(self, blob: bytes) -> bytes:
        """Decrypt a sealed record; a plaintext record written before
        encryption was enabled passes through (the reference's
        mixed-mode reads during an encryption rollout).

        The sniff is by header magic, so a legacy value that happens to
        start with the magic is told apart by parsing: a bad version
        byte passes through as plaintext; a parseable header whose key
        the KMS does not know raises (either a sealed record whose key
        is gone, a loss to surface, or a one-in-2^72 plaintext
        collision; the reference avoids the ambiguity with page-level
        metadata, a format difference)."""
        if not is_encrypted(blob):
            return blob
        try:
            hdr = EncryptHeader.unpack(blob)
        except AuthTokenError:
            return blob  # magic collision, not our header version
        # The header is unauthenticated until the token verifies, so
        # its cipher details are checked before they drive a KMS fetch
        # (BlobCipher.cpp:256's discipline): the auth identity must be
        # the system domain and the text identity this store's domain,
        # so a forger does not choose the keys that authenticate a
        # record.
        if hdr.header_domain_id != SYSTEM_DOMAIN_ID:
            raise AuthTokenError(
                f"sealed record names auth domain {hdr.header_domain_id}; "
                f"header-auth keys live only in the system domain"
            )
        if hdr.domain_id != self.domain_id:
            raise AuthTokenError(
                f"sealed record names text domain {hdr.domain_id}; this "
                f"store is configured for domain {self.domain_id}"
            )
        t0 = time.perf_counter()
        # both named generations cached (after a restart: a fresh cache)
        self.proxy.get_cipher_by_id(hdr.domain_id, hdr.base_id, hdr.salt)
        self.proxy.get_cipher_by_id(
            hdr.header_domain_id, hdr.header_base_id, hdr.header_salt
        )
        out = decrypt(
            blob, self.proxy.cache, expected_domain_id=self.domain_id
        )
        self.opens += 1
        self.open_seconds += time.perf_counter() - t0
        return out


def default_encryption(domain_id: int = DEFAULT_DOMAIN_ID,
                       kms_endpoint: str = None) -> StorageEncryption:
    """The role process's constructor: the REST KMS when an endpoint is
    configured (the FDB_TPU_KMS environment variable), else the
    deterministic sim KMS (every process derives the same keys, the
    SimKmsConnector contract)."""
    from foundationdb_tpu_torch.cluster.encrypt_key_proxy import (
        EncryptKeyProxy,
    )
    from foundationdb_tpu_torch.cluster.kms import (
        RestKmsConnector,
        SimKmsConnector,
    )

    kms = (
        RestKmsConnector(kms_endpoint) if kms_endpoint else SimKmsConnector()
    )
    return StorageEncryption(EncryptKeyProxy(kms), domain_id)
