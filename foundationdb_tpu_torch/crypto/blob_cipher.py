"""Authenticated AES-256-CTR record encryption and the cipher-key cache
(the port's own copy of foundationdb_tpu.crypto.blob_cipher).

Capability match for fdbclient/BlobCipher.cpp:

* **BlobCipherKey** (BlobCipher.h:215-320): a derived encryption key.
  The KMS hands out a base secret per encryption domain; the data key
  is derived per (base key, random salt) with HMAC-SHA256, so one
  derived key never exposes the base secret, and rotation is a new
  salt, not a KMS round trip (BlobCipher.cpp applyHmacKeyDerivationFunc).
* **BlobCipherKeyCache** (BlobCipher.cpp:1194-1383): a per-domain cache
  of derived keys: the newest for encryption, every (baseId, salt) pair
  still referenced for the decryption of older records. Refresh is the
  EncryptKeyProxy's (cluster/encrypt_key_proxy.py).
* **EncryptHeader** (BlobCipherEncryptHeaderRef): a self-describing
  preamble naming the text cipher (domain, baseId, salt), the 16-byte
  CTR IV and an HMAC-SHA256 auth token over header and ciphertext under
  a separate header-auth key. AES-CTR is malleable, so every decrypt
  verifies the token first (BlobCipher.cpp:1456-1520's single-auth-token
  mode), and tampering raises AuthTokenError, never returns garbage.

The header layout, the key derivation and the token are the JAX
package's byte for byte: a record sealed by either package opens in the
other. The cipher comes from the `cryptography` package (OpenSSL, the
primitive the reference calls through EVP_EncryptUpdate), imported by
`encrypt` and `decrypt` when they run, so the port imports on a host
without it; `require_cipher` raises there.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import os
import struct
import time

ENCRYPT_HEADER_MAGIC = b"FDBE"
ENCRYPT_HEADER_VERSION = 1
AES_KEY_BYTES = 32
IV_BYTES = 16
AUTH_TOKEN_BYTES = 32

#: Reserved system encryption domains (fdbclient/EncryptKeyProxyInterface.h:
#: SYSTEM_KEYSPACE_ENCRYPT_DOMAIN_ID / FDB_DEFAULT_ENCRYPT_DOMAIN_ID).
SYSTEM_DOMAIN_ID = -2
DEFAULT_DOMAIN_ID = -1


class AuthTokenError(RuntimeError):
    """Auth-token mismatch: the record was tampered with (or decrypted
    with the wrong header-auth key). The reference's
    encrypt_header_authtoken_mismatch: data corruption, never a soft
    error."""


class CipherKeyNotFoundError(KeyError):
    """No cached cipher for the (domain, baseId, salt) a header names."""


class CipherKeyExpiredError(CipherKeyNotFoundError):
    """The named cipher exists but passed its expire deadline: a KMS
    re-fetch must not undo a key's retirement (the proxy treats this
    apart from a plain cache miss)."""


def require_cipher():
    """The AES primitives (`Cipher`, `algorithms`, `modes`); raises
    ImportError without the `cryptography` package, so that asking for
    encryption on such a host fails before anything is written."""
    from cryptography.hazmat.primitives.ciphers import (
        Cipher,
        algorithms,
        modes,
    )

    return Cipher, algorithms, modes


def derive_key(base_key: bytes, domain_id: int, base_id: int,
               salt: bytes) -> bytes:
    """HMAC-SHA256 key derivation from the KMS base secret
    (BlobCipher.cpp applyHmacKeyDerivationFunc: the derived key binds
    the domain, the base key's id and the random salt)."""
    msg = struct.pack("<qq", domain_id, base_id) + salt
    return hmac.new(base_key, msg, hashlib.sha256).digest()[:AES_KEY_BYTES]


@dataclasses.dataclass(frozen=True)
class BlobCipherKey:
    domain_id: int
    base_id: int
    salt: bytes          # 16 random bytes chosen at derivation time
    key: bytes           # the derived AES-256 key (never the base secret)
    refresh_at: float    # wall clock after which encryption re-derives
    expire_at: float     # after which even decryption refuses (revoked)

    def usable_for_encrypt(self, now: float = None) -> bool:
        now = time.time() if now is None else now
        return now < self.refresh_at

    def usable_for_decrypt(self, now: float = None) -> bool:
        now = time.time() if now is None else now
        return self.expire_at == float("inf") or now < self.expire_at


class BlobCipherKeyCache:
    """Per-domain derived-key cache (BlobCipher.cpp BlobCipherKeyCache).

    `insert` registers a derived key; `latest(domain)` serves
    encryption; `lookup(domain, base_id, salt)` serves the decryption of
    older records. The cache never talks to the KMS: the EncryptKeyProxy
    fetches, refreshes and feeds it (the reference's split of
    BlobCipherKeyCache and EncryptKeyProxy.actor.cpp).
    """

    def __init__(self):
        self._latest: dict[int, BlobCipherKey] = {}
        self._by_id: dict[tuple[int, int, bytes], BlobCipherKey] = {}

    def insert(self, key: BlobCipherKey, *, latest: bool = True) -> None:
        self._by_id[(key.domain_id, key.base_id, key.salt)] = key
        if latest:
            cur = self._latest.get(key.domain_id)
            if cur is None or key.base_id >= cur.base_id:
                self._latest[key.domain_id] = key

    def latest(self, domain_id: int) -> BlobCipherKey:
        key = self._latest.get(domain_id)
        # an expired key must not serve encryption either (with
        # expire_interval < refresh_interval a record sealed under it
        # would be durably unreadable): both deadlines gate here, so the
        # proxy re-derives
        if (
            key is None
            or not key.usable_for_encrypt()
            or not key.usable_for_decrypt()
        ):
            raise CipherKeyNotFoundError(
                f"no fresh encryption key for domain {domain_id}"
            )
        return key

    def latest_any(self, domain_id: int) -> "BlobCipherKey | None":
        """The newest cached key, even past its refresh deadline: the
        non-blocking seal path encrypts under it while a refresh runs."""
        return self._latest.get(domain_id)

    def lookup(self, domain_id: int, base_id: int,
               salt: bytes) -> BlobCipherKey:
        key = self._by_id.get((domain_id, base_id, salt))
        if key is None:
            raise CipherKeyNotFoundError(
                f"no cipher for domain={domain_id} baseId={base_id}"
            )
        if not key.usable_for_decrypt():
            raise CipherKeyExpiredError(
                f"cipher domain={domain_id} baseId={base_id} expired"
            )
        return key

    def domains(self) -> list[int]:
        return sorted(self._latest)


#: magic, version, text domain, text base id, header domain, header base
#: id, text salt, header salt, IV: the reference's BlobCipherEncryptHeader
#: likewise names both cipher identities (textCipherDetails and
#: headerCipherDetails), so decrypt finds the data key and the auth key
#: apart
_HEADER = struct.Struct("<4sBqqqq16s16s16s")


@dataclasses.dataclass(frozen=True)
class EncryptHeader:
    domain_id: int
    base_id: int
    header_domain_id: int  # the auth key's identity (a separate cipher)
    header_base_id: int
    salt: bytes
    header_salt: bytes
    iv: bytes

    def pack(self) -> bytes:
        return _HEADER.pack(
            ENCRYPT_HEADER_MAGIC, ENCRYPT_HEADER_VERSION, self.domain_id,
            self.base_id, self.header_domain_id, self.header_base_id,
            self.salt, self.header_salt, self.iv,
        )

    @classmethod
    def unpack(cls, blob: bytes) -> "EncryptHeader":
        magic, ver, dom, base, hdom, hbase, salt, hsalt, iv = _HEADER.unpack(
            blob[: _HEADER.size]
        )
        if magic != ENCRYPT_HEADER_MAGIC or ver != ENCRYPT_HEADER_VERSION:
            raise AuthTokenError("bad encrypt header magic/version")
        return cls(dom, base, hdom, hbase, salt, hsalt, iv)


HEADER_BYTES = _HEADER.size + AUTH_TOKEN_BYTES


def _auth_token(header_bytes: bytes, ciphertext: bytes,
                auth_key: bytes) -> bytes:
    return hmac.new(auth_key, header_bytes + ciphertext,
                    hashlib.sha256).digest()


def encrypt(plaintext: bytes, text_key: BlobCipherKey,
            auth_key: BlobCipherKey, *, iv: bytes = None) -> bytes:
    """Encrypt one record: header | auth token | ciphertext.

    AES-256-CTR under a fresh random IV a record (`iv` pins it),
    authenticated by HMAC-SHA256 over header and ciphertext under the
    separate auth key (BlobCipher.cpp EncryptBlobCipherAes265Ctr::
    encrypt)."""
    Cipher, algorithms, modes = require_cipher()
    iv = os.urandom(IV_BYTES) if iv is None else iv
    enc = Cipher(algorithms.AES(text_key.key), modes.CTR(iv)).encryptor()
    ciphertext = enc.update(plaintext) + enc.finalize()
    header = EncryptHeader(
        domain_id=text_key.domain_id, base_id=text_key.base_id,
        header_domain_id=auth_key.domain_id,
        header_base_id=auth_key.base_id,
        salt=text_key.salt, header_salt=auth_key.salt, iv=iv,
    ).pack()
    return header + _auth_token(header, ciphertext, auth_key.key) + ciphertext


def decrypt(blob: bytes, cache: BlobCipherKeyCache,
            auth_key: BlobCipherKey = None, *,
            expected_domain_id: int = None) -> bytes:
    """Verify the auth token, then decrypt. The text cipher is found in
    the cache by the header's (domain, baseId, salt); the auth key
    defaults to the cache's key for the header's auth identity.

    The header is unauthenticated until the token verifies, so its
    cipher details are the attacker's to choose: a forger holding any
    domain's key could name that domain as the header-auth identity and
    mint a token that verifies. The reference pins the header cipher to
    the system encryption domain before using it (BlobCipher.cpp:256
    validateEncryptHeaderDetails), and so does this: a header naming a
    non-system auth domain is refused, and a caller that knows its
    record's domain passes `expected_domain_id`, so a valid record moved
    across domains is refused too."""
    if len(blob) < HEADER_BYTES:
        raise AuthTokenError("truncated encrypted record")
    header_bytes = blob[: _HEADER.size]
    token = blob[_HEADER.size : HEADER_BYTES]
    ciphertext = blob[HEADER_BYTES:]
    header = EncryptHeader.unpack(header_bytes)
    if expected_domain_id is not None and header.domain_id != expected_domain_id:
        raise AuthTokenError(
            f"header names text domain {header.domain_id}, store is "
            f"configured for domain {expected_domain_id}"
        )
    if auth_key is None:
        if header.header_domain_id != SYSTEM_DOMAIN_ID:
            raise AuthTokenError(
                f"header names auth domain {header.header_domain_id}; "
                f"only the system domain ({SYSTEM_DOMAIN_ID}) may hold "
                f"header-auth keys"
            )
        auth_key = cache.lookup(
            header.header_domain_id, header.header_base_id,
            header.header_salt,
        )
    want = _auth_token(header_bytes, ciphertext, auth_key.key)
    if not hmac.compare_digest(token, want):
        raise AuthTokenError(
            f"auth token mismatch (domain={header.domain_id}, "
            f"baseId={header.base_id}): record tampered or wrong key"
        )
    text_key = cache.lookup(header.domain_id, header.base_id, header.salt)
    Cipher, algorithms, modes = require_cipher()
    dec = Cipher(
        algorithms.AES(text_key.key), modes.CTR(header.iv)
    ).decryptor()
    return dec.update(ciphertext) + dec.finalize()


def is_encrypted(blob: bytes) -> bool:
    """Cheap header sniff (the storage read path must accept records
    written before encryption was enabled)."""
    return blob[:4] == ENCRYPT_HEADER_MAGIC and len(blob) >= HEADER_BYTES
