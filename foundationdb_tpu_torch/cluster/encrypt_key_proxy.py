"""EncryptKeyProxy: the role between the KMS and every encrypting role
(the port's own copy of foundationdb_tpu.cluster.encrypt_key_proxy).

Capability match for fdbserver/EncryptKeyProxy.actor.cpp: one process a
cluster talks to the KMS, derives record-encryption keys from base
secrets, caches them, and serves getLatestCipher / getCipherById to
storage servers, TLogs, backup workers and blob workers, so the KMS sees
one client and key material is derived in one place.

Roles receive derived keys, never base secrets: the reference's split.
Refresh: an encryption key older than ENCRYPT_KEY_REFRESH_INTERVAL
re-derives under a fresh salt (cheap, no KMS trip); a KMS rotation (a
new base id) is picked up at the next refresh. Older derived keys stay
served for decryption until they expire.
"""

from __future__ import annotations

import os
import threading
import time

from foundationdb_tpu_torch.crypto.blob_cipher import (
    BlobCipherKey,
    BlobCipherKeyCache,
    CipherKeyExpiredError,
    derive_key,
)
from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS


class EncryptKeyProxy:
    def __init__(self, kms, *, refresh_interval: float = None,
                 expire_interval: float = None, clock=None, entropy=None):
        self.kms = kms
        self.cache = BlobCipherKeyCache()
        # Injectable clock and entropy, so a simulated cluster can pin
        # both: pass `clock=sched.now` and a seeded `entropy=rng.bytes`
        # under the deterministic scheduler. The wall clock and urandom
        # defaults are for real deployments only (the construction path
        # is crypto/at_rest.default_encryption, called in a role
        # process, cluster/multiprocess.py, outside the simulation).
        self._clock = clock if clock is not None else time.time
        self._entropy = entropy if entropy is not None else os.urandom
        self.refresh_interval = (
            SERVER_KNOBS.ENCRYPT_KEY_REFRESH_INTERVAL
            if refresh_interval is None else refresh_interval
        )
        self.expire_interval = expire_interval  # None = never expire
        self.fetches = 0  # KMS round trips (observability, tests)
        self._refreshing: set[int] = set()
        self._lock = threading.Lock()

    # -- the role API (EncryptKeyProxyInterface.h) ------------------------

    def get_latest_cipher(self, domain_id: int) -> BlobCipherKey:
        """The key roles encrypt new records with. Re-derives under a
        fresh salt (and picks up KMS rotations) once the cached latest
        passes its refresh deadline."""
        try:
            return self.cache.latest(domain_id)
        except KeyError:
            pass
        base_id, secret = self.kms.fetch_base_key(domain_id)
        self.fetches += 1
        salt = self._entropy(16)
        now = self._clock()
        key = BlobCipherKey(
            domain_id=domain_id, base_id=base_id, salt=salt,
            key=derive_key(secret, domain_id, base_id, salt),
            refresh_at=now + self.refresh_interval,
            expire_at=(
                float("inf") if self.expire_interval is None
                else now + self.expire_interval
            ),
        )
        self.cache.insert(key)
        return key

    def get_latest_cipher_nonblocking(self, domain_id: int) -> BlobCipherKey:
        """The seal path's variant, which never blocks on the KMS once
        a domain is warm: a stale (past-refresh) key is still used while
        one background thread refreshes it (the reference's refresh is a
        background actor too, EncryptKeyProxy.actor.cpp
        refreshEncryptionKeysCore); a commit path must not stall up to
        the KMS timeout under the apply lock. Blocks only at a domain's
        very first use (nothing cached; a role prefetches at start to
        avoid even that)."""
        key = self.cache.latest_any(domain_id)
        if key is None or not key.usable_for_decrypt():
            # nothing cached, or the cached latest passed its expire
            # deadline: sealing under an expired key would make records
            # this process refuses to read back, so block for a fresh
            # key (correctness over latency)
            return self.get_latest_cipher(domain_id)
        if key.usable_for_encrypt():
            return key
        with self._lock:
            spawn = domain_id not in self._refreshing
            if spawn:
                self._refreshing.add(domain_id)
        if spawn:
            def refresh():
                try:
                    self.get_latest_cipher(domain_id)
                except Exception as e:
                    # keep sealing under the stale key and retry at the
                    # next call, but a failing KMS must be visible
                    from foundationdb_tpu_torch.utils.trace import (
                        SEV_WARN,
                        TraceEvent,
                    )

                    TraceEvent("EKPRefreshFailed", severity=SEV_WARN) \
                        .detail("Domain", domain_id) \
                        .detail("Err", repr(e)).log()
                finally:
                    with self._lock:
                        self._refreshing.discard(domain_id)

            threading.Thread(target=refresh, daemon=True).start()
        return key

    def get_cipher_by_id(self, domain_id: int, base_id: int,
                         salt: bytes) -> BlobCipherKey:
        """The key a stored record's header names (the decryption path).
        A cache miss goes to the KMS by id (the reference's
        getEncryptCipherKeys by baseCipherId). An expired key is not a
        miss: its retirement stands, or expire_interval could not be
        enforced. (In-process expiry is a cache policy: a restarted
        process fetches again unless the KMS itself revoked the base id,
        kms.revoke, the retirement that survives a restart; by-id keys
        derived here inherit expire_interval.)"""
        try:
            return self.cache.lookup(domain_id, base_id, salt)
        except CipherKeyExpiredError:
            raise
        except KeyError:
            secret = self.kms.fetch_base_key_by_id(domain_id, base_id)
            self.fetches += 1
            key = BlobCipherKey(
                domain_id=domain_id, base_id=base_id, salt=salt,
                key=derive_key(secret, domain_id, base_id, salt),
                refresh_at=0.0,  # by-id keys serve decryption only
                expire_at=(
                    float("inf") if self.expire_interval is None
                    else self._clock() + self.expire_interval
                ),
            )
            self.cache.insert(key, latest=False)
            return key
