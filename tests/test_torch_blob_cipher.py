"""The port's at-rest cipher (`crypto/blob_cipher.py`, `cluster/kms.py`,
`cluster/encrypt_key_proxy.py`, `crypto/at_rest.py`) held against the
JAX package's on the CPU.

* Every case of tests/test_blob_cipher.py on the port's modules: the
  round trip, tamper and wrong-key refusals, rotation, the by-id fetch
  after a cache loss, revocation, the proxy's cache, the REST KMS stub,
  empty and large payloads, a rotation across a fresh connector, the
  non-blocking seal, an expired latest key, the forged auth domain, the
  cross-domain record and StorageEncryption's refusals.
* Across the packages: the sim KMS's secrets, the derived keys and the
  header layout are equal; with a fixed IV and the same BlobCipherKey
  both `encrypt`s give the same bytes; a record sealed by either
  package opens in the other (through the cipher cache and through
  StorageEncryption, after a by-id fetch); a record tampered in either
  package raises AuthTokenError in both.
"""

from __future__ import annotations

import time

import pytest

pytest.importorskip("cryptography")

from foundationdb_tpu.cluster import encrypt_key_proxy as JEKP
from foundationdb_tpu.cluster import kms as JKMS
from foundationdb_tpu.crypto import at_rest as JAR
from foundationdb_tpu.crypto import blob_cipher as JBC
from foundationdb_tpu_torch.cluster.encrypt_key_proxy import EncryptKeyProxy
from foundationdb_tpu_torch.cluster.kms import (
    KmsError,
    RestKmsConnector,
    SimKmsConnector,
    serve_stub_kms,
)
from foundationdb_tpu_torch.crypto import (
    AuthTokenError,
    BlobCipherKey,
    decrypt,
    encrypt,
)
from foundationdb_tpu_torch.crypto import at_rest as PAR
from foundationdb_tpu_torch.crypto import blob_cipher as PBC
from foundationdb_tpu_torch.crypto.blob_cipher import (
    SYSTEM_DOMAIN_ID,
    CipherKeyNotFoundError,
    EncryptHeader,
    is_encrypted,
)
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from time_limit import limit_each_test

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

_limit = limit_each_test(60)


def make_proxy(**kw):
    return EncryptKeyProxy(SimKmsConnector(), refresh_interval=600, **kw)


def seal(proxy, payload, key):
    """Encrypt with the system domain's header-auth cipher (decrypt
    refuses any other auth identity)."""
    return encrypt(payload, key, proxy.get_latest_cipher(SYSTEM_DOMAIN_ID))


# ---------------------------------------------------------------------------
# tests/test_blob_cipher.py on the port


def test_roundtrip_and_header_identity():
    proxy = make_proxy()
    key = proxy.get_latest_cipher(7)
    blob = seal(proxy, b"hello at rest", key)
    assert is_encrypted(blob)
    assert b"hello at rest" not in blob
    assert decrypt(blob, proxy.cache) == b"hello at rest"


def test_tamper_raises_auth_token_error():
    proxy = make_proxy()
    key = proxy.get_latest_cipher(1)
    blob = bytearray(seal(proxy, b"payload" * 100, key))
    blob[-1] ^= 0x40  # a ciphertext bit
    with pytest.raises(AuthTokenError):
        decrypt(bytes(blob), proxy.cache)
    # a header bit (the text domain's id)
    blob2 = bytearray(seal(proxy, b"x", key))
    blob2[6] ^= 0x01
    with pytest.raises((AuthTokenError, CipherKeyNotFoundError)):
        decrypt(bytes(blob2), proxy.cache)


def test_wrong_key_refuses():
    proxy_a = make_proxy()
    proxy_b = EncryptKeyProxy(SimKmsConnector(b"other-kms"),
                              refresh_interval=600)
    key_a = proxy_a.get_latest_cipher(1)
    proxy_b.get_latest_cipher(1)
    blob = seal(proxy_a, b"secret", key_a)
    # proxy_b holds domain 1 under another derived identity (its salt)
    with pytest.raises((AuthTokenError, CipherKeyNotFoundError)):
        decrypt(blob, proxy_b.cache)


def test_rotation_old_records_still_decrypt():
    kms = SimKmsConnector()
    proxy = EncryptKeyProxy(kms, refresh_interval=0)  # re-derive each call
    k1 = proxy.get_latest_cipher(3)
    old = seal(proxy, b"written under base 1", k1)
    kms.rotate(3)
    k2 = proxy.get_latest_cipher(3)
    assert k2.base_id == k1.base_id + 1
    new = seal(proxy, b"written under base 2", k2)
    assert decrypt(old, proxy.cache) == b"written under base 1"
    assert decrypt(new, proxy.cache) == b"written under base 2"


def test_by_id_fetch_after_cache_loss():
    """A restarted process holds records naming (baseId, salt) pairs its
    fresh cache has never seen: the by-id KMS path rebuilds them."""
    kms = SimKmsConnector()
    proxy = EncryptKeyProxy(kms, refresh_interval=600)
    blob = seal(proxy, b"survives restart", proxy.get_latest_cipher(5))
    fresh = EncryptKeyProxy(kms, refresh_interval=600)
    hdr = EncryptHeader.unpack(blob)
    fresh.get_cipher_by_id(hdr.domain_id, hdr.base_id, hdr.salt)
    fresh.get_cipher_by_id(hdr.header_domain_id, hdr.header_base_id,
                           hdr.header_salt)
    assert decrypt(blob, fresh.cache) == b"survives restart"


def test_revoked_base_key():
    kms = SimKmsConnector()
    proxy = EncryptKeyProxy(kms, refresh_interval=600)
    key = proxy.get_latest_cipher(9)
    kms.revoke(9, key.base_id)
    fresh = EncryptKeyProxy(kms, refresh_interval=600)
    with pytest.raises(KmsError):
        fresh.get_cipher_by_id(9, key.base_id, key.salt)


def test_proxy_caches_kms_round_trips():
    proxy = make_proxy()
    for _ in range(10):
        proxy.get_latest_cipher(1)
        proxy.get_latest_cipher(2)
    assert proxy.fetches == 2  # one a domain


def test_rest_kms_stub_server():
    srv, port = serve_stub_kms()
    try:
        assert srv.server_address[0] == "127.0.0.1"
        rest = RestKmsConnector(f"127.0.0.1:{port}")
        proxy = EncryptKeyProxy(rest, refresh_interval=600)
        key = proxy.get_latest_cipher(11)
        blob = seal(proxy, b"over REST", key)
        assert decrypt(blob, proxy.cache) == b"over REST"
        # a rotation over REST; the old generation still fetches by id
        rest.rotate(11)
        proxy2 = EncryptKeyProxy(rest, refresh_interval=600)
        k2 = proxy2.get_latest_cipher(11)
        assert k2.base_id == key.base_id + 1
        proxy2.get_cipher_by_id(key.domain_id, key.base_id, key.salt)
        hdr = EncryptHeader.unpack(blob)
        proxy2.get_cipher_by_id(hdr.header_domain_id, hdr.header_base_id,
                                hdr.header_salt)
        assert decrypt(blob, proxy2.cache) == b"over REST"
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("payload", [b"", b"\x00" * 1024,
                                     bytes(range(256)) * 4096],
                         ids=["empty", "1KB", "1MB"])
def test_empty_and_large_payloads(payload):
    proxy = make_proxy()
    key = proxy.get_latest_cipher(0)
    assert decrypt(seal(proxy, payload, key), proxy.cache) == payload


def test_rotation_survives_fresh_kms_connector():
    """A restarted process builds a fresh SimKmsConnector: records sealed
    under a rotated base id still open (the secrets are deterministic),
    and the by-id fetch does not move the fresh counter."""
    kms = SimKmsConnector()
    kms.rotate(4)  # base id 2
    proxy = EncryptKeyProxy(kms, refresh_interval=600)
    key = proxy.get_latest_cipher(4)
    assert key.base_id == 2
    blob = seal(proxy, b"post-rotation", key)
    fresh = EncryptKeyProxy(SimKmsConnector(), refresh_interval=600)
    fresh.get_cipher_by_id(key.domain_id, key.base_id, key.salt)
    hdr = EncryptHeader.unpack(blob)
    fresh.get_cipher_by_id(hdr.header_domain_id, hdr.header_base_id,
                           hdr.header_salt)
    assert decrypt(blob, fresh.cache) == b"post-rotation"
    bid, _ = fresh.kms.fetch_base_key(4)
    assert bid == 1


def test_nonblocking_seal_uses_stale_key_and_refreshes():
    """Past the refresh deadline the seal path seals under the stale key
    at once while one background thread refreshes it."""

    class SlowKms(SimKmsConnector):
        def __init__(self):
            super().__init__()
            self.calls = 0

        def fetch_base_key(self, domain_id):
            self.calls += 1
            if self.calls > 1:
                time.sleep(0.2)  # a slow KMS after the first fetch
            return super().fetch_base_key(domain_id)

    proxy = EncryptKeyProxy(SlowKms(), refresh_interval=0.01)
    k1 = proxy.get_latest_cipher(1)
    time.sleep(0.02)  # k1 is past its refresh deadline
    t0 = time.perf_counter()
    k2 = proxy.get_latest_cipher_nonblocking(1)
    took = time.perf_counter() - t0
    assert took < 0.1, f"the seal path waited on the KMS ({took:.3f}s)"
    assert k2.salt == k1.salt  # the stale key, at once
    deadline = time.time() + 2
    while time.time() < deadline:
        if proxy.cache.latest_any(1).salt != k1.salt:
            break
        time.sleep(0.02)
    assert proxy.cache.latest_any(1).salt != k1.salt


def test_expired_latest_forces_fresh_derivation():
    """expire_interval < refresh_interval: once the latest key expires
    the next seal derives a fresh key."""
    proxy = EncryptKeyProxy(SimKmsConnector(), refresh_interval=600,
                            expire_interval=0.05)
    k1 = proxy.get_latest_cipher(1)
    time.sleep(0.06)
    k2 = proxy.get_latest_cipher(1)
    assert k2.salt != k1.salt
    k3 = proxy.get_latest_cipher_nonblocking(1)
    assert k3.salt != k1.salt
    assert decrypt(seal(proxy, b"readable", k3), proxy.cache) == b"readable"


def test_forged_header_auth_domain_rejected():
    """A forger holding a non-system domain's key does not get to name
    it as the header-auth cipher."""
    proxy = make_proxy()
    attacker_key = proxy.get_latest_cipher(7)
    forged = encrypt(b"evil payload", attacker_key, attacker_key)
    with pytest.raises(AuthTokenError, match="auth domain"):
        decrypt(forged, proxy.cache)
    # an auth key passed by the caller bypasses the cache lookup
    assert decrypt(forged, proxy.cache, attacker_key) == b"evil payload"


def test_cross_domain_record_rejected_by_expected_domain():
    proxy = make_proxy()
    blob = seal(proxy, b"domain 7 data", proxy.get_latest_cipher(7))
    assert decrypt(blob, proxy.cache, expected_domain_id=7) == b"domain 7 data"
    with pytest.raises(AuthTokenError, match="text domain"):
        decrypt(blob, proxy.cache, expected_domain_id=8)


def test_storage_encryption_refuses_foreign_records():
    """StorageEncryption.open checks the header's cipher details before
    any KMS fetch: a forged auth identity and another domain's record
    are refused."""
    proxy = make_proxy()
    enc = PAR.StorageEncryption(proxy, domain_id=1)
    assert enc.open(enc.seal(b"mine")) == b"mine"
    attacker_key = proxy.get_latest_cipher(1)
    with pytest.raises(AuthTokenError, match="auth domain"):
        enc.open(encrypt(b"evil", attacker_key, attacker_key))
    other = PAR.StorageEncryption(proxy, domain_id=2)
    with pytest.raises(AuthTokenError, match="text domain"):
        enc.open(other.seal(b"not yours"))
    s = enc.stats()
    assert (s["seals"], s["opens"]) == (1, 1) and s["seal_seconds"] > 0


# ---------------------------------------------------------------------------
# across the packages

PKGS = {"jax": (JBC, JKMS, JEKP, JAR), "port": (PBC, None, None, PAR)}


def _proxies(entropy_seed: int):
    """A JAX and a port EncryptKeyProxy on the sim KMS with the same
    injected clock and entropy: they derive the same keys."""
    import random

    def entropy():
        r = random.Random(entropy_seed)
        return lambda n: bytes(r.getrandbits(8) for _ in range(n))

    clock = lambda: 1000.0  # noqa: E731
    j = JEKP.EncryptKeyProxy(JKMS.SimKmsConnector(), refresh_interval=600,
                             clock=clock, entropy=entropy())
    p = EncryptKeyProxy(SimKmsConnector(), refresh_interval=600,
                        clock=clock, entropy=entropy())
    return j, p


@pytest.mark.parametrize("domain", [SYSTEM_DOMAIN_ID, -1, 0, 7, 1 << 40])
def test_kms_secrets_and_derived_keys_equal(domain):
    jk, pk = JKMS.SimKmsConnector(), SimKmsConnector()
    assert jk.fetch_base_key(domain) == pk.fetch_base_key(domain)
    for base_id in (1, 2, 9):
        assert (jk.fetch_base_key_by_id(domain, base_id)
                == pk.fetch_base_key_by_id(domain, base_id))
    assert jk.rotate(domain) == pk.rotate(domain)
    secret = pk.fetch_base_key(domain)[1]
    salt = bytes(range(16))
    assert (JBC.derive_key(secret, domain, 2, salt)
            == PBC.derive_key(secret, domain, 2, salt))
    j, p = _proxies(domain & 0xFFFF)
    assert j.get_latest_cipher(domain).__dict__ == \
        p.get_latest_cipher(domain).__dict__


@pytest.mark.parametrize("payload", [b"", b"k" * 7, bytes(range(256)) * 40],
                         ids=["empty", "short", "10KB"])
def test_fixed_iv_records_byte_identical(payload):
    j, p = _proxies(3)
    jt, ja = j.get_latest_cipher(5), j.get_latest_cipher(SYSTEM_DOMAIN_ID)
    pt, pa = p.get_latest_cipher(5), p.get_latest_cipher(SYSTEM_DOMAIN_ID)
    assert jt.__dict__ == pt.__dict__ and ja.__dict__ == pa.__dict__
    iv = bytes(range(100, 116))
    jb = JBC.encrypt(payload, jt, ja, iv=iv)
    # the same BlobCipherKey objects through both, and each package's own
    assert PBC.encrypt(payload, jt, ja, iv=iv) == jb
    assert PBC.encrypt(payload, pt, pa, iv=iv) == jb
    assert PBC.HEADER_BYTES == JBC.HEADER_BYTES
    assert EncryptHeader.unpack(jb).__dict__ == \
        JBC.EncryptHeader.unpack(jb).__dict__
    assert PBC.EncryptHeader(**JBC.EncryptHeader.unpack(jb).__dict__).pack() \
        == jb[:PBC._HEADER.size]


@pytest.mark.parametrize("sealer", ["jax", "port"])
def test_records_open_across_packages(sealer):
    """A record sealed by one package opens in the other, through a
    fresh proxy's by-id fetch (a restarted process of the other
    package) and through StorageEncryption."""
    bc, _k, _e, ar = PKGS[sealer]
    opener = "port" if sealer == "jax" else "jax"
    obc, _ok, _oe, oar = PKGS[opener]
    j, p = _proxies(11)
    seal_proxy, open_proxy = (j, p) if sealer == "jax" else (p, j)
    payload = b"sealed by " + sealer.encode() + bytes(range(256))
    key = seal_proxy.get_latest_cipher(PBC.DEFAULT_DOMAIN_ID)
    auth = seal_proxy.get_latest_cipher(SYSTEM_DOMAIN_ID)
    blob = bc.encrypt(payload, key, auth)
    # the other package's fresh proxy (another salt stream) fetches by id
    fresh = (EncryptKeyProxy(SimKmsConnector(), refresh_interval=600)
             if opener == "port" else
             JEKP.EncryptKeyProxy(JKMS.SimKmsConnector(),
                                  refresh_interval=600))
    hdr = obc.EncryptHeader.unpack(blob)
    fresh.get_cipher_by_id(hdr.domain_id, hdr.base_id, hdr.salt)
    fresh.get_cipher_by_id(hdr.header_domain_id, hdr.header_base_id,
                           hdr.header_salt)
    assert obc.decrypt(blob, fresh.cache) == payload
    # StorageEncryption: one package's seal, the other's open
    store = ar.StorageEncryption(seal_proxy)
    sealed = store.seal(payload)
    assert oar.StorageEncryption(open_proxy).open(sealed) == payload


#: byte offsets in a record: the version byte, the text salt, the header
#: salt, the IV, the auth token, the ciphertext's last byte
TAMPER = {"version": 4, "salt": 40, "header_salt": 60, "iv": 75,
          "token": 100, "ciphertext": -1}


@pytest.mark.parametrize("where", list(TAMPER.values()), ids=list(TAMPER))
@pytest.mark.parametrize("sealer", ["jax", "port"])
def test_tampered_records_refused_in_both(sealer, where):
    j, p = _proxies(13)
    seal_proxy = j if sealer == "jax" else p
    bc = PKGS[sealer][0]
    blob = bytearray(bc.encrypt(
        b"do not touch" * 20,
        seal_proxy.get_latest_cipher(PBC.DEFAULT_DOMAIN_ID),
        seal_proxy.get_latest_cipher(SYSTEM_DOMAIN_ID)))
    blob[where] ^= 0x04
    for proxy, dec in ((j, JBC.decrypt), (p, PBC.decrypt)):
        proxy.get_latest_cipher(PBC.DEFAULT_DOMAIN_ID)
        proxy.get_latest_cipher(SYSTEM_DOMAIN_ID)
        with pytest.raises((AuthTokenError, JBC.AuthTokenError,
                            CipherKeyNotFoundError,
                            JBC.CipherKeyNotFoundError)) as e:
            dec(bytes(blob), proxy.cache)
        if where not in (40, 60):  # the cipher identities stay valid
            assert type(e.value).__name__ == "AuthTokenError"


def test_blob_cipher_key_fields_equal():
    names = [f.name for f in PBC.dataclasses.fields(BlobCipherKey)]
    assert names == [f.name for f in JBC.dataclasses.fields(JBC.BlobCipherKey)]
    assert (PBC.SYSTEM_DOMAIN_ID, PBC.DEFAULT_DOMAIN_ID,
            PBC.ENCRYPT_HEADER_MAGIC, PBC.ENCRYPT_HEADER_VERSION) == (
        JBC.SYSTEM_DOMAIN_ID, JBC.DEFAULT_DOMAIN_ID,
        JBC.ENCRYPT_HEADER_MAGIC, JBC.ENCRYPT_HEADER_VERSION)
