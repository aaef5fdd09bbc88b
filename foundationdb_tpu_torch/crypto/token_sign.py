"""Tenant authorization tokens: signed, expiring capability grants (the
port's own copy of foundationdb_tpu.crypto.token_sign).

Capability match for fdbrpc/TokenSign.cpp, TokenCache.actor.cpp and the
authorization design (design/authorization.md): an external identity
provider signs a token naming the tenants a client may touch and an
expiry; servers verify the signature against trusted public keys and
cache verified tokens by signature; a request for a tenant the token
does not name (or with an expired or forged token) is refused with
permission_denied before any data is read.

Tokens are ECDSA-P256 over a canonical JSON payload (the reference signs
FlatBuffers with EC or RSA through OpenSSL: the same class of primitive,
through the `cryptography` package). The format is the JAX package's: a
token signed by either package verifies in the other. `cryptography` is
imported by the functions that sign and verify, when they run.
"""

from __future__ import annotations

import base64
import json
import time


class PermissionDeniedError(RuntimeError):
    """error_code_permission_denied: a missing, expired or forged token,
    or one that does not grant the tenant touched."""


def generate_keypair():
    """(private_key, public_pem): the identity provider's signing key and
    the PEM servers trust."""
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import ec

    key = ec.generate_private_key(ec.SECP256R1())
    pub = key.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo,
    )
    return key, pub


def sign_token(private_key, *, tenants: list[bytes], expires_at: float,
               key_id: str = "default") -> bytes:
    """Mint a token granting `tenants` until `expires_at` (unix)."""
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec

    payload = json.dumps({
        "kid": key_id,
        "tenants": [t.decode("latin-1") for t in tenants],
        "exp": expires_at,
    }, sort_keys=True).encode()
    sig = private_key.sign(payload, ec.ECDSA(hashes.SHA256()))
    return base64.b64encode(payload) + b"." + base64.b64encode(sig)


class TokenVerifier:
    """Server-side verification and its cache (TokenCache.actor.cpp:
    verified tokens are cached by signature, so a steady-state request
    pays a dict hit, not an ECDSA verify)."""

    def __init__(self, trusted_keys: dict[str, bytes]):
        from cryptography.hazmat.primitives import serialization

        # key_id -> public key (from its PEM)
        self._keys = {
            kid: serialization.load_pem_public_key(pem)
            for kid, pem in trusted_keys.items()
        }
        self._cache: dict[bytes, dict] = {}
        self.verifies = 0  # ECDSA verifications made (observability)

    @staticmethod
    def _validate_claims(claims) -> None:
        """Check the decoded payload's shape before any field is used: a
        validly signed but malformed token (a hostile or faulty identity
        provider) surfaces as permission_denied, never as a TypeError or
        KeyError in the request path (the reference's TokenSign parse
        errors all map to error_code_permission_denied)."""
        if not isinstance(claims, dict):
            raise ValueError(
                f"claims must be an object, got {type(claims).__name__}")
        if not isinstance(claims.get("kid"), str):
            raise ValueError("claim 'kid' missing or not a string")
        exp = claims.get("exp")
        if isinstance(exp, bool) or not isinstance(exp, (int, float)):
            raise ValueError("claim 'exp' missing or not a number")
        tenants = claims.get("tenants")
        if not isinstance(tenants, list) or not all(
            isinstance(t, str) for t in tenants
        ):
            raise ValueError("claim 'tenants' missing or not a string list")

    def _verify(self, token: bytes) -> dict:
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import ec

        cached = self._cache.get(token)
        if cached is not None:
            return cached
        try:
            payload_b64, sig_b64 = token.split(b".", 1)
            payload = base64.b64decode(payload_b64)
            sig = base64.b64decode(sig_b64)
            claims = json.loads(payload)
            self._validate_claims(claims)
            pub = self._keys[claims["kid"]]
            self.verifies += 1
            pub.verify(sig, payload, ec.ECDSA(hashes.SHA256()))
        except (KeyError, TypeError, ValueError, InvalidSignature) as e:
            raise PermissionDeniedError(f"invalid token: {e!r}")
        self._cache[token] = claims
        if len(self._cache) > 4096:  # bounded, like TokenCache
            self._cache.pop(next(iter(self._cache)))
        return claims

    def check(self, token: bytes | None, tenant: bytes,
              now: float = None) -> None:
        """Raise PermissionDeniedError unless `token` is valid, fresh and
        grants `tenant`."""
        if token is None:
            raise PermissionDeniedError("no authorization token")
        claims = self._verify(token)
        now = time.time() if now is None else now
        if now >= claims["exp"]:
            raise PermissionDeniedError("token expired")
        if tenant.decode("latin-1") not in claims["tenants"]:
            raise PermissionDeniedError(
                f"token does not grant tenant {tenant!r}"
            )
