"""Tenant authorization tokens (`crypto/token_sign.py` on
`cluster.token_verifier`, checked by `cluster/tenant.py`) held against
the JAX package's on the CPU.

* Twins (tests/twins.py) of the cluster tests of tests/test_authz.py on
  `open_cluster` (the port's with device="cpu"), through both pairs of
  backends: a valid token grants its tenant and its verification is
  cached; a missing, another tenant's, forged, expired (on the
  scheduler's clock) or edited token is permission_denied and commits
  nothing; without a verifier tenants work tokenless. The digests
  (results, every storage snapshot, virtual time, unhandled errors,
  probes) are equal.
* The validly signed tokens with malformed claims of tests/test_authz.py,
  refused by the port's verifier and the JAX one alike.
* Across the packages: a token signed by either package is accepted or
  denied by the other's verifier exactly as by its own.
* chip_smoke.py phase 20's token leg at a small size on the plain
  versions gives the decision counts the card's run is held to.
"""

from __future__ import annotations

import base64
import importlib

import pytest

pytest.importorskip("cryptography")

from foundationdb_tpu.crypto import token_sign as JTS
from foundationdb_tpu_torch.crypto import token_sign as PTS
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from time_limit import limit_each_test
from twins import PAIR_IDS, PAIRS, check_twin

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

_limit = limit_each_test(180)

TWINS = {}


def twin(fn):
    TWINS[fn.__name__] = fn
    return fn


def token_sign(w):
    return importlib.import_module(f"{w.P.name}.crypto.token_sign")


def authorized_world(w):
    """tests/test_authz.py's fixture: one commit proxy, two storage
    servers and a verifier trusting one identity provider's key."""
    sched, cluster, db = w.open(n_commit_proxies=1, n_storage=2)
    TS = token_sign(w)
    key, pub = TS.generate_keypair()
    cluster.token_verifier = TS.TokenVerifier({"idp": pub})
    return sched, cluster, db, key, TS


def denied(TS, fn):
    """The name of the error `fn()` raised ("PermissionDeniedError" when
    the token was refused), or "allowed"."""
    try:
        fn()
    except TS.PermissionDeniedError as e:
        return type(e).__name__
    return "allowed"


@twin
def valid_token_grants_access(w):
    sched, cluster, db, key, TS = authorized_world(w)
    T = w.P.tenant

    async def body():
        await T.create_tenant(db, b"acme")
        tok = TS.sign_token(key, tenants=[b"acme"],
                            expires_at=sched.now() + 60, key_id="idp")
        t = T.Tenant(db, b"acme", token=tok)

        async def write(txn):
            await txn.set(b"k", b"v")

        await t.run(write)
        got = await t.create_transaction().get(b"k")
        # verified once, then served from the signature cache
        return got, cluster.token_verifier.verifies

    got, verifies = w.run(sched, body())
    assert (got, verifies) == (b"v", 1)
    return got, verifies


@twin
def missing_wrong_forged_expired_all_denied(w):
    sched, cluster, db, key, TS = authorized_world(w)
    T = w.P.tenant

    async def body():
        await T.create_tenant(db, b"acme")
        await T.create_tenant(db, b"rival")
        now = sched.now()
        tok_rival = TS.sign_token(key, tenants=[b"rival"],
                                  expires_at=now + 60, key_id="idp")
        rogue_key, _ = TS.generate_keypair()
        forged = TS.sign_token(rogue_key, tenants=[b"acme"],
                               expires_at=now + 60, key_id="idp")
        # expiry on the scheduler's clock (deterministic under the sim)
        stale = TS.sign_token(key, tenants=[b"acme"],
                              expires_at=now - 0.001, key_id="idp")
        good = TS.sign_token(key, tenants=[b"rival"], expires_at=now + 60,
                             key_id="idp")
        payload, sig = good.split(b".", 1)
        edited = base64.b64encode(
            base64.b64decode(payload).replace(b"rival", b"acmee")[:-1]
        ) + b"." + sig
        out = {}
        for name, tok in (("missing", None), ("other tenant", tok_rival),
                          ("forged", forged), ("expired", stale),
                          ("edited", edited)):
            out[name] = denied(TS, lambda: T.Tenant(
                db, b"acme", token=tok).create_transaction())
        # nothing reached the tenant's keyspace
        rows = await db.create_transaction().get_range(
            T.TENANT_DATA_PREFIX, T.TENANT_DATA_PREFIX + b"\xff")
        return out, rows, cluster.token_verifier.verifies

    out, rows, verifies = w.run(sched, body())
    assert set(out.values()) == {"PermissionDeniedError"}, out
    assert rows == [] and verifies == 3  # rival's, forged, expired
    return out, rows, verifies


@twin
def no_verifier_means_open_cluster(w):
    """Authorization is opt-in: without a verifier, tenants work
    tokenless."""
    sched, cluster, db, _key, _TS = authorized_world(w)
    cluster.token_verifier = None
    T = w.P.tenant

    async def body():
        await T.create_tenant(db, b"open")
        t = T.Tenant(db, b"open")

        async def write(txn):
            await txn.set(b"k", b"v")

        await t.run(write)
        return await t.create_transaction().get(b"k")

    assert w.run(sched, body()) == b"v"
    return b"v"


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("name", list(TWINS))
def test_twin(name, pair):
    check_twin(TWINS[name], pair)


def test_twins_cover_the_reference():
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).parent / "test_authz.py").read_text())
    wanted = {n.name.removeprefix("test_") for n in tree.body
              if isinstance(n, ast.FunctionDef)
              and n.name.startswith("test_")}
    # the one reference test without a cluster is ported as it stands
    assert wanted - set(TWINS) == {"validly_signed_malformed_claims_denied"}
    assert "test_validly_signed_malformed_claims_denied" in globals()


# ---------------------------------------------------------------------------
# validly signed, malformed claims; tokens across the packages


def _sign_raw(private_key, payload: bytes) -> bytes:
    """Sign an arbitrary payload (a hostile or faulty identity provider:
    the signature is valid, the claims are not)."""
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec

    sig = private_key.sign(payload, ec.ECDSA(hashes.SHA256()))
    return base64.b64encode(payload) + b"." + base64.b64encode(sig)


MALFORMED = [
    b'[1, 2, 3]',                                            # not an object
    b'"just a string"',
    b'{}',                                                   # no claims
    b'{"kid": "default"}',                                   # no exp, tenants
    b'{"kid": "default", "exp": "soon", "tenants": ["t"]}',  # string exp
    b'{"kid": "default", "exp": true, "tenants": ["t"]}',    # bool exp
    b'{"kid": 5, "exp": 1e18, "tenants": ["t"]}',            # number kid
    b'{"kid": "default", "exp": 1e18, "tenants": "t"}',      # tenants a str
    b'{"kid": "default", "exp": 1e18, "tenants": [1, 2]}',   # number tenant
]


@pytest.mark.parametrize("payload", MALFORMED)
def test_validly_signed_malformed_claims_denied(payload):
    key, pub = PTS.generate_keypair()
    token = _sign_raw(key, payload)
    with pytest.raises(PTS.PermissionDeniedError):
        PTS.TokenVerifier({"default": pub}).check(token, b"t")
    with pytest.raises(JTS.PermissionDeniedError):
        JTS.TokenVerifier({"default": pub}).check(token, b"t")


def _tokens(TS, key, now: float) -> dict:
    rogue, _ = TS.generate_keypair()
    good = TS.sign_token(key, tenants=[b"acme", b"beta"],
                         expires_at=now + 60, key_id="idp")
    payload, sig = good.split(b".", 1)
    return {
        "valid": good,
        "other tenant": TS.sign_token(key, tenants=[b"rival"],
                                      expires_at=now + 60, key_id="idp"),
        "unknown key id": TS.sign_token(key, tenants=[b"acme"],
                                        expires_at=now + 60, key_id="nope"),
        "forged": TS.sign_token(rogue, tenants=[b"acme"],
                                expires_at=now + 60, key_id="idp"),
        "expired": TS.sign_token(key, tenants=[b"acme"],
                                 expires_at=now - 1, key_id="idp"),
        "edited": base64.b64encode(base64.b64decode(payload).replace(
            b"beta", b"gama")) + b"." + sig,
        "malformed": _sign_raw(key, b'{"kid": "idp", "exp": true}'),
        "garbage": b"not-a-token",
    }


@pytest.mark.parametrize("signer", ["jax", "port"])
def test_tokens_across_packages(signer):
    S = JTS if signer == "jax" else PTS
    key, pub = S.generate_keypair()
    now = 1_000_000.0
    outcomes = {}
    for name, tok in _tokens(S, key, now).items():
        row = []
        for V in (JTS, PTS):
            verifier = V.TokenVerifier({"idp": pub})
            for tenant in (b"acme", b"beta"):
                try:
                    verifier.check(tok, tenant, now=now)
                    row.append("allowed")
                except V.PermissionDeniedError:
                    row.append("denied")
        outcomes[name] = row
    for name, row in outcomes.items():
        assert row[:2] == row[2:], (name, row)  # JAX's verdict, the port's
    assert outcomes["valid"] == ["allowed"] * 4
    assert all(set(r) == {"denied"} for n, r in outcomes.items()
               if n != "valid"), outcomes
    # the signature cache: one ECDSA verify a token, in both verifiers
    for V in (JTS, PTS):
        verifier = V.TokenVerifier({"idp": pub})
        tok = _tokens(S, key, now)["valid"]
        for _ in range(5):
            verifier.check(tok, b"acme", now=now)
        assert verifier.verifies == 1


def test_chip_smoke_token_leg_on_the_plain_versions():
    """chip_smoke.py phase 20's leg B (`se_leg_authz`) at a small size on
    the plain versions: every tenant reads back its rows, every denial is
    refused, and the decision counts are those the card's run is held
    to (a short-lived token and the tenant's own allowed a tenant, each
    kind denied once a tenant, one ECDSA verify a distinct signed
    token)."""
    import chip_smoke as C

    out = C.fx_call("authz", dict(tenants=3, records=20), "cpu",
                    C.fx_twin_config())
    assert out["numbers"]["decisions"] == {
        "allowed": 6, "denied": {k: 3 for k in C.SE_DENIALS},
        "verifies": 9}
    assert out["parts"]["unhandled"] == []
