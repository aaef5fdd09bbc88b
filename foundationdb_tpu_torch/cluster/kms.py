"""KMS connectors: where the encryption base secrets come from (the
port's own copy of foundationdb_tpu.cluster.kms).

The reference speaks to a KMS through a connector interface
(fdbserver/KmsConnectorInterface.h) with two implementations:
SimKmsConnector.actor.cpp (deterministic in-memory keys for simulation)
and RESTKmsConnector.actor.cpp (a REST KMS over HTTP). Both are here:
SimKmsConnector derives deterministic base secrets a domain from a
master seed (the JAX package's seed, so both packages derive the same
secrets), and RestKmsConnector speaks JSON over HTTP to any server with
the two-endpoint surface (`serve_stub_kms` is such a server, on the
loopback only, standing in for the external KMS the reference assumes).

A base secret never leaves the KMS boundary unwrapped in the
reference's production deployment; here the connector returns it to the
EncryptKeyProxy, which derives record keys and hands only derived keys
to roles (crypto/blob_cipher.derive_key): the same trust split.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import threading


class KmsError(RuntimeError):
    pass


class SimKmsConnector:
    """Deterministic KMS (fdbserver/SimKmsConnector.actor.cpp): base
    secrets are HMACs of the domain id under a master seed, so every
    process in a simulation derives identical keys without coordination.
    Rotation bumps the per-domain base-id counter."""

    def __init__(self, master_seed: bytes = b"fdb-tpu-sim-kms"):
        self._seed = master_seed
        self._base_ids: dict[int, int] = {}
        self._revoked: set[tuple[int, int]] = set()

    def _secret(self, domain_id: int, base_id: int) -> bytes:
        msg = f"{domain_id}:{base_id}".encode()
        return hmac.new(self._seed, msg, hashlib.sha256).digest()

    def fetch_base_key(self, domain_id: int) -> tuple[int, bytes]:
        """Latest (base_id, base_secret) for a domain."""
        base_id = self._base_ids.setdefault(domain_id, 1)
        return base_id, self._secret(domain_id, base_id)

    def fetch_base_key_by_id(self, domain_id: int, base_id: int) -> bytes:
        if (domain_id, base_id) in self._revoked:
            raise KmsError(f"base key {base_id} of domain {domain_id} revoked")
        if base_id < 1:
            raise KmsError(f"bad base id {base_id} for domain {domain_id}")
        # Secrets are deterministic functions of (seed, domain, id): a
        # fresh connector in a restarted process serves the generations
        # an earlier process rotated to, or an encrypted store would not
        # open after a restart. The rotation counter is not floored
        # here: by-id requests carry ids read from unverified on-disk
        # headers, and a corrupted header must not steer which
        # generation fetch_base_key serves next. A garbage id yields a
        # key whose HMAC then fails: loud and stateless.
        return self._secret(domain_id, base_id)

    def rotate(self, domain_id: int) -> int:
        """Force a new base key (the KMS-driven rotation path)."""
        self._base_ids[domain_id] = self._base_ids.get(domain_id, 1) + 1
        return self._base_ids[domain_id]

    def revoke(self, domain_id: int, base_id: int) -> None:
        self._revoked.add((domain_id, base_id))


class RestKmsConnector:
    """JSON-over-HTTP connector (fdbserver/RESTKmsConnector.actor.cpp):
    POST /getEncryptionKeys with {"domain_ids": [...]} or
    {"cipher_ids": [[domain, base_id], ...]} returns base keys hex-coded.
    Synchronous stdlib HTTP: the proxy calls it from an executor."""

    def __init__(self, endpoint: str):
        # endpoint: "host:port"
        self.endpoint = endpoint

    def _post(self, body: dict) -> dict:
        import http.client

        host, port = self.endpoint.rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=10)
        try:
            conn.request(
                "POST", "/getEncryptionKeys", json.dumps(body),
                {"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise KmsError(f"KMS HTTP {resp.status}: {data[:200]!r}")
            return json.loads(data)
        finally:
            conn.close()

    def fetch_base_key(self, domain_id: int) -> tuple[int, bytes]:
        out = self._post({"domain_ids": [domain_id]})
        entry = out["keys"][0]
        return int(entry["base_id"]), bytes.fromhex(entry["secret"])

    def fetch_base_key_by_id(self, domain_id: int, base_id: int) -> bytes:
        out = self._post({"cipher_ids": [[domain_id, base_id]]})
        return bytes.fromhex(out["keys"][0]["secret"])

    def rotate(self, domain_id: int) -> int:
        out = self._post({"rotate": domain_id})
        return int(out["base_id"])


def serve_stub_kms(port: int = 0) -> tuple[object, int]:
    """A stub REST KMS backed by SimKmsConnector, for tests and local
    clusters (the reference's tests point RESTKmsConnector at such a
    fake, fdbserver/workloads/RESTKmsWorkloads). It binds the loopback
    only. Returns (http.server instance, bound port); the caller shuts
    it down."""
    import http.server

    sim = SimKmsConnector()

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_POST(self):
            if self.path != "/getEncryptionKeys":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            try:
                if "rotate" in body:
                    out = {"base_id": sim.rotate(int(body["rotate"]))}
                elif "domain_ids" in body:
                    keys = []
                    for d in body["domain_ids"]:
                        bid, sec = sim.fetch_base_key(int(d))
                        keys.append({
                            "domain_id": d, "base_id": bid,
                            "secret": sec.hex(),
                        })
                    out = {"keys": keys}
                elif "cipher_ids" in body:
                    keys = []
                    for d, bid in body["cipher_ids"]:
                        sec = sim.fetch_base_key_by_id(int(d), int(bid))
                        keys.append({
                            "domain_id": d, "base_id": bid,
                            "secret": sec.hex(),
                        })
                    out = {"keys": keys}
                else:
                    raise KmsError("bad request")
                data = json.dumps(out).encode()
                self.send_response(200)
            except KmsError as e:
                data = json.dumps({"error": str(e)}).encode()
                self.send_response(400)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]
