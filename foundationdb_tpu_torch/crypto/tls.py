"""Mutual TLS for the wire transport: the flow/TLSConfig analog (the
port's own copy of `TLSConfig` from foundationdb_tpu.crypto.tls).

Every connection is mutual TLS: server and client present certificates
chained to the cluster's CA, and either side drops a peer that fails
verification (the reference's verify_peers). `server_context` /
`client_context` build ssl.SSLContexts that enforce TLS >= 1.2,
CERT_REQUIRED both ways and the cluster CA as the only root; hostname
checks give way to CA pinning and subject checks, because nodes are
addressed by socket path or port, not by DNS name.

The contexts need only the standard `ssl` module. The organization
check (`verify_peer_organization`) parses the peer's certificate with
the `cryptography` package, imported when the check runs: without it
that check raises, and everything else works. The certificate tooling
(`generate_ca`, `issue_cert`, `make_test_tls`) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import ssl
from typing import Optional


@dataclasses.dataclass
class TLSConfig:
    """PEM paths + peer verification policy (TLSConfig + verify_peers)."""

    ca_file: str
    cert_file: str
    key_file: str
    #: Optional required O= (organization) on the PEER certificate (the
    #: reference's verify_peers "O=..." check). None = any cert under
    #: the CA.
    verify_peer_organization: Optional[str] = None

    def _base_context(self, purpose: ssl.Purpose) -> ssl.SSLContext:
        ctx = ssl.SSLContext(
            ssl.PROTOCOL_TLS_SERVER
            if purpose is ssl.Purpose.CLIENT_AUTH
            else ssl.PROTOCOL_TLS_CLIENT
        )
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.load_cert_chain(self.cert_file, self.key_file)
        ctx.load_verify_locations(self.ca_file)
        ctx.verify_mode = ssl.CERT_REQUIRED  # mutual TLS both ways
        ctx.check_hostname = False  # CA pinning + subject checks instead
        return ctx

    def server_context(self) -> ssl.SSLContext:
        return self._base_context(ssl.Purpose.CLIENT_AUTH)

    def client_context(self) -> ssl.SSLContext:
        return self._base_context(ssl.Purpose.SERVER_AUTH)

    def verify_peer(self, ssl_object) -> None:
        """Post-handshake peer-attribute check (TLSPolicy::verify_peer):
        raises ssl.SSLError when the peer cert's subject does not carry
        the required organization. Needs the `cryptography` package
        (raises ImportError without it) only when an organization is
        required."""
        if self.verify_peer_organization is None:
            return
        from cryptography import x509
        from cryptography.x509.oid import NameOID

        der = ssl_object.getpeercert(binary_form=True)
        if der is None:
            raise ssl.SSLError("peer presented no certificate")
        cert = x509.load_der_x509_certificate(der)
        orgs = [
            a.value
            for a in cert.subject.get_attributes_for_oid(
                NameOID.ORGANIZATION_NAME
            )
        ]
        if self.verify_peer_organization not in orgs:
            raise ssl.SSLError(
                f"peer organization {orgs!r} does not match required "
                f"{self.verify_peer_organization!r}"
            )
