"""Mutual TLS for the wire transport: the flow/TLSConfig analog (the
port's own copy of foundationdb_tpu.crypto.tls).

Every connection is mutual TLS: server and client present certificates
chained to the cluster's CA, and either side drops a peer that fails
verification (the reference's verify_peers). `server_context` /
`client_context` build ssl.SSLContexts that enforce TLS >= 1.2,
CERT_REQUIRED both ways and the cluster CA as the only root; hostname
checks give way to CA pinning and subject checks, because nodes are
addressed by socket path or port, not by DNS name.

`generate_ca` and `issue_cert` mint a cluster CA and certificates of
its nodes (the reference ships mkcert.sh and loads PEM through OpenSSL:
the same primitives), and `make_test_tls` lays out one CA and one
certificate a name, the layout `FDB_TPU_TLS_DIR` names to a cluster
(ca.crt, node.crt, node.key). Certificates are the JAX package's kind:
either package's tooling makes a PKI the other's TLSConfig accepts.

The contexts need only the standard `ssl` module. The tooling and the
organization check (`verify_peer_organization`) use the `cryptography`
package, imported when they run: without it they raise, and mutual TLS
over PEM files made elsewhere still works.
"""

from __future__ import annotations

import dataclasses
import datetime
import ipaddress
import os
import ssl
from typing import Optional


def _name(common_name: str, organization: str):
    from cryptography import x509
    from cryptography.x509.oid import NameOID

    return x509.Name([
        x509.NameAttribute(NameOID.COMMON_NAME, common_name),
        x509.NameAttribute(NameOID.ORGANIZATION_NAME, organization),
    ])


def _write_pem_pair(cert, key, cert_path: str, key_path: str) -> None:
    from cryptography.hazmat.primitives import serialization

    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    with open(key_path, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        ))


def generate_ca(directory: str, *, organization: str = "fdb-tpu-cluster",
                days: int = 3650) -> tuple[str, str]:
    """Mint a cluster CA; returns (ca_cert_pem_path, ca_key_pem_path)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec

    os.makedirs(directory, exist_ok=True)
    key = ec.generate_private_key(ec.SECP256R1())
    now = datetime.datetime.now(datetime.timezone.utc)
    subject = _name("fdb-tpu-ca", organization)
    cert = (
        x509.CertificateBuilder()
        .subject_name(subject)
        .issuer_name(subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                       critical=True)
        .sign(key, hashes.SHA256())
    )
    cert_path = os.path.join(directory, "ca.crt")
    key_path = os.path.join(directory, "ca.key")
    _write_pem_pair(cert, key, cert_path, key_path)
    return cert_path, key_path


def issue_cert(directory: str, ca_cert_path: str, ca_key_path: str,
               common_name: str, *, organization: str = "fdb-tpu-cluster",
               days: int = 825) -> tuple[str, str]:
    """Issue a node certificate signed by the CA; returns
    (cert_pem_path, key_pem_path)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec

    with open(ca_cert_path, "rb") as f:
        ca_cert = x509.load_pem_x509_certificate(f.read())
    with open(ca_key_path, "rb") as f:
        ca_key = serialization.load_pem_private_key(f.read(), password=None)
    key = ec.generate_private_key(ec.SECP256R1())
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(_name(common_name, organization))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(
            x509.SubjectAlternativeName([
                x509.DNSName(common_name),
                x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
            ]),
            critical=False,
        )
        .sign(ca_key, hashes.SHA256())
    )
    cert_path = os.path.join(directory, f"{common_name}.crt")
    key_path = os.path.join(directory, f"{common_name}.key")
    _write_pem_pair(cert, key, cert_path, key_path)
    return cert_path, key_path


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


def make_test_tls(directory: str, names=("server", "client"), **kw):
    """One CA and one certificate a name: the test and cluster-bootstrap
    helper. Returns {name: TLSConfig}."""
    ca_cert, ca_key = generate_ca(directory, **kw)
    out = {}
    for n in names:
        cert, key = issue_cert(directory, ca_cert, ca_key, n, **kw)
        out[n] = TLSConfig(ca_file=ca_cert, cert_file=cert, key_file=key)
    return out
