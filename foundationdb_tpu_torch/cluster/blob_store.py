"""S3-class blob store: a REST object server + container client.

Capability match for fdbclient/S3BlobStore.actor.cpp (+ the
BackupContainer URL schemes blobstore://...): the reference's backup
and blob-granule stacks talk to an S3-compatible object store over
HTTP — bucket/object PUT/GET/DELETE, prefix listing. This module
provides BOTH halves so the capability is testable with zero egress:

* `serve_blob_store` — a local object server (stdlib http.server,
  threaded) with the S3-ish surface: `PUT /b/<key>` stores bytes,
  `GET /b/<key>` retrieves, `DELETE /b/<key>` removes,
  `GET /b?prefix=` lists keys (newline-separated), ETag = md5 like S3.
* `BlobStoreContainer` — a BackupContainer speaking that protocol via
  http.client, so backups, parallel restore, and blob granules run
  against an object store exactly as the reference's do against S3.

The store persists to a directory (objects as files, names hex-escaped)
so a restarted server still serves its buckets — durability semantics a
backup target needs.

The port's own copy of foundationdb_tpu.cluster.blob_store.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import urllib.parse

from foundationdb_tpu_torch.cluster.backup import (
    BackupContainer,
    _jsonable,
    _unjsonable,
)


def _escape(name: str) -> str:
    return urllib.parse.quote(name, safe="")


def _unescape(name: str) -> str:
    return urllib.parse.unquote(name)


def serve_blob_store(directory: str, port: int = 0):
    """Start the object server; returns (server, port). Caller shuts
    down with server.shutdown()."""
    import http.server

    os.makedirs(directory, exist_ok=True)
    lock = threading.Lock()

    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _path(self):
            parsed = urllib.parse.urlparse(self.path)
            parts = parsed.path.lstrip("/").split("/", 1)
            # the URL carries percent-escaped segments; store/serve by
            # the LOGICAL key so listings round-trip
            bucket = _unescape(parts[0])
            key = _unescape(parts[1]) if len(parts) > 1 else ""
            qs = urllib.parse.parse_qs(parsed.query)
            return bucket, key, qs

        def _send(self, code: int, body: bytes = b"",
                  etag: str | None = None):
            self.send_response(code)
            if etag:
                self.send_header("ETag", f'"{etag}"')
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if body:
                self.wfile.write(body)

        def do_PUT(self):
            bucket, key, _qs = self._path()
            if not bucket or not key:
                self._send(400)
                return
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            bdir = os.path.join(directory, _escape(bucket))
            with lock:
                os.makedirs(bdir, exist_ok=True)
                tmp = os.path.join(bdir, _escape(key) + ".tmp")
                with open(tmp, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, os.path.join(bdir, _escape(key)))
            self._send(200, etag=hashlib.md5(data).hexdigest())

        def do_GET(self):
            bucket, key, qs = self._path()
            bdir = os.path.join(directory, _escape(bucket))
            if not key:  # list with ?prefix=
                prefix = qs.get("prefix", [""])[0]
                with lock:
                    if not os.path.isdir(bdir):
                        self._send(200, b"")
                        return
                    names = sorted(
                        _unescape(f)
                        for f in os.listdir(bdir)
                        if not f.endswith(".tmp")
                    )
                body = "\n".join(
                    n for n in names if n.startswith(prefix)
                ).encode()
                self._send(200, body)
                return
            path = os.path.join(bdir, _escape(key))
            with lock:
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except FileNotFoundError:
                    self._send(404)
                    return
            self._send(200, data, etag=hashlib.md5(data).hexdigest())

        def do_DELETE(self):
            bucket, key, _qs = self._path()
            path = os.path.join(directory, _escape(bucket), _escape(key))
            with lock:
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    self._send(404)
                    return
            self._send(204)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]


class BlobStoreError(RuntimeError):
    pass


class BlobStoreContainer(BackupContainer):
    """BackupContainer over the blob-store REST protocol (the
    blobstore:// container class). Values are the same JSON encoding
    the directory container uses, so backups are medium-portable."""

    def __init__(self, endpoint: str, bucket: str = "backup"):
        self.endpoint = endpoint  # "host:port"
        self.bucket = bucket
        self._conn = None  # persistent HTTP/1.1 keep-alive connection

    def _connection(self):
        if self._conn is None:
            import http.client

            host, port = self.endpoint.rsplit(":", 1)
            self._conn = http.client.HTTPConnection(
                host, int(port), timeout=30
            )
        return self._conn

    def _request(self, method: str, key: str = "", body: bytes = None,
                 query: str = ""):
        path = f"/{_escape(self.bucket)}"
        if key:
            path += f"/{_escape(key)}"
        if query:
            path += f"?{query}"
        # one persistent keep-alive connection per container (a backup
        # writes one object per pulled batch — per-request TCP setup
        # was pure overhead); one reconnect retry
        # covers a server-side idle close
        for attempt in (0, 1):
            conn = self._connection()
            try:
                conn.request(method, path, body)
                resp = conn.getresponse()
                data = resp.read()
                break
            except (ConnectionError, OSError):
                self._conn = None
                conn.close()
                if attempt:
                    raise
        if resp.status == 404:
            raise FileNotFoundError(key)
        if resp.status >= 300:
            raise BlobStoreError(f"{method} {path} -> HTTP {resp.status}")
        return data

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def write_file(self, name: str, data) -> None:
        self._request(
            "PUT", name, json.dumps(_jsonable(data)).encode()
        )

    def read_file(self, name: str):
        return _unjsonable(json.loads(self._request("GET", name)))

    def delete_file(self, name: str) -> None:
        self._request("DELETE", name)

    def list_files(self, prefix: str = "") -> list[str]:
        body = self._request(
            "GET", query="prefix=" + urllib.parse.quote(prefix)
        )
        return [n for n in body.decode().split("\n") if n]
