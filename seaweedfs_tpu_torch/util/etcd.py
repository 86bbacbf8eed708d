"""Shared etcd v3 grpc-gateway REST client (/v3/kv/*).

One client for everything that speaks to etcd — the EtcdSequencer and
the etcd filer store — so endpoint parsing, failover, transport, and
error classification live in exactly one place. Plain-http endpoints
ride the pooled keep-alive raw-socket transport (client/operation.py:
the filer store puts this on the metadata hot path, and a TCP
handshake per metadata op is exactly the cost that transport was built
to remove); https endpoints fall back to urllib.

The port of seaweedfs_tpu/util/etcd.py.
"""

from __future__ import annotations

import http.client
import json
import threading
import urllib.error
import urllib.request


class EtcdHttpError(RuntimeError):
    """The endpoint answered with a non-200 — reachable but
    misconfigured (gateway disabled, wrong service, auth). Distinct
    from OSError so 'cannot reach' guidance never fires for it."""

    def __init__(self, status: int, body: bytes):
        super().__init__(f"etcd gateway http {status}: {body[:200]!r}")
        self.status = status


class EtcdKv:
    """POST /v3/kv/<op> against the first endpoint that answers; a
    working endpoint rotates to the front so steady state dials it
    directly. HTTP errors (the endpoint answered) are not
    failover-able and raise EtcdHttpError; connection-level failures
    try the next endpoint."""

    def __init__(self, urls: str, timeout: float = 10.0):
        endpoints = []
        for u in urls.split(","):
            u = u.strip().rstrip("/")
            if not u:
                continue
            if not u.startswith("http"):
                u = "http://" + u
            endpoints.append(u)
        if not endpoints:
            raise ValueError("etcd client needs at least one endpoint")
        self._endpoints = endpoints
        self._lock = threading.Lock()  # guards the rotation
        self.timeout = timeout

    def _post(self, endpoint: str, op: str, body: bytes) -> tuple[int, bytes]:
        if endpoint.startswith("http://"):
            from seaweedfs_tpu_torch.client.operation import http_call

            status, _, resp = http_call(
                "POST",
                endpoint[len("http://") :] + f"/v3/kv/{op}",
                body=body,
                headers={"Content-Type": "application/json"},
                timeout=self.timeout,
            )
            return status, resp
        req = urllib.request.Request(
            f"{endpoint}/v3/kv/{op}",
            data=body,
            method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def call(self, op: str, payload: dict) -> dict:
        with self._lock:
            endpoints = list(self._endpoints)
        body = json.dumps(payload).encode()
        last: OSError | None = None
        for endpoint in endpoints:
            try:
                status, resp = self._post(endpoint, op, body)
            except (OSError, http.client.HTTPException) as e:
                # the pooled transport surfaces some transport faults
                # as HTTPException (e.g. IncompleteRead) — same
                # failover treatment as a socket error
                last = e if isinstance(e, OSError) else OSError(str(e))
                continue
            if status != 200:
                raise EtcdHttpError(status, resp)
            if endpoint != endpoints[0]:
                with self._lock:
                    if endpoint in self._endpoints:
                        self._endpoints.remove(endpoint)
                        self._endpoints.insert(0, endpoint)
            return json.loads(resp)
        raise last if last is not None else OSError("no endpoints")
