"""Client operations: assign / upload / submit / download / lookup /
delete over pooled keep-alive HTTP and gRPC, and `http_call`, the
leader proxy's hop.

The part of seaweedfs_tpu/client/operation.py the port needs so far
(behavioral match of weed/operation/):
  * assign            — /dir/assign on a master (assign_file_id.go:33)
  * upload            — POST bytes to a volume server (upload_content.go)
  * submit_file       — assign+upload, auto-splitting big payloads into
                        chunks behind a chunk-manifest needle
                        (submit.go:40,112, chunked_file.go)
  * download / delete — GET / DELETE one blob
  * lookup            — cached LookupVolume (lookup.go), lookup_file_id
  * delete_files      — BatchDelete per server (delete_content.go:43)
  * with_master_failover — rotate a call through the master seed list
                        in bounded, jittered rounds (the filer's hop)
The reference's gRPC assign and tails are not ported: the shell, the
filer and the CLI's tools do not use them.
"""

from __future__ import annotations

import functools
import http.client
import json
import random
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field

import grpc

from seaweedfs_tpu_torch.client import retry as _retry
from seaweedfs_tpu_torch.pb import master_pb2, rpc, volume_pb2
from seaweedfs_tpu_torch.pb.rpc import grpc_address
from seaweedfs_tpu_torch.stats.metrics import RETRY_TOTAL
from seaweedfs_tpu_torch.util import deadline as _deadline
from seaweedfs_tpu_torch.util.deadline import DeadlineExceeded


# ----------------------------------------------------------------------
# HA master failover


def _is_retryable_master_error(e: Exception) -> bool:
    """Transport failures and leaderless windows rotate to the next
    master; in-band application errors (e.g. 'no free volumes') come
    from the leader itself — every master proxies to the same place,
    so retrying them elsewhere just multiplies the same failure."""
    if isinstance(e, DeadlineExceeded):
        return False  # the caller's budget is gone wherever we turn
    if isinstance(e, (OSError, grpc.RpcError)):
        return True
    return "no leader" in str(e)


# Bounded, jittered rounds over the seed list: a leader SIGKILL lands
# mid-election, so the first rotation often finds only "no leader yet"
# followers; the backoff is sized to span one election timeout
# (cluster/raft.py defaults 0.4-0.8 s) without hammering the survivors.
_MASTER_ROUNDS = 4
_MASTER_BACKOFF_S = 0.15
_MASTER_BACKOFF_MAX_S = 1.5


def with_master_failover(masters, fn, start_idx: int = 0):
    """Run fn(master) against the first master that answers, rotating
    through the seed list on connection/RPC failure (any live master
    serves: non-leaders proxy writes to the leader). Returns
    (result, index_of_master_used); raises the last error when every
    master stays down.

    A whole-list failure (a leader kill with the new election still in
    flight) starts another round after a full-jitter exponential
    backoff, at most _MASTER_ROUNDS rounds in all. Each later round
    spends a token of the process-wide retry budget, runs under the
    retry marker, and is not started when the ambient request deadline
    would be gone before it lands."""
    if not masters:
        raise RuntimeError("no masters configured")
    n = len(masters)
    dl = _deadline.effective()
    for rnd in range(_MASTER_ROUNDS):
        last: Exception | None = None
        for i in range(n):
            idx = (start_idx + i) % n
            try:
                if not rnd:
                    return fn(masters[idx]), idx
                with _retry.retrying():
                    return fn(masters[idx]), idx
            except (RuntimeError, OSError, grpc.RpcError) as e:
                if not _is_retryable_master_error(e):
                    raise
                last = e
        if rnd + 1 == _MASTER_ROUNDS:
            break
        wait = random.uniform(0.0, min(_MASTER_BACKOFF_MAX_S, _MASTER_BACKOFF_S * 2**rnd))
        if dl is not None and dl.remaining() <= wait + _deadline.MIN_OP_TIMEOUT_S:
            break
        if not _retry.DEFAULT_BUDGET.try_spend():
            break
        RETRY_TOTAL.labels("master-failover").inc()
        time.sleep(wait)
    raise last


# ----------------------------------------------------------------------
# assign


@dataclass
class AssignResult:
    fid: str
    url: str
    public_url: str
    count: int
    error: str = ""
    auth: str = ""  # write-JWT for the fid; pass as upload(jwt=...)


@functools.lru_cache(maxsize=1024)
def _upload_query(filename: str, ttl: str, is_chunk_manifest: bool) -> str:
    """Encoded upload query params, memoized (filenames repeat heavily
    in bulk ingest: the benchmark, filer chunk uploads)."""
    q: dict[str, str] = {}
    if filename:
        q["filename"] = filename
    if ttl:
        q["ttl"] = ttl
    if is_chunk_manifest:
        q["cm"] = "true"
    return urllib.parse.urlencode(q)


@functools.lru_cache(maxsize=1024)
def _assign_query(
    count: int, replication: str, collection: str, ttl: str, data_center: str
) -> str:
    """Encoded /dir/assign query, memoized — writers issue the same
    parameter tuple per call, and urllib quoting is a measurable share
    of the client's per-write CPU."""
    params = {"count": str(count)}
    if replication:
        params["replication"] = replication
    if collection:
        params["collection"] = collection
    if ttl:
        params["ttl"] = ttl
    if data_center:
        params["dataCenter"] = data_center
    return urllib.parse.urlencode(params)


def assign(
    master: str,
    count: int = 1,
    replication: str = "",
    collection: str = "",
    ttl: str = "",
    data_center: str = "",
) -> AssignResult:
    """Assign over the pooled keep-alive HTTP plane (/dir/assign).

    The reference's operation.Assign rides gRPC; in Python, a unary
    grpc call costs several times a pooled http.client round-trip on
    the CPython side (measured: the benchmark writer spends more in
    grpc channel machinery than in the upload itself), so the hot
    path uses HTTP."""
    q = _assign_query(count, replication, collection, ttl, data_center)
    status, _, body = http_call("GET", f"{master}/dir/assign?{q}", timeout=30)
    try:
        # decode first: json.loads(bytes) runs detect_encoding per call
        d = json.loads(body.decode("utf-8", "replace"))
    except ValueError:
        raise RuntimeError(f"assign: bad response {body[:200]!r}")
    if status != 200 or d.get("error"):
        raise RuntimeError(f"assign: {d.get('error', f'http {status}')}")
    return AssignResult(
        d["fid"],
        d["url"],
        d.get("publicUrl", d["url"]),
        d.get("count", count),
        auth=d.get("auth", ""),
    )


# ----------------------------------------------------------------------
# upload


@dataclass
class UploadResult:
    name: str = ""
    size: int = 0
    etag: str = ""
    error: str = ""


# --- pooled keep-alive HTTP (the Go http.Client role) ----------------
#
# urllib.request opens and closes a TCP connection per call; the
# servers all speak HTTP/1.1 keep-alive, so the data plane's hot path
# (assign→upload, lookup→download) was paying a handshake plus
# TIME_WAIT churn per blob. One http.client.HTTPConnection per
# (thread, host) fixes that — thread-local because HTTPConnection is
# not thread-safe. A pooled connection can go stale between calls
# (server restart, idle timeout); one retry on a fresh connection
# mirrors Go's transport behavior.

_http_pool = threading.local()


class _RawHTTPConnection:
    """Minimal HTTP/1.1 client connection on a raw socket.

    http.client routes every response through the email-parser header
    machinery (policy objects, MIME content-type parsing); under the
    write benchmark that parsing costs more CPU than the needle append
    being benchmarked. This class composes the request in one buffer
    (one sendall — with Nagle disabled so nothing waits on a delayed
    ACK) and parses responses with a split-on-colon loop into the
    case-insensitive FastHeaders map. Supports what the cluster's own
    servers speak: HTTP/1.1 keep-alive, Content-Length and chunked
    bodies, 100-continue interim responses."""

    def __init__(self, host: str, port: int, timeout: float):
        from seaweedfs_tpu_torch.util.httpd import _BufReader

        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, True)
        self.rfile = _BufReader(self.sock)
        self.timeout = timeout
        self._host = host if port == 80 else f"{host}:{port}"

    def settimeout(self, timeout: float) -> None:
        self.timeout = timeout
        self.sock.settimeout(timeout)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def send_request(
        self, method: str, path: str, body: bytes | None, headers: dict
    ) -> None:
        buf = bytearray(
            f"{method} {path} HTTP/1.1\r\nHost: {self._host}\r\n".encode("latin-1")
        )
        for k, v in headers.items():
            buf += f"{k}: {v}\r\n".encode("latin-1")
        if body is not None or method in ("POST", "PUT"):
            buf += b"Content-Length: %d\r\n" % (len(body) if body else 0)
        buf += b"\r\n"
        if body:
            buf += body
        self.sock.sendall(buf)

    def _read_exact(self, n: int) -> bytes:
        data = self.rfile.read(n)
        if len(data) != n:
            raise http.client.IncompleteRead(data, n - len(data))
        return data

    def read_response(self, method: str):
        """(status, FastHeaders, body, will_close)."""
        from seaweedfs_tpu_torch.util.httpd import FastHeaders

        while True:
            # whole head in one buffer scan + ONE decode: readline-per-
            # header and per-line bytes strip/lower/decode were the
            # client hot loop's biggest Python cost after syscalls
            head = self.rfile.read_head()
            if not head:
                raise http.client.RemoteDisconnected("no status line")
            lines = head[:-4].decode("iso-8859-1").split("\r\n")
            line = lines[0]
            if (
                (line[:9] == "HTTP/1.1 " or line[:9] == "HTTP/1.0 ")
                and line[9:12].isdigit()
            ):
                version = "HTTP/1.1" if line[7] == "1" else "HTTP/1.0"
                status = int(line[9:12])
            else:
                parts = line.split(None, 2)
                if len(parts) < 2 or not parts[0].startswith("HTTP/"):
                    raise http.client.BadStatusLine(line)
                try:
                    version, status = parts[0], int(parts[1])
                except ValueError:
                    raise http.client.BadStatusLine(line) from None
            headers = FastHeaders()
            for hline in lines[1:]:
                key, sep, value = hline.partition(":")
                if sep:
                    headers[key.strip().lower()] = value.strip()
            if status != 100:
                break
            # 100 Continue: interim — the real response follows
        conn_tok = headers.get("connection", "").lower()
        will_close = conn_tok == "close" or (
            version == "HTTP/1.0" and conn_tok != "keep-alive"
        )
        body = b""
        if method != "HEAD" and status not in (204, 304):
            if "chunked" in headers.get("transfer-encoding", "").lower():
                pieces = []
                while True:
                    szline = self.rfile.readline(65537).strip()
                    if not szline:
                        # EOF mid-body is truncation, NOT a terminal
                        # 0-size chunk — callers must never get a
                        # partial body under a 200
                        raise http.client.IncompleteRead(
                            b"".join(pieces)
                        )
                    try:
                        size = int(szline.split(b";")[0], 16)
                    except ValueError:
                        raise http.client.HTTPException(
                            f"bad chunk size {szline[:32]!r}"
                        ) from None
                    if size == 0:
                        while True:  # trailers until blank line
                            t = self.rfile.readline(65537)
                            if t in (b"\r\n", b"\n", b""):
                                break
                        break
                    pieces.append(self._read_exact(size))
                    self.rfile.readline(65537)  # CRLF after each chunk
                body = b"".join(pieces)
            elif "content-length" in headers:
                try:
                    n = int(headers["content-length"])
                except ValueError:
                    raise http.client.HTTPException(
                        f"bad Content-Length {headers['content-length']!r}"
                    ) from None
                body = self._read_exact(n)
            else:
                # EOF-delimited HTTP/1.0-style body: unbounded by spec;
                # the pooled socket carries a recv deadline, so a dead
                # peer trips the timeout, not an infinite park
                # weedlint: ignore[hot-loop-unbounded-read] — EOF framing is the protocol here and the socket timeout bounds every recv
                body = self.rfile.read()
                will_close = True
        return status, headers, body, will_close


def _pooled_conn(netloc: str, timeout: float):
    """Returns (connection, reused): reused=True only when an already-
    established socket came out of the pool — the one case where a
    send failure means 'idle connection went stale' rather than 'the
    server is down or slow'."""
    conns = getattr(_http_pool, "conns", None)
    if conns is None:
        conns = _http_pool.conns = {}
    c = conns.get(netloc)
    if c is None:
        host, _, port = netloc.partition(":")
        c = _RawHTTPConnection(host, int(port or 80), timeout=timeout)
        conns[netloc] = c
        return c, False
    if c.timeout != timeout:
        # the pool caches the connection, not the first caller's
        # deadline: re-arm per call
        c.settimeout(timeout)
    return c, True


def _drop_conn(netloc: str) -> None:
    c = getattr(_http_pool, "conns", {}).pop(netloc, None)
    if c is not None:
        c.close()


# whole-request wall bound for calls with NO propagated deadline: the
# per-socket-op `timeout` still governs each recv, but the request as
# a whole may not outlive timeout × this factor — a server trickling
# one byte per timeout window used to hold the caller indefinitely
_WALL_FACTOR = 4.0


def http_call(
    method: str,
    url: str,
    body: bytes | None = None,
    headers: dict | None = None,
    timeout: float = 30.0,
    max_redirects: int = 3,
    shed_retries: int = 2,
    deadline=None,
) -> tuple[int, dict, bytes]:
    """Keep-alive request; returns (status, headers, body). Follows
    redirects (volume read-redirect 302s). `url` may omit the scheme.

    Deadline plane (docs/CHAOS.md): `deadline` (else the ambient
    request deadline a serving funnel installed) bounds the WHOLE call
    — every socket operation's timeout is derived from the remaining
    budget, the `X-Weed-Deadline` hop header is re-stamped per attempt
    so downstream daemons share the clock, and an exhausted budget
    raises DeadlineExceeded. Calls with no deadline anywhere still get
    a whole-request wall bound of timeout × 4: `timeout` alone is
    per-socket-op, so a trickling response used to reset it forever.

    QoS plane (docs/QOS.md): a 503 carrying Retry-After is admission
    control shedding load, NOT a dead server — the request was never
    processed, so any method is safe to re-send. Up to `shed_retries`
    retries honor the server's hint with jitter (so a shed thundering
    herd doesn't re-arrive in phase), each charged to the process-wide
    retry budget (client/retry.py) so shed clients cannot storm;
    `WEED_QOS=0` (or shed_retries=0) returns the 503 untouched."""

    if "://" in url:
        scheme, _, url = url.partition("://")
        if scheme != "http":
            raise ValueError(f"pooled transport is http-only, got {scheme!r}")
    headers = dict(headers or {})
    # tracing plane: every pooled-transport hop (assign, upload,
    # lookup-download, filer chunk writes, worker proxying) carries the
    # current span's context so the receiving daemon parents under it
    from seaweedfs_tpu_torch import trace as _trace

    _trace.inject(headers)
    dl = _deadline.effective(deadline)
    if dl is not None:
        # span evidence for the deadline plane: how much budget this
        # hop entered with (the 504-fast-reject test reads it back)
        _trace.annotate("deadline_ms", round(dl.remaining() * 1000.0, 1))
    # the wall clock bounds everything below — redirects, shed waits,
    # every socket op; only a REAL deadline rides the hop header
    wall = dl if dl is not None else _deadline.Deadline.after(
        timeout * _WALL_FACTOR
    )
    # retry-budget deposit: FIRST-ATTEMPT calls only (a RetryPolicy
    # retry runs under the in_retry marker) — retried requests
    # crediting themselves would re-earn part of their own cost and
    # drift the amplification cap from ~1+r toward 1/(1-k·r)
    if not _retry.in_retry():
        _retry.DEFAULT_BUDGET.note_request()
    else:
        # weedscope hop marker: the serving side's flight recorder
        # flags this wide-event as a retried attempt (the x-weed-hedge
        # twin lives in qos/hedge — trace/blackbox.request_flags parses
        # both)
        headers["x-weed-retry"] = "1"
    hops = 0
    while hops <= max_redirects:
        netloc, slash, rest = url.partition("/")
        path = slash + rest or "/"
        idempotent = method in ("GET", "HEAD", "PUT", "DELETE", "OPTIONS")
        while True:
            c, reused = _pooled_conn(netloc, timeout)
            sent = False
            try:
                if dl is not None:
                    # re-stamp per attempt: remaining shrinks
                    headers[_deadline.DEADLINE_HEADER] = dl.header_value()
                # arm the whole-request bound: sendall gets one
                # deadline-capped window (CPython computes a single
                # deadline for the full sendall), and every response
                # recv re-arms through the reader
                c.sock.settimeout(wall.cap(timeout))
                c.rfile.deadline = wall
                c.rfile.op_timeout = timeout
                c.send_request(method, path, body, headers)
                sent = True
                status, rheaders, data, will_close = c.read_response(method)
                c.rfile.deadline = None
                break
            except (http.client.HTTPException, OSError) as e:
                _drop_conn(netloc)
                # Retry exactly the Go-transport case: an idle POOLED
                # connection that turned out stale. A fresh dial that
                # fails means the server is down; a timeout means it is
                # slow — re-sending there doubles the wait and can
                # double-apply a non-idempotent request. And once the
                # request went out in full (`sent`), the server may have
                # processed it even though the response never arrived —
                # replaying is only safe for idempotent methods (a POST
                # replayed there double-applies).
                if (
                    reused
                    and not isinstance(e, TimeoutError)
                    and (idempotent or not sent)
                ):
                    continue  # next _pooled_conn dials fresh (sock is gone)
                raise
        if status == 503 and shed_retries > 0:
            retry_after = rheaders.get("retry-after", "")
            if retry_after:
                from seaweedfs_tpu_torch import qos as _qos

                if _qos.enabled():
                    import random as _random

                    try:
                        ra = float(retry_after)
                    except ValueError:
                        ra = 1.0
                    # jittered, bounded wait: 50–100% of the server's
                    # hint so retries from many shed clients de-phase
                    wait = min(ra, 2.0) * (0.5 + _random.random() * 0.5)
                    # a retry the caller's budget can't pay for — or
                    # one the process-wide retry budget refuses — hands
                    # the 503 back instead of adding load
                    if (
                        wall.remaining() > wait
                        and _retry.DEFAULT_BUDGET.try_spend()
                    ):
                        from seaweedfs_tpu_torch.stats.metrics import RETRY_TOTAL

                        RETRY_TOTAL.labels("http-shed").inc()
                        if will_close:
                            _drop_conn(netloc)
                        shed_retries -= 1
                        time.sleep(wait)
                        continue
        if status in (301, 302, 303, 307, 308):
            loc = rheaders.get("Location", "")
            if loc:
                if will_close:
                    _drop_conn(netloc)
                target = urllib.parse.urljoin(f"http://{url}", loc)
                t_scheme, _, t_rest = target.partition("://")
                if t_scheme != "http":
                    # never silently downgrade an https redirect target
                    raise RuntimeError(
                        f"{method} {url}: redirect to non-http target {loc!r}"
                    )
                if t_rest.partition("/")[0] != netloc:
                    # a redirect that changes host must not carry the
                    # caller's write JWT to the new host
                    headers.pop("Authorization", None)
                if status in (301, 302, 303) and method == "POST":
                    # urllib/Go both redirect POST as a body-less GET
                    # for 301/302/303; only 307/308 preserve the method
                    method, body = "GET", None
                    headers.pop("Content-Type", None)
                url = t_rest
                hops += 1
                continue
        if will_close or status >= 400:
            # >=400: error handlers may reply before draining the
            # request body, leaving body bytes in the socket — reusing
            # the connection would parse them as the next request line
            _drop_conn(netloc)
        return status, rheaders, data
    raise RuntimeError(f"{method} {url}: too many redirects")


def upload(
    url: str,
    data: bytes,
    filename: str = "",
    mime: str = "",
    ttl: str = "",
    jwt: str = "",
    is_chunk_manifest: bool = False,
    timeout: float = 30.0,
) -> UploadResult:
    """POST a blob to ``http://<url>`` (url is "host:port/fid")."""
    q = _upload_query(filename, ttl, is_chunk_manifest)
    full = url
    if q:
        full += ("&" if "?" in full else "?") + q
    headers = {"Content-Type": mime or "application/octet-stream"}
    if jwt:
        headers["Authorization"] = f"BEARER {jwt}"
    try:
        status, _, raw = http_call("POST", full, body=data, headers=headers, timeout=timeout)
    except (OSError, http.client.HTTPException, RuntimeError) as e:
        # urllib wrapped every transport failure as URLError(OSError);
        # the pooled transport surfaces HTTPException (e.g.
        # IncompleteRead) and RuntimeError (redirect loop) too — all of
        # them are "the upload failed", not caller crashes
        return UploadResult(error=str(e))
    try:
        body = json.loads(raw.decode("utf-8", "replace") if raw else "{}")
    except ValueError:
        body = {}
    if status >= 300:
        return UploadResult(error=body.get("error", f"HTTP {status}"))
    if body.get("error"):
        return UploadResult(error=body["error"])
    return UploadResult(
        name=body.get("name", ""), size=int(body.get("size", 0)), etag=body.get("eTag", "")
    )


def download(fid_url: str, timeout: float = 30.0) -> tuple[bytes, dict]:
    """GET a blob; returns (bytes, headers)."""
    status, headers, data = http_call("GET", fid_url, timeout=timeout)
    if status >= 300:
        import io

        # keep the server's error body readable via e.read(), like the
        # urllib HTTPErrors this replaces
        raise urllib.error.HTTPError(
            f"http://{fid_url}", status, f"HTTP {status}", headers, io.BytesIO(data)
        )
    return data, headers


def delete(fid_url: str, timeout: float = 30.0, jwt: str = "") -> None:
    """DELETE a blob. Pass the assign-issued write JWT on signed
    clusters; auth failures raise (a swallowed 401 would silently leak
    the blob), while 404s stay idempotent no-ops."""
    headers = {}
    if jwt:
        headers["Authorization"] = f"BEARER {jwt}"
    status, _, _ = http_call("DELETE", fid_url, headers=headers, timeout=timeout)
    if status in (401, 403):
        raise RuntimeError(f"delete {fid_url}: not authorized ({status})")
    # 404 etc.: delete is idempotent


# ----------------------------------------------------------------------
# lookup (+cache)


@dataclass
class LookupResult:
    vid: str
    locations: list[dict] = field(default_factory=list)
    error: str = ""


class _CacheEntry:
    __slots__ = ("result", "expires")

    def __init__(self, result: LookupResult, ttl: float):
        self.result = result
        self.expires = time.time() + ttl


_lookup_cache: dict[tuple[str, str], _CacheEntry] = {}
_lookup_lock = threading.Lock()
LOOKUP_CACHE_TTL = 10 * 60  # lookup.go:18 (10 min)


def lookup(master: str, vid: str, collection: str = "") -> LookupResult:
    key = (master, vid)
    with _lookup_lock:
        entry = _lookup_cache.get(key)
        if entry and entry.expires > time.time():
            return entry.result
    ch = rpc.cached_channel(grpc_address(master))
    resp = rpc.master_stub(ch).LookupVolume(
        master_pb2.LookupVolumeRequest(vids=[vid], collection=collection)
    )
    result = LookupResult(vid=vid, error=f"volume {vid} not found")
    for e in resp.vid_locations:
        if e.vid == vid:
            result = LookupResult(
                vid=vid,
                # `suspect` (health plane, docs/HEALTH.md): the master
                # marks replicas it currently suspects; the filer read
                # path hedges eagerly when only suspects remain
                locations=[
                    {
                        "url": l.url,
                        "publicUrl": l.public_url,
                        "suspect": l.suspect,
                    }
                    for l in e.locations
                ],
                error=e.error,
            )
    if not result.error:
        # a result naming a SUSPECT replica is cached briefly: the
        # health verdict changes on heartbeat timescales, and pinning
        # it for the full 10 min would demote a healed node (or keep
        # routing at a sick one) long after the master knows better
        ttl = (
            10.0
            if any(loc.get("suspect") for loc in result.locations)
            else LOOKUP_CACHE_TTL
        )
        with _lookup_lock:
            _lookup_cache[key] = _CacheEntry(result, ttl)
    return result


def forget_lookup(master: str, vid: str) -> bool:
    """Drop the cached lookup of `vid` through `master`, so the next
    lookup asks the master again; True when there was one."""
    with _lookup_lock:
        return _lookup_cache.pop((master, vid), None) is not None


def lookup_file_id(master: str, fid: str) -> str:
    """fid → "host:port/fid" of one replica."""
    vid = fid.split(",")[0]
    result = lookup(master, vid)
    if result.error:
        raise RuntimeError(result.error)
    if not result.locations:
        raise RuntimeError(f"volume {vid} has no locations")
    return f"{result.locations[0]['url']}/{fid}"


# ----------------------------------------------------------------------
# batch delete


def delete_files(master: str, fids: list[str]) -> list[dict]:
    """Group fids by volume id, resolve each volume once, then issue one
    BatchDelete gRPC per server (delete_content.go:43)."""
    by_vid: dict[str, list[str]] = {}
    results: list[dict] = []
    for fid in fids:
        parts = fid.split(",")
        if len(parts) != 2:
            results.append({"fid": fid, "status": 400, "error": "invalid fid"})
            continue
        by_vid.setdefault(parts[0], []).append(fid)

    # every replica location gets the batch (delete_content.go sends to
    # all locations so no replica keeps the data)
    by_server: dict[str, list[str]] = {}
    primary: dict[str, str] = {}  # fid -> primary server (reported result)
    for vid, vid_fids in by_vid.items():
        # a delete asks the master afresh: a location cached before the
        # volume was EC-encoded may no longer hold it (a port departure;
        # the reference deletes through the cached lookup)
        forget_lookup(master, vid)
        res = lookup(master, vid)
        if res.error or not res.locations:
            for fid in vid_fids:
                results.append({"fid": fid, "status": 404, "error": res.error})
            continue
        for i, loc in enumerate(res.locations):
            by_server.setdefault(loc["url"], []).extend(vid_fids)
            if i == 0:
                for fid in vid_fids:
                    primary[fid] = loc["url"]

    for server, server_fids in by_server.items():
        try:
            with rpc.dial(grpc_address(server)) as ch:
                resp = rpc.volume_stub(ch).BatchDelete(
                    volume_pb2.BatchDeleteRequest(file_ids=server_fids)
                )
            for r in resp.results:
                if primary.get(r.file_id) == server:
                    results.append(
                        {
                            "fid": r.file_id,
                            "status": r.status,
                            "error": r.error,
                            "size": r.size,
                        }
                    )
        except grpc.RpcError as e:
            for fid in server_fids:
                if primary.get(fid) == server:
                    results.append({"fid": fid, "status": 500, "error": str(e)})
    return results


# ----------------------------------------------------------------------
# submit (auto-chunking behind a chunk manifest)


@dataclass
class SubmitResult:
    file_name: str
    fid: str
    file_url: str
    size: int
    error: str = ""


def submit_file(
    master: str,
    filename: str,
    data: bytes,
    replication: str = "",
    collection: str = "",
    ttl: str = "",
    mime: str = "",
    max_mb: int = 0,
) -> SubmitResult:
    """Assign one fid and upload; payloads over max_mb are split into
    chunks uploaded under their own fids and tied together by a
    chunk-manifest needle (submit.go:112 upload with chunking)."""
    ar = assign(master, count=1, replication=replication, collection=collection, ttl=ttl)
    chunk_size = max_mb * 1024 * 1024
    if chunk_size and len(data) > chunk_size:
        chunks = []
        offset = 0
        idx = 0
        while offset < len(data):
            piece = data[offset : offset + chunk_size]
            car = assign(
                master, count=1, replication=replication, collection=collection, ttl=ttl
            )
            ur = upload(
                f"{car.url}/{car.fid}",
                piece,
                filename=f"{filename}_{idx}",
                ttl=ttl,
                jwt=car.auth,
            )
            if ur.error:
                return SubmitResult(filename, ar.fid, "", 0, ur.error)
            chunks.append({"fid": car.fid, "offset": offset, "size": len(piece)})
            offset += len(piece)
            idx += 1
        manifest = json.dumps(
            {"name": filename, "mime": mime, "size": len(data), "chunks": chunks}
        ).encode()
        ur = upload(
            f"{ar.url}/{ar.fid}",
            manifest,
            filename=filename,
            ttl=ttl,
            mime="application/json",
            is_chunk_manifest=True,
            jwt=ar.auth,
        )
    else:
        ur = upload(
            f"{ar.url}/{ar.fid}", data, filename=filename, mime=mime, ttl=ttl,
            jwt=ar.auth,
        )
    if ur.error:
        return SubmitResult(filename, ar.fid, "", 0, ur.error)
    return SubmitResult(filename, ar.fid, f"{ar.public_url}/{ar.fid}", len(data))
