"""Shared HTTP server base for all daemons.

http.server.ThreadingHTTPServer defaults to a TCP accept backlog of 5
(socketserver.TCPServer.request_queue_size). Under a concurrency-16
load-generator burst (`weed benchmark -c 16`, the reference's headline
workload, command/benchmark.go:53) the backlog overflows, the kernel
drops SYNs, and clients stall in 1 s / 3 s retransmission steps — the
benchmark's p99 showed exactly those ~1 s / ~2 s spikes. The reference
never hits this because Go's net/http listens with the system's
somaxconn; a deep backlog restores that behavior.
"""

from __future__ import annotations

import json as _json
import os
import socket
import time as _time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer  # FastRequestMixin drives these through serve_connection
from urllib.parse import unquote_plus

from seaweedfs_tpu_torch import trace as _trace
from seaweedfs_tpu_torch.stats.metrics import (
    DEADLINE_REJECTED,
    HTTP_REQUEST_COUNTER,
    HTTP_REQUEST_HISTOGRAM,
)
from seaweedfs_tpu_torch.trace import blackbox as _blackbox
from seaweedfs_tpu_torch.util import deadline as _deadline


# pre-encoded header block for fast_reply's bytes-headers contract —
# the data-plane's universal reply Content-Type
JSON_HDR = b"Content-Type: application/json\r\n"


def fast_query(qs: str) -> dict:
    """parse_qs-equivalent for the data plane's flat query strings:
    first value wins, blank values dropped, percent/plus decoding only
    when present (the stdlib pays regex + list machinery per call)."""
    q = {}
    if not qs:
        return q
    for part in qs.split("&"):
        k, _, v = part.partition("=")
        if not v:
            continue
        if "%" in k or "+" in k:
            k = unquote_plus(k)
        if "%" in v or "+" in v:
            v = unquote_plus(v)
        if k not in q:
            q[k] = v
    return q


class FastHeaders(dict):
    """Minimal case-insensitive header map (keys stored lowercased).

    Supports the `.get(name)` / `in` / `[name]` access the data-plane
    handlers use; deliberately NOT an email.message.Message (no MIME
    machinery — that parser is where the stdlib handler stack burns
    ~40% of a small-request's CPU)."""

    def get(self, key, default=None):
        # exact-hit first: hot call sites already pass lowercase names,
        # and str.lower() allocates on every miss-free access
        v = dict.get(self, key)
        if v is not None:
            return v
        return dict.get(self, key.lower(), default)

    def __getitem__(self, key):
        try:
            return dict.__getitem__(self, key)
        except KeyError:
            return dict.__getitem__(self, key.lower())

    def __contains__(self, key):
        return dict.__contains__(self, key) or dict.__contains__(
            self, key.lower()
        )


def encode_headers(headers: dict) -> bytearray:
    """Encode a header dict as the b"Name: value\\r\\n"... block, with
    request-derived CR/LF stripped so a hostile value can never split a
    response. The ONE header formatter: fast_reply uses it, and the
    zero-copy GET resolvers (server.fast_resolver, docs/SERVING.md)
    build their pre-formatted response prefixes through it — which is
    what makes C-path and Python-path responses byte-identical by
    construction, not by parallel maintenance."""
    buf = bytearray()
    for k, v in headers.items():
        line = f"{k}: {v}"
        if "\r" in line or "\n" in line:
            line = line.replace("\r", "").replace("\n", "")
        buf += line.encode("latin-1", "replace") + b"\r\n"
    return buf


def reply_prefix(status: int, headers: dict | None = None) -> bytes:
    """Status line + headers for a response the EVENT LOOP will finish:
    the C serving core appends the same `Connection: close` /
    `Content-Length` tail fast_reply writes, so a resolver that builds
    its prefix here yields responses byte-identical to the threaded
    path serving the same request."""
    buf = bytearray(b"HTTP/1.1 %d %s\r\n" % (status, _REASON.get(status, b"OK")))
    if headers:
        buf += encode_headers(headers)
    return bytes(buf)


def etag_matches(header_value, etag: str) -> bool:
    """RFC 9110 §13.1.2 If-None-Match evaluation: `*` matches any
    current representation, otherwise the value is a comma-separated
    list of entity-tags compared WEAKLY (a `W/` prefix on either side
    is ignored). The scanner is quote-aware — the etagc grammar allows
    commas inside a quoted tag, so a naive split would mis-tokenize.
    Malformed members (unterminated quote, bare token) never match.

    The C serving core (native/serve.c weed_etag_match) implements
    this exact scanner over the same bytes; keep the two in lockstep —
    the C-vs-Python identity matrix in tests/ diffs them."""
    if not header_value:
        return False
    v = header_value.strip()
    if v == "*":
        return True
    target = etag[2:] if etag.startswith("W/") else etag
    i, n = 0, len(v)
    while i < n:
        while i < n and v[i] in " \t,":
            i += 1
        if i >= n:
            break
        if v.startswith("W/", i):
            i += 2
        if i < n and v[i] == '"':
            j = v.find('"', i + 1)
            if j < 0:
                return False
            if v[i : j + 1] == target:
                return True
            i = j + 1
        else:
            j = v.find(",", i)
            if j < 0:
                return False
            i = j + 1
    return False


class FastRequestMixin:
    """Marks a handler as data-plane: WeedHTTPServer drives it through
    the mini request loop (serve_connection) instead of the stdlib
    socketserver/handler-per-request machinery, and fast_reply
    writes whole responses (status+headers+body) in ONE buffer/syscall
    — under `weed benchmark` the stdlib's email.feedparser header
    parsing plus send_header-per-line writing cost more than the
    needle append being measured. Head parsing (one-buffer scan,
    FastHeaders, keep-alive/Expect/431 semantics) lives in
    serve_connection — ONE parser, not two that drift."""

    def fast_reply(self, status: int, body: bytes = b"", headers=None) -> None:
        """status + headers + Content-Length + body in ONE write.

        `headers` may be a dict or pre-encoded header bytes
        (b"Name: value\\r\\n"...) — hot handlers pass module-level
        constants so nothing is formatted per request."""
        self._trace_status = status
        buf = bytearray(b"HTTP/1.1 %d %s\r\n" % (status, _REASON.get(status, b"OK")))
        if headers:
            if isinstance(headers, (bytes, bytearray)):
                buf += headers
            else:
                buf += encode_headers(headers)
        if self.close_connection:
            buf += b"Connection: close\r\n"
        buf += b"Content-Length: %d\r\n\r\n" % len(body)
        if body and self.command != "HEAD":
            if len(body) >= 65536:
                # big bodies skip the header+body concat copy: one
                # gathering sendmsg (same bytes on the wire) — the
                # threaded twin of the C loop's writev first flush
                wv = getattr(self.wfile, "writev", None)
                if wv is not None:
                    wv((bytes(buf), body))
                    self._note_sent(len(buf) + len(body))
                    return
            buf += body
        self.wfile.write(buf)
        self._note_sent(len(buf))

    def _note_sent(self, n: int) -> None:
        # wire-byte accounting for the flight recorder: the C fast path
        # reports bytes actually sent, so the threaded arm's wide-event
        # matches (only when the handler didn't already stamp a size —
        # the write path records the uploaded needle size instead)
        sp = getattr(self, "_trace_span", None)
        if sp is not None and not sp.nbytes:
            sp.nbytes = n

    # the stdlib slow paths (filer/master streaming replies) pass
    # through here — recording the code keeps span status and the
    # request-counter status label accurate on every reply shape
    def send_response(self, code, message=None):
        self._trace_status = code
        super().send_response(code, message)


_REASON = {
    200: b"OK",
    201: b"Created",
    202: b"Accepted",
    204: b"No Content",
    206: b"Partial Content",
    207: b"Multi-Status",
    301: b"Moved Permanently",
    302: b"Found",
    304: b"Not Modified",
    400: b"Bad Request",
    401: b"Unauthorized",
    403: b"Forbidden",
    404: b"Not Found",
    405: b"Method Not Allowed",
    409: b"Conflict",
    411: b"Length Required",
    413: b"Payload Too Large",
    416: b"Range Not Satisfiable",
    429: b"Too Many Requests",
    431: b"Request Header Fields Too Large",
    500: b"Internal Server Error",
    501: b"Not Implemented",
    502: b"Bad Gateway",
    503: b"Service Unavailable",
    504: b"Gateway Timeout",
}


class FastHandler(FastRequestMixin, BaseHTTPRequestHandler):
    """The one handler base every serving path derives from: marked
    with FastRequestMixin so WeedHTTPServer drives it through the mini
    request loop (serve_connection), with the quiet log and HTTP/1.1
    keep-alive every daemon wants. Subclasses just define do_*."""

    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # the data plane logs via wlog
        pass


class _BufReader:
    """Minimal buffered reader over a socket for the mini request loop:
    one recv fills a buffer; the request head is scanned out of it in
    one pass, bodies and chunk lines drain it before hitting the
    socket again. Tracks total consumed bytes so the connection loop
    can realign (or bail) when a handler leaves body bytes unread.

    `deadline` (client-side pooled transport only): when set, every
    refill re-arms the socket timeout to min(op_timeout, remaining
    budget) and an exhausted budget raises DeadlineExceeded — this is
    what turns the per-socket-op timeout into a true whole-request
    bound (a server trickling one byte per timeout window used to
    reset the clock on every recv)."""

    __slots__ = ("_sock", "_buf", "_pos", "consumed", "deadline", "op_timeout")

    def __init__(self, sock, initial: bytes = b""):
        # `initial`: bytes already read off the socket by whoever owned
        # the connection before (the C epoll loop hands a connection
        # off WITH the unconsumed tail of its read buffer)
        self._sock = sock
        self._buf = initial
        self._pos = 0
        self.consumed = 0
        self.deadline = None
        self.op_timeout = None

    def _fill(self) -> bool:
        dl = self.deadline
        if dl is not None:
            # raises DeadlineExceeded once the whole-request budget is
            # spent; otherwise shrinks this recv's window to what's left
            self._sock.settimeout(dl.cap(self.op_timeout))
        chunk = self._sock.recv(65536)
        if not chunk:
            return False
        if self._pos:
            self._buf = self._buf[self._pos :] + chunk
            self._pos = 0
        else:
            self._buf += chunk
        return True

    def read_head(self, limit: int = 131072) -> bytes | None:
        """Bytes up to and including the blank line; None on clean EOF
        before any byte; raises ValueError past `limit` (431)."""
        while True:
            idx = self._buf.find(b"\r\n\r\n", self._pos)
            if idx >= 0:
                head = self._buf[self._pos : idx + 4]
                # the limit applies to COMPLETE heads too: when the
                # whole oversized head coalesces into the buffer before
                # the first parse attempt (one big recv, or a C-loop
                # handoff's initial bytes), find() succeeds and the
                # incomplete-head check below never runs — the request
                # would serve as 200 instead of 431 (timing-dependent:
                # caught by the oversized-head test flaking under load)
                if len(head) > limit:
                    raise ValueError("request head too large")
                self._pos = idx + 4
                self.consumed += len(head)
                return head
            if len(self._buf) - self._pos > limit:
                raise ValueError("request head too large")
            if not self._fill():
                return None if len(self._buf) == self._pos else b""

    def read(self, n: int | None = None) -> bytes:
        if n is None:  # EOF-delimited (HTTP/1.0-style bodies)
            while self._fill():
                pass
            out = self._buf[self._pos :]
            self._pos = len(self._buf)
            self.consumed += len(out)
            return out
        avail = len(self._buf) - self._pos
        if avail < n:
            return self._gather(n, avail)
        out = self._buf[self._pos : self._pos + n]
        self._pos += n
        self.consumed += n
        return out

    def _gather(self, n: int, avail: int) -> bytes:
        """read(n) past the buffered bytes: those, then recv_into one
        preallocated buffer until n bytes or EOF. (Growing the read
        buffer a recv at a time would copy it again on every recv,
        quadratic in the body's size.)"""
        out = bytearray(n)
        view = memoryview(out)
        view[:avail] = memoryview(self._buf)[self._pos :]
        self._buf, self._pos = b"", 0
        got = avail
        dl = self.deadline
        while got < n:
            if dl is not None:
                self._sock.settimeout(dl.cap(self.op_timeout))
            k = self._sock.recv_into(view[got:], n - got)
            if not k:
                break
            got += k
        view.release()
        self.consumed += got
        return bytes(out) if got == n else bytes(out[:got])

    def readline(self, limit: int = 65537) -> bytes:
        while True:
            idx = self._buf.find(b"\n", self._pos)
            if idx >= 0 and idx - self._pos < limit:
                out = self._buf[self._pos : idx + 1]
                self._pos = idx + 1
                self.consumed += len(out)
                return out
            if idx < 0 and len(self._buf) - self._pos >= limit:
                out = self._buf[self._pos : self._pos + limit]
                self._pos += limit
                self.consumed += limit
                return out
            if not self._fill():
                out = self._buf[self._pos :]
                self._pos = len(self._buf)
                self.consumed += len(out)
                return out


class _SockWriter:
    """wfile facade: sendall semantics (a raw SocketIO.write may short-
    write large bodies), no buffering to flush.

    With `-serveIdleMs` arming a socket timeout, a plain sendall would
    turn the IDLE timeout into a total-transfer deadline (CPython
    computes ONE deadline for the whole call) and truncate big
    downloads to slow-but-draining clients. A per-chunk send() is not
    enough either: with a timeout set, CPython polls for POLLOUT before
    every send, and TCP reports *writable* only once the send queue has
    drained to two thirds of its buffer, so a client sipping a
    multi-MB kernel buffer can leave the socket unwritable for whole
    idle windows while bytes still move. So a window that ends without
    POLLOUT is followed by a drain probe: one send that bypasses the
    poll and takes whatever room the queue has now (the socket is
    non-blocking underneath its timeout). Moved bytes mean a live
    client, and the bound starts again; a second window without
    progress is a true stall and raises. These are the semantics of the
    C loop's idle-reaper drain probe (serve.c weed_conn_flush_step)."""

    __slots__ = ("_sock",)

    _CHUNK = 1 << 18

    def __init__(self, sock):
        self._sock = sock

    def _probe(self, view) -> int:
        """Send what fits in the send queue right now, without waiting."""
        try:
            return os.write(self._sock.fileno(), view)
        except BlockingIOError:
            return 0

    def write(self, data) -> int:
        n = len(data)
        view = memoryview(data)
        pos = 0
        stalled = False
        while pos < n:
            try:
                sent = self._sock.send(view[pos : pos + self._CHUNK])
            except TimeoutError:
                # no POLLOUT for a whole idle window: probe the queue
                sent = self._probe(view[pos:])
                if sent <= 0:
                    if stalled:
                        raise
                    stalled = True
                    continue
            if sent > 0:
                pos += sent
                stalled = False
        return n

    def writev(self, bufs) -> int:
        """Gathering write: header + body land in ONE sendmsg syscall
        (the threaded path's twin of the C loop's writev reply).
        Whatever the kernel didn't take drains through the chunked
        write() loop above, preserving its stall semantics."""
        total = 0
        for b in bufs:
            total += len(b)
        try:
            sent = self._sock.sendmsg(bufs)
        except TimeoutError:
            sent = 0
        if sent >= total:
            return total
        for b in bufs:
            blen = len(b)
            if sent >= blen:
                sent -= blen
                continue
            self.write(memoryview(b)[sent:] if sent else b)
            sent = 0
        return total

    def flush(self) -> None:
        pass


def _deadline_scoped(method, dl):
    """Dispatch wrapper installing `dl` as the ambient deadline for
    exactly this request's handler, so internal hops (http_call, gRPC
    stubs, hedged reads) inherit the remaining budget for free."""

    def run(h, _m=method, _dl=dl):
        _deadline.set_current(_dl)
        try:
            return _m(h)
        finally:
            _deadline.set_current(None)

    return run


def _expired_reject(h) -> None:
    """Stand-in handler for a request whose X-Weed-Deadline arrived
    already expired: 504 without touching disk or fanning out. Dispatch
    runs it like any handler, so the span (annotated, no work stages)
    and the 504-labelled request counter are the rejection's audit
    trail."""
    sp = getattr(h, "_trace_span", None)
    if sp is not None:
        sp.annotate("deadline", "expired-at-entry")
    DEADLINE_REJECTED.labels(
        getattr(h.server, "trace_name", "") or "server"
    ).inc()
    # an expired request's body may never arrive in full (the client
    # has given up); never trust this connection for another request
    h.close_connection = True
    h.fast_reply(
        504, b'{"error": "x-weed-deadline expired before dispatch"}', JSON_HDR
    )


_DISPATCH_CACHE: dict[type, dict] = {}


def _dispatch_table(handler_cls: type) -> dict:
    table = _DISPATCH_CACHE.get(handler_cls)
    if table is None:
        table = {
            name[3:]: getattr(handler_cls, name)
            for name in dir(handler_cls)
            if name.startswith("do_")
        }
        _DISPATCH_CACHE[handler_cls] = table
    return table


def serve_connection(
    sock, addr, server, handler_cls, initial: bytes = b"", initial_reqs: int = 0
) -> None:
    """The mini per-connection request loop: replaces the
    socketserver → handle → handle_one_request → parse_request stack
    on every serving path. One handler object per connection (no
    per-request construction), the whole request head read and parsed
    out of one buffer (no per-header readline), dict dispatch instead
    of getattr-per-request. The handler classes are unchanged — this
    drives the same do_GET/do_POST/... methods with the same surface
    (path/command/headers/rfile/wfile/client_address/close_connection,
    fast_reply, and the inherited stdlib send_response/send_header/
    end_headers/send_error for the slow paths).

    `initial` seeds the read buffer with bytes a previous owner of the
    connection already consumed off the wire — the C epoll loop
    (docs/SERVING.md) hands non-fast-path connections off here with
    the current request head onward."""
    h = handler_cls.__new__(handler_cls)  # skip the stdlib per-request __init__
    h.server = server
    h.client_address = addr
    h.connection = sock
    reader = _BufReader(sock, initial)
    h.rfile = reader
    h.wfile = _SockWriter(sock)
    table = _dispatch_table(handler_cls)
    proto11 = handler_cls.protocol_version >= "HTTP/1.1"
    # keep-alive housekeeping knobs (`-serveIdleMs` / `-serveMaxReqs`),
    # honored identically by this loop and the C epoll loop: a socket
    # timeout bounds idle keep-alive connections (the except arm below
    # already treats TimeoutError as end-of-connection), and max_reqs
    # closes after N responses (Connection: close on the Nth)
    idle_ms = getattr(server, "serve_idle_ms", 0)
    if idle_ms and idle_ms > 0:
        try:
            sock.settimeout(idle_ms / 1000.0)
        except OSError:
            return
    max_reqs = getattr(server, "serve_max_reqs", 0) or 0
    nreqs = initial_reqs  # responses a prior owner (the C loop) served
    # tracing/metrics identity is per-server, not per-request: resolve
    # it once per connection, and hoist every module/attribute the
    # traced dispatch touches into locals — the per-request cost of
    # tracing is dominated by cold cache lines (distinct shared
    # objects touched), so the loop below reads only its own warm
    # frame (docs/TRACING.md)
    trace_label = getattr(server, "trace_name", "")
    trace_node = getattr(server, "trace_node", "")
    gateway_metrics = getattr(server, "gateway_metrics", False)
    debug_gate = getattr(server, "debug_gate", None)
    # QoS plane (docs/QOS.md): this dispatch funnel is the ONE place
    # every daemon's requests pass through (including C-epoll-loop
    # handoffs), so the in-flight load signal and per-client admission
    # control live here. Both default to None — the common path pays
    # one is-None check per request.
    admission = getattr(server, "admission", None)
    load_tracker = getattr(server, "load_tracker", None)
    # deadline plane (docs/CHAOS.md): this same funnel parses the
    # X-Weed-Deadline hop header on every daemon, fast-rejects expired
    # requests with 504 BEFORE dispatch, and installs the budget as
    # the ambient deadline so every internal hop the handler makes
    # inherits it. deadline_default_s set on the server wins; None
    # falls back to the WEED_DEADLINE_DEFAULT_S gateway-entry default.
    ddl_enabled = _deadline.enabled()
    ddl_default = getattr(server, "deadline_default_s", None)
    if ddl_default is None:
        ddl_default = _deadline.default_budget_s()
    ddl_hdr_key = _deadline.DEADLINE_HEADER
    if admission is not None or load_tracker is not None:
        def qos_dispatch(method, h, _adm=admission, _lt=load_tracker):
            if _lt is not None:
                _lt.enter()
            try:
                if _adm is not None:
                    return _adm.gate(method, h)
                return method(h)
            finally:
                if _lt is not None:
                    _lt.exit()
    else:
        qos_dispatch = None
    trace_enabled = _trace.enabled
    span_open, span_close, sample_hit = _trace.connection_tracer(trace_node)
    trace_hdr_key = _trace.TRACE_HEADER
    clock = _time.perf_counter
    hist_observe = HTTP_REQUEST_HISTOGRAM.observe
    put_exemplar = HTTP_REQUEST_HISTOGRAM.put_exemplar
    counter_labels = HTTP_REQUEST_COUNTER.labels
    # weedscope flight recorder (trace/blackbox.py): one wide-event per
    # completed request on BOTH dispatch arms; the closure holds every
    # object the record path touches (WEED_SCOPE=0 → one global check)
    bb_record = _blackbox.recorder(trace_label, trace_node)
    bb_flags = _blackbox.request_flags
    peer = addr[0] if isinstance(addr, tuple) else str(addr)
    span_names: dict[str, str] = {}  # method -> span name, per-conn
    try:
        while True:
            # error replies (fast_reply) read command/close_connection;
            # arm them before any read/parse step can bail (and clear a
            # previous keep-alive request's values)
            h.command = None
            h.close_connection = True
            h._trace_status = 0
            try:
                head = reader.read_head()
            except ValueError:
                h.fast_reply(431)
                return
            if not head:
                return
            lines = head[:-4].decode("iso-8859-1").split("\r\n")
            requestline = lines[0]
            words = requestline.split()
            h.requestline = requestline
            if len(words) == 3:
                command, path, version = words
                if not version.startswith("HTTP/"):
                    _bad_request(h, f"Bad request version ({version!r})")
                    return
            elif len(words) == 2 and words[0] == "GET":
                command, path = words
                version = "HTTP/0.9"
            else:
                _bad_request(h, f"Bad request syntax ({requestline!r})")
                return
            h.command = command
            h.path = path
            h.request_version = version
            close = version <= "HTTP/1.0"

            headers = FastHeaders()
            for line in lines[1:]:
                key, sep, value = line.partition(":")
                if sep:
                    headers[key.strip().lower()] = value.strip()
            h.headers = headers

            conn = headers.get("connection", "").lower()
            if conn == "close":
                close = True
            elif conn == "keep-alive":
                close = False
            h.close_connection = close
            nreqs += 1
            if max_reqs and nreqs >= max_reqs:
                # the Nth response carries Connection: close; set it
                # BEFORE dispatch so fast_reply writes the header
                h.close_connection = True

            method = table.get(command)
            if method is None:
                h.close_connection = True
                h.fast_reply(405)
                return

            # body accounting: a handler that returns without draining
            # its request body would desync the next request on this
            # connection — skip small remainders, close otherwise
            try:
                length = int(headers.get("content-length", 0) or 0)
            except ValueError:
                _bad_request(h, "Bad Content-Length")
                return
            chunked = "chunked" in headers.get("transfer-encoding", "").lower()
            body_end = reader.consumed + length

            # deadline plane: an already-expired budget is rejected
            # HERE — before the 100-continue invite, before admission
            # spends a token, before the handler touches disk. The
            # reject rides the normal dispatch seam so the span and
            # status-labelled request counter record the 504 — but it
            # BYPASSES the admission gate below (an expired request
            # must never drain a client's token bucket, and a dry
            # bucket's 503 + Retry-After would invite the client to
            # retry work it already abandoned).
            h._deadline = None
            if ddl_enabled:
                dhv = headers.get(ddl_hdr_key)
                dl = _deadline.from_header(dhv) if dhv is not None else None
                if dl is None and ddl_default > 0:
                    dl = _deadline.Deadline.after(ddl_default)
                if dl is not None:
                    h._deadline = dl
                    if dl.expired:
                        method = _expired_reject
                    else:
                        method = _deadline_scoped(method, dl)

            # 100 Continue goes out only AFTER the request validates:
            # a bad Content-Length (400 above), an unknown method
            # (405), or an oversized head (431, in read_head) must
            # reject the request outright — an interim 100 first would
            # invite the client to stream a body this connection is
            # about to slam the door on (and on a reused keep-alive
            # connection would desync the error reply that follows)
            if (
                proto11
                and version >= "HTTP/1.1"
                and headers.get("expect", "").lower() == "100-continue"
            ):
                sock.sendall(b"HTTP/1.1 100 Continue\r\n\r\n")

            # tracing plane (docs/TRACING.md): the mini loop is the ONE
            # place every serving daemon's dispatch funnels through, so
            # span minting/inheritance, the /debug/* operator surface,
            # and the per-request metrics live here — volume, master,
            # filer, workers, S3, and WebDAV all get them at once.
            bare = path.partition("?")[0]
            if (
                command == "GET"
                and (
                    bare in (
                        "/debug/traces",
                        "/debug/requests",
                        "/debug/profile",
                        "/debug/blackbox",
                    )
                    or bare.startswith("/capsule/")
                    or (bare == "/metrics" and gateway_metrics)
                )
                # an auth-fronted gateway vetoes the interception
                # (debug_gate False → the request falls through to the
                # handler's own authenticated routing)
                and (debug_gate is None or debug_gate(h))
            ):
                _serve_debug(h, bare)
            elif trace_enabled() and (
                (hdr := headers.get(trace_hdr_key)) is not None
                or sample_hit()
            ):
                t0 = clock()
                name = span_names.get(command)
                if name is None:
                    name = span_names.setdefault(
                        command, f"{trace_label or 'http'}.{command.lower()}"
                    )
                sp = span_open(name, hdr, length, t0)
                h._trace_span = sp if sp else None
                try:
                    if qos_dispatch is None or method is _expired_reject:
                        method(h)
                    else:
                        qos_dispatch(method, h)
                finally:
                    if sp:  # falsy when the tracer flipped off mid-open
                        span_close(sp, h._trace_status)
                # a real span's duration IS the dispatch latency —
                # reuse it instead of a second clock pair
                dur = sp.duration if sp else clock() - t0
                if trace_label:
                    hist_observe(dur, trace_label, command)
                    counter_labels(
                        trace_label, command, str(h._trace_status)
                    ).inc()
                    if sp:
                        # bucket exemplar: this trace id is the one an
                        # operator can paste into /debug/traces
                        put_exemplar(dur, sp.trace_id, trace_label, command)
                bb_record(
                    command,
                    sp.trace_id if sp else "",
                    sp.plane if sp else "serve",
                    h._trace_status,
                    dur,
                    sp.nbytes if sp else 0,
                    peer,
                    bb_flags(headers, h._trace_status),
                    sp.stages if sp else None,
                )
            else:
                h._trace_span = None
                t0 = clock()
                if qos_dispatch is None or method is _expired_reject:
                    method(h)
                else:
                    qos_dispatch(method, h)
                dur = clock() - t0
                if trace_label:
                    hist_observe(dur, trace_label, command)
                    counter_labels(
                        trace_label, command, str(h._trace_status)
                    ).inc()
                bb_record(
                    command,
                    "",
                    "serve",
                    h._trace_status,
                    dur,
                    0,
                    peer,
                    bb_flags(headers, h._trace_status),
                    None,
                )

            # health plane (docs/HEALTH.md): 5xx responses feed the
            # heartbeat request_errors counter the master's per-node
            # error EWMA scores — a reachable-but-failing node goes
            # suspect without anyone staring at logs. 503 (admission /
            # lame-duck shed) and 504 (expired client deadline) are
            # CLIENT-attributable by design and excluded: one client
            # over its token bucket or stamping stale budgets must not
            # be able to drive a healthy node suspect cluster-wide.
            if (
                load_tracker is not None
                and h._trace_status >= 500
                and h._trace_status not in (503, 504)
            ):
                load_tracker.note_error()

            if chunked:
                # can't know from here whether the terminal chunk was
                # consumed; never reuse the connection
                return
            if reader.consumed < body_end:
                if body_end - reader.consumed <= 1 << 20:
                    reader.read(body_end - reader.consumed)
                else:
                    return
            if h.close_connection:
                return
    except (ConnectionError, BrokenPipeError, TimeoutError, OSError):
        pass


def _serve_debug(h, bare: str) -> None:
    """The tracing plane's operator endpoints, served uniformly on
    every daemon by the mini loop itself (no per-server routing to
    drift): `/debug/traces` (recent + slowest-N completed spans,
    ?n= caps the recent list), `/debug/requests` (in-flight dump),
    `/debug/blackbox` (the weedscope flight recorder's tail + sampled-OK
    rings), the `/capsule/*` incident-capsule surface, and — on servers
    that opt in via `server.gateway_metrics` (the S3 and WebDAV
    gateways, whose handlers have no routing slot for it) — `/metrics`
    Prometheus text exposition."""
    if bare == "/metrics":
        from seaweedfs_tpu_torch.stats.metrics import DEFAULT_REGISTRY

        return h.fast_reply(
            200,
            DEFAULT_REGISTRY.render_text().encode(),
            {"Content-Type": "text/plain; version=0.0.4"},
        )
    if bare == "/debug/profile":
        # continuous sampling profiler (telemetry/profiler.py):
        # ?seconds=S captures the NEXT S seconds (capped; parks only
        # this operator connection's thread), ?fmt=folded emits
        # flamegraph.pl input instead of JSON
        from seaweedfs_tpu_torch.telemetry import profiler

        q = fast_query(h.path.partition("?")[2])
        try:
            seconds = float(q.get("seconds", "1"))
        except ValueError:
            seconds = 1.0
        payload = profiler.capture(max(0.0, min(seconds, 30.0)))
        payload["node"] = getattr(h.server, "trace_node", "") or payload.get(
            "node", ""
        )
        if q.get("fmt") == "folded":
            return h.fast_reply(
                200,
                profiler.render_folded(payload).encode(),
                {"Content-Type": "text/plain; charset=utf-8"},
            )
        return h.fast_reply(200, _json.dumps(payload).encode(), JSON_HDR)
    if bare == "/debug/blackbox":
        q = fast_query(h.path.partition("?")[2])
        try:
            n = int(q.get("n", "256"))
        except ValueError:
            n = 256
        return h.fast_reply(
            200, _json.dumps(_blackbox.snapshot(n)).encode(), JSON_HDR
        )
    if bare.startswith("/capsule/"):
        return _serve_capsule(h, bare)
    if bare == "/debug/requests":
        payload = _trace.inflight_payload()
    else:
        q = fast_query(h.path.partition("?")[2])
        try:
            n = int(q.get("n", "64"))
        except ValueError:
            n = 64
        payload = _trace.debug_payload(n)
    h.fast_reply(200, _json.dumps(payload).encode(), JSON_HDR)


def _serve_capsule(h, bare: str) -> None:
    """Per-node incident-capsule surface (telemetry/capsule.py), served
    by every daemon: `/capsule/capture?reason=R` snapshots the node's
    evidence NOW (the leader's CaptureCoordinator dials this on every
    implicated peer when an alert fires), `/capsule/list` returns the
    valid manifests, `/capsule/get?id=I&file=F` streams one capsule
    file for leader-side `capsule.collect` merging. Under the C serving
    loop every `/capsule/*` request is handed off to a thread, so a
    capture never runs on the loop's own thread."""
    from seaweedfs_tpu_torch.telemetry import capsule

    q = fast_query(h.path.partition("?")[2])
    if bare == "/capsule/capture":
        trigger = q.get("trigger", "manual")
        if trigger not in ("manual", "alert"):  # bound the label set
            trigger = "manual"
        manifest = capsule.capture(
            q.get("reason", "http"),
            trigger=trigger,
            node=getattr(h.server, "trace_node", ""),
        )
        return h.fast_reply(200, _json.dumps(manifest).encode(), JSON_HDR)
    if bare == "/capsule/list":
        return h.fast_reply(
            200,
            _json.dumps({"Capsules": capsule.list_capsules()}).encode(),
            JSON_HDR,
        )
    if bare == "/capsule/get":
        data = capsule.read_file(q.get("id", ""), q.get("file", ""))
        if data is None:
            return h.fast_reply(
                404, b'{"error": "no such capsule file"}', JSON_HDR
            )
        return h.fast_reply(
            200, data, {"Content-Type": "application/octet-stream"}
        )
    return h.fast_reply(404, b'{"error": "unknown capsule route"}', JSON_HDR)


def _bad_request(h, msg: str) -> None:
    h.close_connection = True
    h.request_version = "HTTP/1.1"
    h.fast_reply(400, msg.encode("latin-1", "replace"))


class WeedHTTPServer(ThreadingHTTPServer):
    # deep accept backlog: under a connection burst (256+ concurrent
    # weedload workers) a shallow backlog drops SYNs into 1s/3s
    # retransmission steps; the epoll loop drains it every listen event
    request_queue_size = 1024

    # keep-alive housekeeping knobs (`-serveIdleMs`/`-serveMaxReqs`),
    # enforced by BOTH serving paths (C epoll loop + threaded mini
    # loop); 0 = disabled
    serve_idle_ms = 0
    serve_max_reqs = 0

    # zero-copy GET fast path (docs/SERVING.md): the owning daemon may
    # install `fast_resolver(path, range, head_only) -> plan | None`
    # before serve_forever; None means every request takes the handoff
    # path into the threaded mini loop
    fast_resolver = None

    # QoS plane (docs/QOS.md): the owning daemon may install a
    # qos.admission.AdmissionController (per-client shed with 503 +
    # Retry-After) and/or a qos.LoadTracker (in-flight count for the
    # heartbeat load signal); None = today's behavior
    admission = None
    load_tracker = None

    # deadline plane (docs/CHAOS.md): budget (seconds) minted at entry
    # for requests arriving WITHOUT an X-Weed-Deadline header; None
    # defers to the WEED_DEADLINE_DEFAULT_S env knob, 0 mints nothing
    deadline_default_s = None

    def get_request(self):
        # TCP_NODELAY: keep-alive responses are written headers-then-
        # body; with Nagle on, the body segment waits for the client's
        # delayed ACK (~40 ms) — the whole data plane flatlines at the
        # delayed-ACK timer instead of wire speed
        sock, addr = super().get_request()
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, True)
        return sock, addr

    def serve_forever(self, poll_interval=0.5):
        # event-driven serving core: unless a switch selects the
        # threaded arm, the C epoll loop owns the accept/read/dispatch
        # edge — fast-path GETs never leave C, everything else hands
        # off into serve_connection threads. The threaded socketserver
        # path below is the byte-identical arm the switches select
        # (WEED_NATIVE_SERVE=0, or this server's native_serve False).
        from seaweedfs_tpu_torch.util import native_serve

        if native_serve.try_serve_forever(self):
            return
        super().serve_forever(poll_interval)

    def wait_armed(self, timeout: float = 30.0) -> None:
        """Block until a serve_forever running on another thread has
        chosen its loop; raise RuntimeError if the C loop could not arm
        (its extension failed to build, or its setup failed). A daemon's
        start() calls this, so it never returns a server that answers
        nothing."""
        from seaweedfs_tpu_torch.util import native_serve

        if not (native_serve.available() and getattr(self, "native_serve", True)):
            return  # the threaded arm: socketserver is ready on entry
        deadline = _time.monotonic() + timeout
        while getattr(self, "_serve_native", None) is None:
            if _time.monotonic() > deadline:
                raise RuntimeError(f"the serve loop did not arm within {timeout} s")
            _time.sleep(0.001)
        err = getattr(self, "_serve_error", None)
        if err is not None:
            raise RuntimeError(f"the C serving loop could not arm: {err}") from err

    def shutdown(self):
        from seaweedfs_tpu_torch.util import native_serve

        if native_serve.shutdown(self):
            return
        if native_serve.available() and getattr(self, "native_serve", True):
            # start/stop race: the serve thread WILL choose the native
            # loop — the predicate is deterministic — but may not have
            # armed _serve_native yet. Falling through to
            # socketserver.shutdown() here waits forever on an
            # __is_shut_down event the stdlib loop (which never runs)
            # will never set. Wait for the arming instead; a False
            # marker means the loop failed to arm, and nothing runs.
            deadline = _time.monotonic() + 5.0
            while _time.monotonic() < deadline:
                state = getattr(self, "_serve_native", None)
                if state is not None and native_serve.shutdown(self):
                    return
                _time.sleep(0.001)
        super().shutdown()

    def finish_request(self, request, client_address):
        # every in-repo serving path carries FastRequestMixin and rides
        # the mini request loop (volume, master, workers, filer, s3,
        # webdav); the hasattr gate only guards external/test handlers
        if hasattr(self.RequestHandlerClass, "fast_reply"):
            serve_connection(
                request, client_address, self, self.RequestHandlerClass
            )
        else:
            super().finish_request(request, client_address)


class ReusePortWeedHTTPServer(WeedHTTPServer):
    """SO_REUSEPORT listener for processes sharing one host:port
    (`volume -workers N`, gateway `-serveProcs N`); every binder of the
    port must set the option, so lead and workers use this same class.

    server_bind sets the option explicitly: socketserver only learned
    `allow_reuse_port` in Python 3.11, so relying on the class attr
    silently binds WITHOUT it on 3.10 — the second process then dies
    with EADDRINUSE instead of sharing the accept load."""

    allow_reuse_port = True  # honored natively on 3.11+

    def server_bind(self):
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()
