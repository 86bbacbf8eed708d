"""The port's S3 and WebDAV gateways under the mini request loop's
adversarial input matrix, beside seaweedfs_tpu's:
tests/test_gateway_miniloop.py (TestS3MiniLoop and TestWebDavMiniLoop)
ported. Malformed request lines, bad Content-Length, oversized heads
(431), unknown methods (405), split reads, pipelining, keep-alive
semantics, DAV verb dispatch and unread-body realignment.

Each case sends the same bytes to a gateway of each package; both point
at a dead filer port, so every case fails in the parser or in a branch
that rules before any filer access (the S3 bucket-name check, WebDAV's
OPTIONS and PROPPATCH). The replies (status and body) are equal, and
each meets the reference's expectation.
"""

from __future__ import annotations

import importlib
import socket
import time

import pytest

from seaweedfs_tpu_torch.util.availability import free_port

SIDES = ("ref", "port")
PKG = {"ref": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}


@pytest.fixture(scope="module")
def gateways():
    out = {}
    try:
        for side in SIDES:
            cls = importlib.import_module(f"{PKG[side]}.s3api.s3api_server").S3ApiServer
            out[side] = cls(filer=f"127.0.0.1:{free_port()}", port=free_port())
            out[side].start()
        yield out
    finally:
        for srv in out.values():
            srv.stop()


@pytest.fixture(scope="module")
def davs():
    out = {}
    try:
        for side in SIDES:
            cls = importlib.import_module(f"{PKG[side]}.webdav.webdav_server").WebDavServer
            out[side] = cls(filer=f"127.0.0.1:{free_port()}", port=free_port())
            out[side].start()
        yield out
    finally:
        for srv in out.values():
            srv.stop()


def _connect(port: int):
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, True)
    return s


_leftover: dict[socket.socket, bytes] = {}


def _read_response(s) -> tuple[int, bytes]:
    """(status, body) for one Content-Length-framed response, carrying
    per-socket leftovers so pipelined responses coalesced into one
    segment do not starve the next read."""
    buf = _leftover.pop(s, b"")
    while b"\r\n\r\n" not in buf:
        chunk = s.recv(65536)
        if not chunk:
            return 0, b""
        buf += chunk
    head, _, rest = buf.partition(b"\r\n\r\n")
    status = int(head.split(None, 2)[1])
    length = 0
    for line in head.split(b"\r\n")[1:]:
        k, _, v = line.partition(b":")
        if k.strip().lower() == b"content-length":
            length = int(v.strip())
    while len(rest) < length:
        chunk = s.recv(65536)
        if not chunk:
            break
        rest += chunk
    if rest[length:]:
        _leftover[s] = rest[length:]
    return status, rest[:length]


def _each(gateways, script):
    """script(port) on each package's gateway; the results are equal."""
    got = {side: script(gateways[side].port) for side in SIDES}
    assert got["port"] == got["ref"]
    return got["port"]


# fails before any filer access: PUT on a too-short bucket name -> 400
# InvalidBucketName XML
S3_OK = b"PUT /x HTTP/1.1\r\nHost: s3\r\nContent-Length: 0\r\n\r\n"


def _one(payload: bytes):
    def script(port):
        s = _connect(port)
        s.sendall(payload)
        out = _read_response(s)
        s.close()
        return out
    return script


class TestS3MiniLoop:
    def test_parse_level_reply(self, gateways):
        status, body = _each(gateways, _one(S3_OK))
        assert status == 400 and b"InvalidBucketName" in body

    def test_garbage_request_line_400(self, gateways):
        assert _each(gateways, _one(b"NOT A REQUEST\r\n\r\n"))[0] == 400

    def test_bad_content_length_400(self, gateways):
        assert _each(gateways, _one(b"PUT /x HTTP/1.1\r\nContent-Length: abc\r\n\r\n"))[0] == 400

    def test_oversized_head_431(self, gateways):
        def script(port):
            s = _connect(port)
            s.sendall(b"GET / HTTP/1.1\r\n")
            junk = b"X-Filler: " + b"a" * 8000 + b"\r\n"
            try:
                for _ in range(40):  # ~320 KB of headers > the 128 KB cap
                    s.sendall(junk)
                s.sendall(b"\r\n")
            except (BrokenPipeError, ConnectionResetError):
                return 0  # the server already slammed the door: acceptable
            status = _read_response(s)[0]
            s.close()
            return status
        got = {side: script(gateways[side].port) for side in SIDES}
        assert set(got.values()) <= {0, 431}, got

    def test_unknown_method_405(self, gateways):
        assert _each(gateways, _one(b"BREW / HTTP/1.1\r\n\r\n"))[0] == 405

    def test_partial_head_across_packets(self, gateways):
        def script(port):
            s = _connect(port)
            for piece in (b"PUT /", b"x HT", b"TP/1.1\r\nHost: s3\r\nConte",
                          b"nt-Length: 0\r", b"\n\r\n"):
                s.sendall(piece)
                time.sleep(0.02)
            out = _read_response(s)
            s.close()
            return out
        status, body = _each(gateways, script)
        assert status == 400 and b"InvalidBucketName" in body

    def test_pipelined_requests_two_responses(self, gateways):
        def script(port):
            s = _connect(port)
            s.sendall(S3_OK + S3_OK)
            out = [_read_response(s), _read_response(s)]
            s.close()
            return out
        (st1, b1), (st2, b2) = _each(gateways, script)
        assert st1 == st2 == 400 and b1 == b2

    def test_keep_alive_many_requests_one_connection(self, gateways):
        def script(port):
            s = _connect(port)
            out = []
            for _ in range(10):
                s.sendall(S3_OK)
                out.append(_read_response(s))
            s.close()
            return out
        got = _each(gateways, script)
        assert all(st == 400 and b"InvalidBucketName" in b for st, b in got)

    def test_http10_defaults_to_close(self, gateways):
        def script(port):
            s = _connect(port)
            s.sendall(b"PUT /x HTTP/1.0\r\nContent-Length: 0\r\n\r\n")
            status, _ = _read_response(s)
            s.settimeout(5)
            tail = s.recv(64)
            s.close()
            return status, tail
        assert _each(gateways, script) == (400, b"")

    def test_unread_body_does_not_desync(self, gateways):
        """An S3 reply to a request whose body the handler read only
        partially (or not at all — a PUT the router 400s before
        draining): the loop must realign, and the next pipelined
        request on the same connection must parse cleanly."""
        body = b"B" * 512

        def script(port):
            s = _connect(port)
            s.sendall(b"BREW /x HTTP/1.1\r\nHost: s3\r\n"
                      + b"Content-Length: %d\r\n\r\n" % len(body))
            first = _read_response(s)[0]  # unknown method replies before the body
            s.close()
            s = _connect(port)
            s.sendall(b"PUT /x HTTP/1.1\r\nHost: s3\r\n"
                      + b"Content-Length: %d\r\n\r\n" % len(body))
            s.sendall(body)
            second = _read_response(s)[0]
            s.sendall(S3_OK)
            third = _read_response(s)
            s.close()
            return first, second, third
        first, second, (status, b2) = _each(gateways, script)
        assert (first, second, status) == (405, 400, 400) and b"InvalidBucketName" in b2


# WebDAV requests that rule before any filer access: OPTIONS -> 200,
# PROPPATCH -> 207 (properties are not persisted)
DAV_OK = b"OPTIONS /any HTTP/1.1\r\nHost: dav\r\n\r\n"
DAV_PATCH = b"PROPPATCH /f HTTP/1.1\r\nHost: d\r\nContent-Length: 0\r\n\r\n"


class TestWebDavMiniLoop:
    def test_options_200_with_dav_header(self, davs):
        assert _each(davs, _one(DAV_OK))[0] == 200

    def test_dav_verb_dispatch_propppatch_207(self, davs):
        """Non-RFC-2616 verbs dispatch through the mini loop's do_*
        table exactly like GET."""
        status, body = _each(davs, _one(DAV_PATCH))
        assert status == 207 and b"multistatus" in body

    def test_garbage_request_line_400(self, davs):
        assert _each(davs, _one(b"%%%\r\n\r\n"))[0] == 400

    def test_unknown_method_405(self, davs):
        assert _each(davs, _one(b"FROBNICATE / HTTP/1.1\r\n\r\n"))[0] == 405

    def test_oversized_head_431(self, davs):
        def script(port):
            s = _connect(port)
            s.sendall(b"OPTIONS / HTTP/1.1\r\n")
            junk = b"X-Filler: " + b"a" * 8000 + b"\r\n"
            try:
                for _ in range(40):
                    s.sendall(junk)
                s.sendall(b"\r\n")
            except (BrokenPipeError, ConnectionResetError):
                return 0  # the server already slammed the door: acceptable
            status = _read_response(s)[0]
            s.close()
            return status
        got = {side: script(davs[side].port) for side in SIDES}
        assert set(got.values()) <= {0, 431}, got

    def test_split_reads_and_keep_alive(self, davs):
        def script(port):
            s = _connect(port)
            out = []
            for _ in range(5):
                for piece in (b"OPTIONS /a", b"ny HTTP/1.1\r\nHo", b"st: d\r\n\r\n"):
                    s.sendall(piece)
                    time.sleep(0.01)
                out.append(_read_response(s))
            s.close()
            return out
        assert [st for st, _ in _each(davs, script)] == [200] * 5

    def test_pipelined_dav_verbs(self, davs):
        def script(port):
            s = _connect(port)
            s.sendall(DAV_OK + DAV_PATCH + DAV_OK)
            out = [_read_response(s) for _ in range(3)]
            s.close()
            return out
        assert [st for st, _ in _each(davs, script)] == [200, 207, 200]

    def test_unread_body_realign(self, davs):
        """OPTIONS ignores its body; the loop skips the declared bytes so
        the next request stays framed."""
        body = b"Z" * 300

        def script(port):
            s = _connect(port)
            s.sendall(b"OPTIONS / HTTP/1.1\r\nHost: d\r\n"
                      + b"Content-Length: %d\r\n\r\n" % len(body) + body + DAV_OK)
            out = [_read_response(s), _read_response(s)]
            s.close()
            return out
        assert [st for st, _ in _each(davs, script)] == [200, 200]

    def test_huge_unread_body_closes_instead_of_blocking(self, davs):
        def script(port):
            s = _connect(port)
            s.sendall(b"OPTIONS / HTTP/1.1\r\nHost: d\r\n"
                      b"Content-Length: 104857600\r\n\r\n")
            status, _ = _read_response(s)
            s.settimeout(5)
            tail = s.recv(64)  # connection closed, not waiting for 100 MB
            s.close()
            return status, tail
        assert _each(davs, script) == (200, b"")
