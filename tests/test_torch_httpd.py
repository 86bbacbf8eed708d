"""The port's mini request loop (seaweedfs_tpu_torch/util/httpd
serve_connection) against seaweedfs_tpu's, with raw sockets.

The edge cases of tests/test_httpd_miniloop.py — garbage request line,
bad version, bad Content-Length, 431, 405, partial heads, pipelining,
keep-alive, HTTP/1.0, unread bodies, 100-continue and half-open
connections — each run against a standalone volume server of each
package: the port's (which serves on the threaded mini loop; the C
epoll core waits) and the reference's on the same arm (its C loop held
off, as WEED_NATIVE_SERVE=0 does). Both must answer each case the same
way. The buffered reader, which gathers a body into one buffer where
the reference's grows its buffer a recv at a time, reads the same
bytes as the reference's.
"""

from __future__ import annotations

import socket
import time

import pytest

from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu.util import native_serve as ref_native_serve
from seaweedfs_tpu.util.availability import free_port
from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PortServer


@pytest.fixture(scope="module", params=["ref", "port"])
def vs(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp(f"mini-{request.param}"))
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "ref":
            mp.setattr(ref_native_serve, "NATIVE_SERVE_ENABLED", False)
            server = RefServer([d], port=free_port(), ec_codec="cpu", scrub_interval=0)
        else:
            server = PortServer(
                [d], port=free_port(), ec_codec="cuda", device="cpu", scrub_interval=0
            )
        server.start()
        yield server
        server.stop()


def _connect(vs):
    s = socket.create_connection(("127.0.0.1", vs.port), timeout=10)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, True)
    return s


_leftover: dict[socket.socket, bytes] = {}


def _read_response(s) -> tuple[int, bytes]:
    """(status, body) for one Content-Length-framed response, carrying
    per-socket leftovers (pipelined responses can share a segment)."""
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


class TestMiniLoopEdges:
    def test_garbage_request_line_400(self, vs):
        s = _connect(vs)
        s.sendall(b"NOT A REQUEST\r\n\r\n")
        status, _ = _read_response(s)
        assert status == 400
        s.close()

    def test_bad_version_400(self, vs):
        s = _connect(vs)
        s.sendall(b"GET /status FTP/9\r\n\r\n")
        status, _ = _read_response(s)
        assert status == 400
        s.close()

    def test_bad_content_length_400(self, vs):
        s = _connect(vs)
        s.sendall(
            b"POST /1,00000000 HTTP/1.1\r\nContent-Length: abc\r\n\r\n"
        )
        status, _ = _read_response(s)
        assert status == 400
        s.close()

    def test_oversized_head_431(self, vs):
        s = _connect(vs)
        s.sendall(b"GET /status HTTP/1.1\r\n")
        junk = b"X-Filler: " + b"a" * 8000 + b"\r\n"
        try:
            for _ in range(40):  # ~320 KB of headers > the 128 KB cap
                s.sendall(junk)
            s.sendall(b"\r\n")
        except (BrokenPipeError, ConnectionResetError):
            return  # server already slammed the door: acceptable
        status, _ = _read_response(s)
        assert status in (0, 431)  # 431 or hard close
        s.close()

    def test_unknown_method_405(self, vs):
        s = _connect(vs)
        s.sendall(b"BREW /status HTTP/1.1\r\n\r\n")
        status, _ = _read_response(s)
        assert status == 405
        s.close()

    def test_partial_head_across_packets(self, vs):
        s = _connect(vs)
        for piece in (b"GET /sta", b"tus HT", b"TP/1.1\r\nHost: x\r", b"\n\r\n"):
            s.sendall(piece)
            time.sleep(0.02)
        status, body = _read_response(s)
        assert status == 200 and b"seaweedfs_tpu" in body
        s.close()

    def test_pipelined_requests_two_responses(self, vs):
        s = _connect(vs)
        s.sendall(
            b"GET /status HTTP/1.1\r\nHost: x\r\n\r\n"
            b"GET /status HTTP/1.1\r\nHost: x\r\n\r\n"
        )
        st1, b1 = _read_response(s)
        st2, b2 = _read_response(s)
        assert st1 == st2 == 200 and b1 == b2
        s.close()

    def test_keep_alive_many_requests_one_connection(self, vs):
        s = _connect(vs)
        for _ in range(20):
            s.sendall(b"GET /status HTTP/1.1\r\nHost: x\r\n\r\n")
            status, body = _read_response(s)
            assert status == 200 and b"Volumes" in body
        s.close()

    def test_connection_close_honored(self, vs):
        s = _connect(vs)
        s.sendall(
            b"GET /status HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
        )
        status, _ = _read_response(s)
        assert status == 200
        # server must close its side; the next recv sees EOF
        s.settimeout(5)
        assert s.recv(64) == b""
        s.close()

    def test_http10_defaults_to_close(self, vs):
        s = _connect(vs)
        s.sendall(b"GET /status HTTP/1.0\r\n\r\n")
        status, _ = _read_response(s)
        assert status == 200
        s.settimeout(5)
        assert s.recv(64) == b""
        s.close()

    def test_unread_error_body_does_not_desync(self, vs):
        """A 4xx reply to a request whose body the handler never read:
        the loop must skip the body bytes, and the NEXT request on the
        same connection must parse cleanly (not the stale body)."""
        s = _connect(vs)
        body = b"B" * 512
        # invalid fid -> 400 before the handler touches the body
        s.sendall(
            b"POST /not-a-fid HTTP/1.1\r\nHost: x\r\n"
            + b"Content-Length: %d\r\n\r\n" % len(body)
            + body
        )
        status, _ = _read_response(s)
        assert status in (400, 404)
        s.sendall(b"GET /status HTTP/1.1\r\nHost: x\r\n\r\n")
        status, resp = _read_response(s)
        assert status == 200 and b"Volumes" in resp
        s.close()

    def test_huge_unread_body_closes_instead_of_blocking(self, vs):
        """Past the 1 MiB skip budget the loop closes rather than
        reading a body nobody wants."""
        s = _connect(vs)
        s.sendall(
            b"POST /not-a-fid HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: 104857600\r\n\r\n"
        )
        status, _ = _read_response(s)
        assert status in (400, 404)
        s.settimeout(5)
        assert s.recv(64) == b""  # connection closed, not waiting 100 MB
        s.close()

    def test_expect_100_continue(self, vs):
        s = _connect(vs)
        s.sendall(
            b"POST /not-a-fid HTTP/1.1\r\nHost: x\r\n"
            b"Expect: 100-continue\r\nContent-Length: 4\r\n\r\n"
        )
        buf = b""
        while b"100 Continue\r\n\r\n" not in buf:
            chunk = s.recv(4096)
            assert chunk, "no 100 Continue interim"
            buf += chunk
        s.sendall(b"data")
        # the final response follows on the same stream
        rest = buf.split(b"100 Continue\r\n\r\n", 1)[1]
        while b"\r\n\r\n" not in rest:
            rest += s.recv(4096)
        assert rest.split(None, 2)[1] in (b"400", b"404")
        s.close()

    def test_half_open_connection_no_thread_leak(self, vs):
        """Clients that connect and send nothing then vanish must not
        wedge anything: the loop's recv sees EOF and returns."""
        for _ in range(10):
            s = _connect(vs)
            s.close()
        # and one that sends half a head then disconnects
        s = _connect(vs)
        s.sendall(b"GET /sta")
        s.close()
        # server still healthy
        s = _connect(vs)
        s.sendall(b"GET /status HTTP/1.1\r\nHost: x\r\n\r\n")
        status, _ = _read_response(s)
        assert status == 200
        s.close()


@pytest.mark.parametrize("body_len,sent,initial", [
    (3 << 20, 3 << 20, 1000), (3 << 20, (3 << 20) - 77, 0), ((1 << 20) + 5, (1 << 20) + 5, 70000),
    (40_000, 40_000, 10), (40_000, 40_000, 40_004),
], ids=["large", "large-truncated", "partly-buffered", "small", "all-buffered"])
def test_buffered_reader_reads_bodies_as_the_references(body_len, sent, initial):
    """The port's _BufReader gathers the part of a body still on the
    wire into one buffer (the reference's grows its buffer a recv at a
    time); read(n), the bytes left for the next request and the
    consumed count are the reference's, on a whole body and on one cut
    short by EOF."""
    import numpy as np
    import threading

    from seaweedfs_tpu.util import httpd as ref_httpd
    from seaweedfs_tpu_torch.util import httpd as port_httpd

    data = np.random.default_rng(body_len).bytes(sent) + (b"NEXT" if sent == body_len else b"")
    got = {}
    for side, mod in (("ref", ref_httpd), ("port", port_httpd)):
        a, b = socket.socketpair()
        t = threading.Thread(target=lambda: (b.sendall(data[initial:]), b.close()))
        t.start()
        reader = mod._BufReader(a, data[:initial])
        body = reader.read(body_len)
        rest = reader.read(4)
        got[side] = (body, rest, reader.consumed)
        t.join()
        a.close()
    assert got["port"] == got["ref"]
    assert got["port"][0] == data[:min(body_len, sent)]
