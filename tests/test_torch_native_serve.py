"""The port's event-driven serving core (csrc/serve.c through
util/native_serve) against the reference's, on the CPU: byte identity
of replies, the zero-copy GET fast path, Range semantics, the keep-alive
knobs, the kill switch, the SO_REUSEPORT bind, Expect validation order,
the flight recorder's wide events, and a loop that cannot arm.

Three arms get the same request bytes: the port's C loop and the port's
threaded mini loop (one store, two live servers: the port's
fuzz_serve.ServePair) and the reference's C loop over a store written
the same way (the reference's ServePair). The tolerance is byte
identity of every response byte.
"""

from __future__ import annotations

import os
import socket
import threading
import time

import pytest

from seaweedfs_tpu.analysis import fuzz_serve as ref_fuzz
from seaweedfs_tpu_torch.analysis import fuzz_serve
from seaweedfs_tpu_torch.util import native_serve

CORPUS = os.path.join(os.path.dirname(__file__), "corpus", "serve")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = fuzz_serve.ServePair(str(tmp_path_factory.mktemp("servepair")))
    yield p
    p.close()


@pytest.fixture(scope="module")
def ref_pair(tmp_path_factory):
    p = ref_fuzz.ServePair(str(tmp_path_factory.mktemp("refservepair")))
    assert p.native_ok, "the reference's C serving loop did not build"
    yield p
    p.close()


def _roundtrip(port: int, payload: bytes, deadline: float = 5.0) -> bytes:
    return fuzz_serve.drive(port, {"fragments": [payload]}, deadline)


def _three_case(pair, ref_pair, case: dict) -> tuple[bytes, bytes, bytes]:
    """(port C loop, port threaded arm, reference C loop) replies; the
    C arms are driven first, so a crash implicates a loop."""
    return (
        fuzz_serve.drive(pair.c_port, case),
        fuzz_serve.drive(ref_pair.c_port, case),
        fuzz_serve.drive(pair.py_port, case),
    )


def _three(pair, ref_pair, payload: bytes) -> bytes:
    """The port C loop's reply, asserted byte-identical to the port's
    threaded arm's and the reference C loop's."""
    c, ref_c, py = _three_case(pair, ref_pair, {"fragments": [payload]})
    assert c == py, "port C loop vs port threaded arm"
    assert c == ref_c, "port C loop vs reference C loop"
    return c


class TestByteIdentity:
    def test_plain_get_fast_path_hit(self, pair, ref_pair):
        """The C arm must actually serve this from the resolver (not
        via handoff): probe by swapping in a counting resolver."""
        hits = []
        srv = pair.servers[0]
        orig = srv.fast_resolver

        def counting(path, rng, head_only):
            plan = orig(path, rng, head_only)
            hits.append(plan is not None)
            return plan

        srv.fast_resolver = counting
        try:
            req = f"GET /{pair.fids['small']} HTTP/1.1\r\n\r\n".encode()
            c = _three(pair, ref_pair, req)
        finally:
            srv.fast_resolver = orig
        assert b"200 OK" in c and b"ETag" in c
        assert hits == [True]

    @pytest.mark.parametrize(
        "shape", ["small", "tiny", "empty", "big", "edge64k", "named",
                  "deleted", "missing", "badcookie"]
    )
    def test_get_identity_per_shape(self, pair, ref_pair, shape):
        assert pair.fids[shape] == ref_pair.fids[shape]
        _three(pair, ref_pair, f"GET /{pair.fids[shape]} HTTP/1.1\r\n\r\n".encode())

    def test_head_identity(self, pair, ref_pair):
        c = _three(pair, ref_pair, f"HEAD /{pair.fids['big']} HTTP/1.1\r\n\r\n".encode())
        assert b"Content-Length: 100000" in c and len(c) < 400

    def test_pipelined_identity(self, pair, ref_pair):
        req = (
            f"GET /{pair.fids['small']} HTTP/1.1\r\n\r\n"
            f"GET /{pair.fids['missing']} HTTP/1.1\r\n\r\n"
            f"GET /{pair.fids['big']} HTTP/1.1\r\nRange: bytes=0-9\r\n\r\n"
        ).encode()
        c = _three(pair, ref_pair, req)
        assert c.count(b"HTTP/1.1 ") == 3

    def test_fragmented_head_identity(self, pair, ref_pair):
        raw = f"GET /{pair.fids['small']} HTTP/1.1\r\nRange: bytes=1-5\r\n\r\n".encode()
        frags = [raw[i : i + 7] for i in range(0, len(raw), 7)]
        c, ref_c, py = _three_case(pair, ref_pair, {"fragments": frags})
        assert c == py == ref_c and b"206" in c

    def test_http10_connection_close_identity(self, pair, ref_pair):
        c = _three(pair, ref_pair, f"GET /{pair.fids['tiny']} HTTP/1.0\r\n\r\n".encode())
        assert b"Connection: close" in c


class TestRangeCorrectness:
    """util/http_range.parse_range semantics end to end through every
    arm (suffix, out-of-bounds→416, multi-byte offsets, open-ended)."""

    @pytest.mark.parametrize(
        "rng",
        [
            "bytes=0-0",          # first byte
            "bytes=100-199",      # interior run
            "bytes=-100",         # suffix
            "bytes=-1",           # one-byte suffix
            "bytes=-999999",      # suffix larger than the body: whole body
            "bytes=699-",         # open-ended to EOF
            "bytes=650-100000",   # end clamped to EOF
            "bytes=700-",         # start == total: 416
            "bytes=999999-",      # far out of bounds: 416
            "bytes=5-2",          # inverted: 416
            "bytes=abc",          # malformed: 416
            "bytes=",             # empty spec: 416
            "bytes=0-99,200-299", # multi-range: first range only
            "bits=0-1",           # non-bytes unit: full 200
        ],
    )
    def test_range_identity(self, pair, ref_pair, rng):
        _three(pair, ref_pair,
               f"GET /{pair.fids['small']} HTTP/1.1\r\nRange: {rng}\r\n\r\n".encode())

    def test_suffix_range_bytes(self, pair, ref_pair):
        c = _three(pair, ref_pair,
                   f"GET /{pair.fids['small']} HTTP/1.1\r\nRange: bytes=-100\r\n\r\n".encode())
        head, _, body = c.partition(b"\r\n\r\n")
        assert b"206" in head.split(b"\r\n")[0]
        assert b"Content-Range: bytes 600-699/700" in head
        assert len(body) == 100

    def test_out_of_bounds_416_contract(self, pair, ref_pair):
        c = _three(pair, ref_pair,
                   f"GET /{pair.fids['small']} HTTP/1.1\r\nRange: bytes=700-\r\n\r\n".encode())
        assert c.startswith(b"HTTP/1.1 416 ")
        assert b"Content-Range: bytes */700" in c

    def test_multi_byte_offset_slices_match_store(self, pair, ref_pair):
        """The sendfile window must hit the exact data bytes: three
        disjoint slices of the 100 KB needle against the full body."""
        full = _roundtrip(
            pair.c_port, f"GET /{pair.fids['big']} HTTP/1.1\r\n\r\n".encode()
        ).partition(b"\r\n\r\n")[2]
        assert len(full) == 100_000
        for start, end in [(0, 0), (65_535, 65_537), (99_998, 99_999)]:
            c = _three(pair, ref_pair, (
                f"GET /{pair.fids['big']} HTTP/1.1\r\n"
                f"Range: bytes={start}-{end}\r\n\r\n"
            ).encode())
            assert c.partition(b"\r\n\r\n")[2] == full[start : end + 1]


def _corpus_entries() -> list[str]:
    if not os.path.isdir(CORPUS):
        return []
    return sorted(p for p in os.listdir(CORPUS) if p.endswith(".json"))


class TestCorpusAndFuzz:
    def test_serve_corpus_is_seeded(self):
        assert len(_corpus_entries()) >= 12, "tests/corpus/serve/ lost entries"

    @pytest.mark.parametrize("name", _corpus_entries())
    def test_corpus_entry_identity(self, pair, ref_pair, name):
        with open(os.path.join(CORPUS, name), encoding="utf-8") as f:
            case = fuzz_serve.case_from_json(f.read())
        c, ref_c, py = _three_case(pair, ref_pair, case)
        assert c == py, f"{name}: port C loop vs port threaded arm"
        assert c == ref_c, f"{name}: port C loop vs reference C loop"

    def test_fresh_fuzz_round(self, tmp_path):
        report = fuzz_serve.run(
            iterations=20, seed=4321, corpus_dir=str(tmp_path / "corpus")
        )
        assert report.iterations == 20
        assert not report.divergences, report.divergences


class TestKnobs:
    @pytest.mark.parametrize("arm", ["c", "py"])
    def test_idle_timeout_closes_connection(self, tmp_path, arm):
        p = fuzz_serve.ServePair(str(tmp_path / arm), serve_idle_ms=300)
        try:
            port = p.c_port if arm == "c" else p.py_port
            s = socket.create_connection(("127.0.0.1", port), timeout=5)
            s.sendall(f"GET /{p.fids['tiny']} HTTP/1.1\r\n\r\n".encode())
            first = b""
            end = time.monotonic() + 5
            while b"\r\n\r\n" not in first and time.monotonic() < end:
                first += s.recv(65536)
            assert b"200 OK" in first
            # idle past the knob: the server must close, not hold the fd
            s.settimeout(5)
            t0 = time.monotonic()
            while s.recv(64):
                pass
            assert time.monotonic() - t0 < 4
            s.close()
        finally:
            p.close()

    @pytest.mark.parametrize("arm", ["c", "py"])
    def test_max_reqs_closes_with_connection_close(self, tmp_path, arm):
        p = fuzz_serve.ServePair(str(tmp_path / arm), serve_max_reqs=2)
        try:
            port = p.c_port if arm == "c" else p.py_port
            req = f"GET /{p.fids['tiny']} HTTP/1.1\r\n\r\n".encode()
            out = fuzz_serve.drive(port, {"fragments": [req * 3]})
            # request 1 plain, request 2 carries Connection: close,
            # request 3 is never served
            assert out.count(b"HTTP/1.1 200 OK") == 2
            assert out.count(b"Connection: close") == 1
        finally:
            p.close()

    @pytest.mark.parametrize("arm", ["c", "py"])
    def test_idle_timeout_spares_slow_draining_download(self, tmp_path, arm):
        """-serveIdleMs is an IDLE bound, not a total-transfer deadline:
        a client draining a large body slower than body/idle_ms still
        receives every byte. The blob outsizes the socket buffers, so
        the server enters the partial-write state."""
        import numpy as np

        from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
        from seaweedfs_tpu_torch.storage.needle import Needle

        total = 8 << 20
        p = fuzz_serve.ServePair(str(tmp_path / arm), serve_idle_ms=400)
        try:
            v = p.vs.store.find_volume(1)
            n = Needle(cookie=0x99999999, id=50,
                       data=np.random.default_rng(9).bytes(total))
            n.last_modified = 1_700_000_050
            n.set_has_last_modified_date()
            v.write_needle(n)
            fid = f"1,{format_needle_id_cookie(50, 0x99999999)}"
            port = p.c_port if arm == "c" else p.py_port
            s = socket.socket()
            # small windows BEFORE connect, so the server cannot park
            # the whole body in kernel buffers and skip the slow drain
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 32768)
            s.settimeout(10)
            s.connect(("127.0.0.1", port))
            s.sendall(f"GET /{fid} HTTP/1.1\r\n\r\n".encode())
            got = 0
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and got < total:
                try:
                    chunk = s.recv(65536)
                except OSError:
                    break
                if not chunk:
                    break
                got += len(chunk)
                time.sleep(0.02)  # ~3 MB/s: the idle knob expires 8x over
            s.close()
            assert got >= total, f"slow download truncated at {got}/{total}+head [{arm}]"
        finally:
            p.close()

    @staticmethod
    def _big_needle_pair(tmp_path, total):
        from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
        from seaweedfs_tpu_torch.storage.needle import Needle

        import numpy as np

        p = fuzz_serve.ServePair(str(tmp_path / "py"), serve_idle_ms=400)
        n = Needle(cookie=0x99999999, id=50, data=np.random.default_rng(9).bytes(total))
        n.last_modified = 1_700_000_050
        n.set_has_last_modified_date()
        p.vs.store.find_volume(1).write_needle(n)
        return p, f"1,{format_needle_id_cookie(50, 0x99999999)}"

    def test_py_arm_drains_a_slow_download_to_its_last_byte(self, tmp_path):
        """F5's regression: the threaded arm under -serveIdleMs 400 sends
        an 8 MiB needle to a client that reads 32 KiB every 20 ms through
        a 32 KiB receive buffer. The send queue stays too full to poll
        writable for whole idle windows while bytes still move; the
        drain probe sees them move, so every byte arrives."""
        total = 8 << 20
        p, fid = self._big_needle_pair(tmp_path, total)
        try:
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 32768)
            s.settimeout(10)
            s.connect(("127.0.0.1", p.py_port))
            s.sendall(f"GET /{fid} HTTP/1.1\r\n\r\n".encode())
            raw = bytearray()
            deadline = time.monotonic() + 90
            while time.monotonic() < deadline:
                chunk = s.recv(32768)
                if not chunk:
                    break
                raw += chunk
                head, sep, body = bytes(raw).partition(b"\r\n\r\n")
                if sep and len(body) >= total:
                    break
                time.sleep(0.02)
            s.close()
            head, _, body = bytes(raw).partition(b"\r\n\r\n")
            assert b"200 OK" in head and f"Content-Length: {total}".encode() in head
            assert len(body) == total, f"slow download truncated at {len(body)}/{total}"
            assert body == p.vs.store.find_volume(1).read_needle(50).data
        finally:
            p.close()

    def test_py_arm_cuts_a_stalled_download_after_two_idle_windows(self, tmp_path):
        """A client that asks for 8 MiB and never reads: once no byte
        moves, two zero-progress windows of -serveIdleMs 400 are a stall
        and the server closes the connection. The server's side of the
        socket (read from /proc/net/tcp) leaves ESTABLISHED two windows
        after the last byte moved in its send queue, and before a third
        window has passed."""
        p, fid = self._big_needle_pair(tmp_path, 8 << 20)

        def server_side(client_port):
            """(state, tx_queue) of the server's end of the connection."""
            with open("/proc/net/tcp") as f:
                for line in f.read().splitlines()[1:]:
                    col = line.split()
                    if (int(col[1].split(":")[1], 16) == p.py_port
                            and int(col[2].split(":")[1], 16) == client_port):
                        return col[3], col[4]
            return None, None

        try:
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 32768)
            s.connect(("127.0.0.1", p.py_port))
            client_port = s.getsockname()[1]
            s.sendall(f"GET /{fid} HTTP/1.1\r\n\r\n".encode())
            t0 = last_move = time.monotonic()
            queue, cut = None, None
            while time.monotonic() - t0 < 10:
                state, tx = server_side(client_port)
                now = time.monotonic()
                if state not in ("01", None):  # 01: ESTABLISHED
                    cut = now
                    break
                if tx != queue:
                    queue, last_move = tx, now
                time.sleep(0.005)
            s.close()
            assert cut is not None, "a stalled download was never cut"
            stalled = cut - last_move
            assert 0.75 <= stalled < 1.2, f"cut {stalled:.3f} s after the last byte moved"
        finally:
            p.close()

    def test_max_reqs_identical_bytes_both_arms(self, tmp_path):
        p = fuzz_serve.ServePair(str(tmp_path / "port"), serve_max_reqs=2)
        r = ref_fuzz.ServePair(str(tmp_path / "ref"), serve_max_reqs=2)
        try:
            req = f"GET /{p.fids['small']} HTTP/1.1\r\n\r\n".encode() * 4
            c = fuzz_serve.drive(p.c_port, {"fragments": [req]})
            py = fuzz_serve.drive(p.py_port, {"fragments": [req]})
            ref_c = fuzz_serve.drive(r.c_port, {"fragments": [req]})
            assert c == py == ref_c
        finally:
            p.close()
            r.close()


class TestKillSwitch:
    def test_native_serve_env_kill_switch(self, tmp_path, monkeypatch):
        """WEED_NATIVE_SERVE=0 lands every server on the threaded path
        (try_serve_forever declines)."""
        monkeypatch.setattr(native_serve, "NATIVE_SERVE_ENABLED", False)
        p = fuzz_serve.ServePair(str(tmp_path))
        try:
            assert getattr(p.servers[0], "_serve_wake_w", None) is None
            req = f"GET /{p.fids['small']} HTTP/1.1\r\n\r\n".encode()
            out = fuzz_serve.drive(p.c_port, {"fragments": [req]})
            assert b"200 OK" in out and out.partition(b"\r\n\r\n")[2]
        finally:
            p.close()

    def test_double_shutdown_is_idempotent(self, tmp_path):
        """stop()ing a native server twice must not fall through to
        socketserver.shutdown(), which waits forever on an event the
        stdlib loop (which never ran) will never set."""
        p = fuzz_serve.ServePair(str(tmp_path))
        try:
            srv = p.servers[0]
            srv.shutdown()
            done = threading.Event()

            def second():
                srv.shutdown()
                done.set()

            threading.Thread(target=second, daemon=True).start()
            assert done.wait(5), "second shutdown() deadlocked"
        finally:
            p.close()

    def test_native_arm_is_actually_native(self, pair):
        """The positive control for the kill-switch test: the C arm
        carries the loop's wake pipe, the threaded arm does not."""
        assert getattr(pair.servers[0], "_serve_wake_w", None) is not None
        assert getattr(pair.servers[1], "_serve_wake_w", None) is None


class TestArming:
    """No quiet fallback: a loop that cannot arm makes start() raise."""

    def test_build_failure_makes_start_raise(self, tmp_path, monkeypatch):
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.util.availability import free_port

        def broken():
            raise RuntimeError("kernel build failed\nserve_ext.c: error: planted")

        monkeypatch.setattr(native_serve, "_ext", broken)
        vs = VolumeServer([str(tmp_path)], port=free_port(), device="cpu",
                          scrub_interval=0)
        try:
            with pytest.raises(RuntimeError, match="planted"):
                vs.start()
        finally:
            vs.stop()

    def test_build_failure_makes_filer_start_raise(self, tmp_path, monkeypatch):
        """The filer's listener arms before FilerServer.start() returns,
        as the volume server's and the master's do."""
        from seaweedfs_tpu_torch.server.filer_server import FilerServer
        from seaweedfs_tpu_torch.util.availability import free_port

        def broken():
            raise RuntimeError("kernel build failed\nserve_ext.c: error: planted")

        monkeypatch.setattr(native_serve, "_ext", broken)
        fs = FilerServer([f"127.0.0.1:{free_port()}"], port=free_port(),
                         store="lsm", store_path=str(tmp_path / "lsm"))
        try:
            with pytest.raises(RuntimeError, match="planted"):
                fs.start()
        finally:
            fs.stop()

    def test_threaded_arm_needs_no_build(self, tmp_path, monkeypatch):
        """The switch, not a failure, selects the threaded arm: with
        WEED_NATIVE_SERVE=0 the same broken build is never reached."""
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.util.availability import free_port

        def broken():
            raise RuntimeError("must not be built")

        monkeypatch.setattr(native_serve, "_ext", broken)
        monkeypatch.setattr(native_serve, "NATIVE_SERVE_ENABLED", False)
        vs = VolumeServer([str(tmp_path)], port=free_port(), device="cpu",
                          scrub_interval=0)
        vs.start()
        try:
            out = _roundtrip(vs.port, b"GET /status HTTP/1.1\r\n\r\n")
            assert out.startswith(b"HTTP/1.1 200 ")
        finally:
            vs.stop()


class TestReusePort:
    def test_two_listeners_share_one_port(self):
        """Two ReusePortWeedHTTPServer binds on one port both come up
        (server_bind sets SO_REUSEPORT explicitly)."""
        from seaweedfs_tpu_torch.util.httpd import FastHandler, ReusePortWeedHTTPServer

        class H(FastHandler):
            def do_GET(self):
                self.fast_reply(200, str(os.getpid()).encode())

        a = ReusePortWeedHTTPServer(("127.0.0.1", 0), H)
        port = a.server_address[1]
        b = ReusePortWeedHTTPServer(("127.0.0.1", port), H)
        for s in (a, b):
            threading.Thread(target=s.serve_forever, daemon=True).start()
        for s in (a, b):
            s.wait_armed()
        out = _roundtrip(port, b"GET / HTTP/1.1\r\n\r\n")
        assert b"200 OK" in out
        for s in (a, b):
            s.shutdown()
            s.server_close()


class TestExpectValidationOrder:
    """100 Continue is not sent before the request validates (bad
    Content-Length, unknown method)."""

    def test_bad_content_length_rejects_without_100(self, pair):
        out = _roundtrip(
            pair.py_port,
            b"POST /1,00000000 HTTP/1.1\r\nExpect: 100-continue\r\n"
            b"Content-Length: abc\r\n\r\n",
        )
        assert b"100 Continue" not in out
        assert b"400" in out.split(b"\r\n", 1)[0]

    def test_unknown_method_rejects_without_100(self, pair):
        out = _roundtrip(
            pair.py_port,
            b"BREW /x HTTP/1.1\r\nExpect: 100-continue\r\n"
            b"Content-Length: 4\r\n\r\n",
        )
        assert b"100 Continue" not in out
        assert b"405" in out.split(b"\r\n", 1)[0]

    def test_valid_expect_still_gets_100(self, pair):
        s = socket.create_connection(("127.0.0.1", pair.py_port), timeout=5)
        try:
            s.sendall(
                b"GET /status HTTP/1.1\r\nExpect: 100-continue\r\n"
                b"Content-Length: 0\r\n\r\n"
            )
            buf = b""
            end = time.monotonic() + 5
            while b"\r\n\r\n" not in buf and time.monotonic() < end:
                buf += s.recv(4096)
            assert buf.startswith(b"HTTP/1.1 100 Continue\r\n\r\n")
        finally:
            s.close()

    def test_both_arms_identical_on_expect_abuse(self, pair, ref_pair):
        _three(pair, ref_pair,
               b"POST /1,00000000 HTTP/1.1\r\nExpect: 100-continue\r\n"
               b"Content-Length: oops\r\n\r\n")


class TestBlackboxIdentity:
    """Wide events from the C fast path are indistinguishable from the
    threaded arm's: same record name, same stage fields, same status."""

    @pytest.fixture(autouse=True)
    def _fresh_recorder(self):
        from seaweedfs_tpu_torch.trace import blackbox, tracer

        blackbox.reset()
        blackbox.set_enabled(True)
        tracer.set_enabled(True)
        tracer.set_sample_every(1)
        yield

    def _records(self, want):
        """Poll the flight recorder (fast-path drain is asynchronous)."""
        from seaweedfs_tpu_torch.trace import blackbox

        end = time.monotonic() + 5.0
        while time.monotonic() < end:
            snap = blackbox.snapshot(256)
            rows = [r for r in snap["tail"] + snap["ok"] if want(r)]
            if rows:
                return rows
            time.sleep(0.05)
        return []

    def _get(self, port: int, fid: str) -> bytes:
        return _roundtrip(port, f"GET /{fid} HTTP/1.1\r\n\r\n".encode("ascii"))

    @pytest.mark.parametrize("arm", ["c", "py"])
    def test_ok_record_has_identical_stage_fields(self, pair, arm):
        from seaweedfs_tpu_torch.trace import blackbox

        blackbox.reset()
        port = pair.c_port if arm == "c" else pair.py_port
        ok_every = blackbox.snapshot(0)["ok_every"]
        for i in range(4 * ok_every):
            # unique query per request: a plan-cache hit is served
            # without re-entering Python
            out = self._get(port, f"{pair.fids['small']}?i={i}")
            assert b"200 OK" in out.split(b"\r\n", 1)[0]
        rows = self._records(lambda r: r["name"] == "volume.GET" and r["status"] == 200)
        assert rows, f"no volume.GET records drained on {arm} arm"
        staged = [r for r in rows if r.get("stages_ms")]
        assert staged, f"no staged records on {arm} arm"
        for r in staged:
            assert set(r["stages_ms"]) == set(native_serve.SERVE_STAGES)
            assert r["plane"] == "serve"
            assert r["bytes"] > 0

    def test_error_kept_in_tail_on_both_arms(self, pair):
        from seaweedfs_tpu_torch.trace import blackbox

        for port in (pair.c_port, pair.py_port):
            blackbox.reset()
            out = self._get(port, pair.fids["missing"])
            assert b"404" in out.split(b"\r\n", 1)[0]
            rows = self._records(lambda r: r["name"] == "volume.GET" and r["status"] == 404)
            # errors are never sampled away: the tail ring keeps them
            assert rows
            assert all(r in blackbox.snapshot(256)["tail"] for r in rows)
            staged = [r for r in rows if r.get("stages_ms")]
            assert staged
            for r in staged:
                assert set(r["stages_ms"]) == set(native_serve.SERVE_STAGES)
                assert r["bytes"] > 0
