"""Structured fuzzer: the C epoll serving loop vs the threaded mini loop.

The port of seaweedfs_tpu/analysis/fuzz_serve.py, over the port's
volume server and its C serving core (csrc/serve.c).

serve.c re-implements the serving edge — request-head scanning,
keep-alive/pipelining bookkeeping, the zero-copy GET fast path, and
the Connection/Content-Length response tail — all byte-contracted to
the pure-Python path (util/httpd.serve_connection + the volume
server's do_GET): for any request stream the C loop either serves
bytes IDENTICAL to what the threaded loop serves, or hands the
connection off so the threaded loop serves it directly.  This driver
generates adversarial request streams — pipelined bursts, fragmented
and torn heads, hostile Range forms, conditional headers, garbage
request lines, oversized heads, half-closed connections — plays each
stream against TWO live servers over one shared volume store (one on
the epoll loop, one pinned to the threaded path), and diffs every
byte that comes back.

Crash persistence mirrors fuzz_post: each case is written to the
corpus directory BEFORE it is driven, so a segfaulting input survives
the dead process; diverging inputs persist as regression entries
under tests/corpus/serve/ (the corpus both packages share), which
tests/test_torch_native_serve.py sweeps on every tier-1 run (the
reference's `fuzz_serve --seed-corpus` seeds it).
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import random
import socket
import tempfile
import threading
import time
from dataclasses import dataclass, field

from seaweedfs_tpu_torch.analysis import REPO_ROOT

DEFAULT_CORPUS = os.path.join(REPO_ROOT, "tests", "corpus", "serve")


# ---------------------------------------------------------------------------
# fixture: one store, two servers (epoll arm + threaded arm)


class ServePair:
    """A volume store served by two HTTP servers at once: `c_port`
    drives the native epoll loop, `py_port` is pinned to the threaded
    mini loop. The store is written once (deterministic timestamps)
    and every fuzz case reads through both."""

    def __init__(
        self, workdir: str, serve_idle_ms: int = 0, serve_max_reqs: int = 0,
        **server_kwargs,
    ):
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
        from seaweedfs_tpu_torch.storage.needle import Needle
        from seaweedfs_tpu_torch.util import native_serve
        from seaweedfs_tpu_torch.util.httpd import WeedHTTPServer

        self.native_ok = native_serve.available()
        vol_dir = os.path.join(workdir, "vols")
        os.makedirs(vol_dir)
        # server_kwargs: ec_codec/device for the store (the pair reads
        # plain volumes only, so its EC codec never runs)
        self.vs = VolumeServer([vol_dir], port=0, scrub_interval=0, **server_kwargs)
        self.vs.store.add_volume(1, "", "000", "")
        v = self.vs.store.find_volume(1)

        def put(key, cookie, data, **attrs):
            n = Needle(cookie=cookie, id=key, data=data)
            n.last_modified = 1_700_000_000 + key
            n.set_has_last_modified_date()
            for a, val in attrs.items():
                setattr(n, a, val)
            v.write_needle(n)
            return f"1,{format_needle_id_cookie(key, cookie)}"

        rnd = random.Random(42)
        self.fids = {
            "small": put(1, 0x11111111, rnd.randbytes(700)),
            "tiny": put(2, 0x22222222, b"x"),
            "empty": put(3, 0x33333333, b""),
            "big": put(4, 0x44444444, rnd.randbytes(100_000)),
            "edge64k": put(5, 0x55555555, rnd.randbytes(65_530)),
        }
        # flag-bearing needles: the resolver pre-renders Content-Type /
        # Content-Disposition so these stay on the C fast path too
        n = Needle(cookie=0x66666666, id=6, data=b"named blob")
        n.last_modified = 1_700_000_006
        n.set_has_last_modified_date()
        n.name = b"f.bin"
        n.set_has_name()
        v.write_needle(n)
        self.fids["named"] = f"1,{format_needle_id_cookie(6, 0x66666666)}"
        n = Needle(cookie=0x88888888, id=8, data=b"<p>mime blob</p>")
        n.last_modified = 1_700_000_008
        n.set_has_last_modified_date()
        n.mime = b"text/html"
        n.set_has_mime()
        v.write_needle(n)
        self.fids["mime"] = f"1,{format_needle_id_cookie(8, 0x88888888)}"
        # a deleted needle (tombstone) and a never-written fid
        fid_gone = put(7, 0x77777777, b"doomed")
        v.delete_needle(Needle(cookie=0x77777777, id=7))
        self.fids["deleted"] = fid_gone
        self.fids["missing"] = f"1,{format_needle_id_cookie(99, 0xABCD1234)}"
        self.fids["badcookie"] = f"1,{format_needle_id_cookie(1, 0xDEADBEEF)}"

        handler = self.vs._http_handler_class()
        resolver = self.vs._make_fast_resolver()
        self.servers = []
        ports = []
        for native in (True, False):
            srv = WeedHTTPServer(("127.0.0.1", 0), handler)
            srv.trace_name = "volume"
            srv.trace_node = "fuzz"
            srv.fast_resolver = resolver
            srv.native_serve = native
            srv.serve_idle_ms = serve_idle_ms
            srv.serve_max_reqs = serve_max_reqs
            t = threading.Thread(target=srv.serve_forever, daemon=True)
            t.start()
            self.servers.append(srv)
            ports.append(srv.server_address[1])
        for srv in self.servers:
            srv.wait_armed()
        self.c_port, self.py_port = ports

    def close(self) -> None:
        for srv in self.servers:
            srv.shutdown()
            srv.server_close()
        self.vs.store.close()


# ---------------------------------------------------------------------------
# case generation

_RANGES = [
    "bytes=0-0", "bytes=0-99", "bytes=100-199", "bytes=-1", "bytes=-100",
    "bytes=-999999", "bytes=699-", "bytes=700-", "bytes=0-",
    "bytes=5-2", "bytes=abc", "bytes=", "bytes=1-2,5-6", "bits=0-1",
    "bytes= 0 - 9", "bytes=00000000000000000001-2", "bytes=-0",
    "bytes=0-99999999999999999999", "BYTES=0-1", "bytes=65529-",
]

_INM_VALUES = [
    '"x"', "*", "", '"067c9745"', 'W/"067c9745"', 'W/"x"',
    '"a", "067c9745"', '"a", "b", "c"', '"unterminated', "W/",
    "067c9745", '  "067c9745"  ', '"067c9745",', ',"067c9745"',
]

_JUNK_LINES = [
    b"NOT A REQUEST\r\n\r\n",
    b"GET\r\n\r\n",
    b"GET /status FTP/9\r\n\r\n",
    b"GET  /status HTTP/1.1\r\n\r\n",
    b"G\x00T / HTTP/1.1\r\n\r\n",
    b"GET /status HTTP/1.1\r\nbad header line\r\n\r\n",
    b"GET /status HTTP/1.1\r\n: empty\r\n\r\n",
    b"\r\n\r\n",
]


def gen_case(rng: random.Random, fids: dict) -> dict:
    """One adversarial connection: {'fragments': [bytes...]} — the
    stream is sent fragment by fragment, then the write side closes."""
    reqs: list[bytes] = []
    n_reqs = rng.randrange(1, 5)
    fid_pool = list(fids.values())
    for _ in range(n_reqs):
        kind = rng.randrange(12)
        if kind == 0:
            reqs.append(rng.choice(_JUNK_LINES))
            break  # the connection dies here on both arms
        method = rng.choice(["GET", "GET", "GET", "HEAD", "BREW", "OPTIONS"])
        path = rng.choice(
            fid_pool
            + [
                "status", "metrics-not", "", "1,zz", "1", "1,",
                fid_pool[0] + "/name.txt", fid_pool[0] + ".bin",
                fid_pool[0] + "?dl=true", "%2e%2e", "a" * 300,
            ]
        )
        version = rng.choice(["HTTP/1.1"] * 4 + ["HTTP/1.0", "HTTP/2"])
        lines = [f"{method} /{path} {version}"]
        if rng.random() < 0.6:
            lines.append(f"Range: {rng.choice(_RANGES)}")
        if rng.random() < 0.15:
            lines.append(f"Range: {rng.choice(_RANGES)}")  # duplicate
        if rng.random() < 0.2:
            lines.append(
                "Connection: " + rng.choice(["close", "keep-alive", "Close",
                                             "upgrade", ""])
            )
        if rng.random() < 0.25:
            # "067c9745" is the deterministic ETag of the `small` needle:
            # against the live store these hit the C 304 arm for real
            lines.append("If-None-Match: " + rng.choice(_INM_VALUES))
        if rng.random() < 0.05:
            lines.append("If-None-Match: " + rng.choice(_INM_VALUES))  # dup
        if rng.random() < 0.1:
            lines.append("If-Modified-Since: Thu, 01 Jan 1970 00:00:00 GMT")
        if rng.random() < 0.1:
            lines.append("Etag-Md5: True")
        if rng.random() < 0.15:
            lines.append(
                "X-Weed-Trace: "
                + rng.choice(
                    ["0123456789abcdef0123456789abcdef:01234567:serve",
                     "garbage", "%s:%s:%s", ""]
                )
            )
        if rng.random() < 0.1:
            lines.append("Content-Length: " + rng.choice(["0", "00", "5"]))
        if rng.random() < 0.05:
            lines.append("Expect: 100-continue")
        if rng.random() < 0.05:
            lines.append("X-Fill: " + "a" * rng.randrange(1, 4000))
        head = "\r\n".join(lines).encode("latin-1", "replace") + b"\r\n\r\n"
        reqs.append(head)
    stream = b"".join(reqs)
    if rng.random() < 0.15 and len(stream) > 4:
        stream = stream[: rng.randrange(1, len(stream))]  # torn head/stream
    # fragment at random cut points so heads straddle recv() calls
    fragments: list[bytes] = []
    if rng.random() < 0.5:
        pos = 0
        while pos < len(stream):
            step = rng.randrange(1, max(2, min(len(stream) - pos + 1, 80)))
            fragments.append(stream[pos : pos + step])
            pos += step
    else:
        fragments = [stream]
    return {"fragments": fragments}


def case_to_json(case: dict) -> str:
    return json.dumps(
        {
            "fragments": [
                base64.b64encode(f).decode() for f in case["fragments"]
            ]
        },
        indent=0,
    )


def case_from_json(text: str) -> dict:
    obj = json.loads(text)
    return {
        "fragments": [base64.b64decode(f) for f in obj["fragments"]]
    }


def _case_name(case: dict, prefix: str) -> str:
    digest = hashlib.sha256(b"\x00".join(case["fragments"])).hexdigest()[:12]
    return f"{prefix}_{digest}.json"


# ---------------------------------------------------------------------------
# the identity oracle


def drive(port: int, case: dict, deadline_s: float = 5.0) -> bytes:
    """Play the case's fragments at 127.0.0.1:port (write side closed
    after the last fragment) and return every response byte."""
    s = socket.create_connection(("127.0.0.1", port), timeout=deadline_s)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, True)
    try:
        frags = case["fragments"]
        for i, frag in enumerate(frags):
            try:
                s.sendall(frag)
            except OSError:
                break  # server already slammed the door (431/garbage)
            if len(frags) > 1 and i % 3 == 2:
                time.sleep(0.002)  # force separate recv()s server-side
        try:
            s.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        out = b""
        end = time.monotonic() + deadline_s
        while time.monotonic() < end:
            s.settimeout(max(0.05, end - time.monotonic()))
            try:
                chunk = s.recv(1 << 20)
            except socket.timeout:
                break
            except OSError:
                break
            if not chunk:
                break
            out += chunk
        return out
    finally:
        s.close()


def run_case(pair: ServePair, case: dict) -> str | None:
    """None, or a divergence description. Drives the C arm first (a
    crash must implicate the native loop, not the control)."""
    c_bytes = drive(pair.c_port, case)
    py_bytes = drive(pair.py_port, case)
    if c_bytes != py_bytes:
        i = next(
            (k for k, (a, b) in enumerate(zip(c_bytes, py_bytes)) if a != b),
            min(len(c_bytes), len(py_bytes)),
        )
        return (
            f"response bytes diverge at offset {i}: "
            f"C[{len(c_bytes)}B]={c_bytes[max(0, i - 20) : i + 40]!r} "
            f"PY[{len(py_bytes)}B]={py_bytes[max(0, i - 20) : i + 40]!r}"
        )
    return None


@dataclass
class FuzzReport:
    iterations: int = 0
    divergences: list[str] = field(default_factory=list)
    corpus_written: list[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "iterations": self.iterations,
            "divergences": self.divergences,
            "corpus_written": self.corpus_written,
        }


def run(
    iterations: int = 100,
    seed: int = 0,
    corpus_dir: str | None = None,
    persist_divergent: bool = True,
) -> FuzzReport:
    rng = random.Random(seed)
    report = FuzzReport()
    corpus_dir = corpus_dir or DEFAULT_CORPUS
    os.makedirs(corpus_dir, exist_ok=True)
    pending = os.path.join(corpus_dir, f"pending_{seed}.json")
    with tempfile.TemporaryDirectory(prefix="weedfuzzserve") as workdir:
        pair = ServePair(workdir)
        try:
            if not pair.native_ok:
                return report  # no native loop on this host: nothing to diff
            for i in range(iterations):
                case = gen_case(rng, pair.fids)
                # persist BEFORE driving: a C crash leaves the repro
                with open(pending, "w", encoding="utf-8") as f:
                    f.write(case_to_json(case))
                report.iterations += 1
                divergence = run_case(pair, case)
                if divergence is not None:
                    report.divergences.append(
                        f"iter {i} (seed {seed}): {divergence}"
                    )
                    if persist_divergent:
                        name = _case_name(case, "div")
                        # weedlint: ignore[crash-rename-no-dirsync,crash-rename-unsynced-src] — forensic corpus artifact; persistence is best-effort and the fuzzer reruns
                        os.replace(
                            pending, os.path.join(corpus_dir, name)
                        )
                        report.corpus_written.append(name)
        finally:
            pair.close()
            try:
                os.remove(pending)
            except OSError:
                pass
    return report
