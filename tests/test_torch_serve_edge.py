"""The port's serving edge beyond plain identity, on the CPU: the
conditional-GET matrix served from C, the plan cache's invalidation,
and the shared-memory admission bucket (from the reference's
tests/test_serve_syscall_floor.py; its syscall counter waits for the
bench).

1. Conditional-GET identity — every If-None-Match form (exact, weak,
   list, `*`, no-match, malformed) gives byte-identical replies from
   the port's C loop, the port's threaded arm and the reference's C
   loop; If-None-Match beats Range; flag-bearing needles (name/mime)
   get Content-Type/Content-Disposition from every arm — with the
   port's C arm shown to have served natively (its served and
   not_modified counters move, its handoffs do not).

2. Plan-cache invalidation — overwrites and vacuum fd-swaps bump the
   generation counter, so a GET hammering the C fast path through a
   concurrent compaction never serves stale bytes.

3. Shared-memory admission — one mmap'd GCRA bucket arbitrates every
   attached process: cold-burst exactness, the sustained rate within
   +-10% under a fully skewed charge pattern, a second process does
   NOT get its own burst, and the C shed reply equals the Python
   gate's once the time-dependent Retry-After value is normalized.
"""

from __future__ import annotations

import http.client
import os
import re
import subprocess
import sys
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest

from seaweedfs_tpu.analysis import fuzz_serve as ref_fuzz
from seaweedfs_tpu_torch.analysis import fuzz_serve
from seaweedfs_tpu_torch.util import native_serve

SMALL_ETAG = "067c9745"  # deterministic ETag of ServePair's `small`


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = fuzz_serve.ServePair(str(tmp_path_factory.mktemp("edgepair")))
    yield p
    p.close()


@pytest.fixture(scope="module")
def ref_pair(tmp_path_factory):
    p = ref_fuzz.ServePair(str(tmp_path_factory.mktemp("refedgepair")))
    assert p.native_ok, "the reference's C serving loop did not build"
    yield p
    p.close()


def _req(path: str, *headers: str, method: str = "GET") -> bytes:
    head = f"{method} /{path} HTTP/1.1\r\n"
    head += "".join(h + "\r\n" for h in headers)
    return (head + "\r\n").encode()


def _stats() -> dict:
    s = native_serve.serve_stats()
    return {
        k: s.get(k, 0)
        for k in ("served", "not_modified", "handoffs", "cache_hits", "shed")
    }


def _both(pair, payload: bytes) -> tuple[bytes, bytes]:
    """(port C loop, port threaded arm) replies."""
    case = {"fragments": [payload]}
    return (
        fuzz_serve.drive(pair.c_port, case),
        fuzz_serve.drive(pair.py_port, case),
    )


def _three(pair, ref_pair, payload: bytes) -> tuple[bytes, bytes]:
    """(port C, port threaded) replies, the port's C reply asserted
    equal to the reference C loop's."""
    c, py = _both(pair, payload)
    assert c == fuzz_serve.drive(ref_pair.c_port, {"fragments": [payload]}), \
        "port C loop vs reference C loop"
    return c, py


# ---------------------------------------------------------------------------
# 1. conditional-GET identity matrix


class TestConditionalIdentity:
    @pytest.mark.parametrize(
        "name,headers,status",
        [
            ("exact", [f'If-None-Match: "{SMALL_ETAG}"'], 304),
            ("weak", [f'If-None-Match: W/"{SMALL_ETAG}"'], 304),
            ("list", [f'If-None-Match: "a", "b", "{SMALL_ETAG}"'], 304),
            ("star", ["If-None-Match: *"], 304),
            ("nomatch", ['If-None-Match: "zz"'], 200),
            ("empty", ["If-None-Match: "], 200),
            ("malformed", [f'If-None-Match: "{SMALL_ETAG}'], 200),
            ("bare_token", [f"If-None-Match: {SMALL_ETAG}"], 200),
            (
                "inm_beats_range",
                ["Range: bytes=0-9", f'If-None-Match: "{SMALL_ETAG}"'],
                304,
            ),
            ("range_only", ["Range: bytes=0-9"], 206),
        ],
    )
    def test_inm_matrix_stays_in_c(self, pair, ref_pair, name, headers, status):
        before = _stats()
        c, py = _three(pair, ref_pair, _req(pair.fids["small"], *headers))
        after = _stats()
        assert c == py, f"{name}: arms diverge"
        assert c.startswith(f"HTTP/1.1 {status} ".encode()), c[:40]
        assert after["handoffs"] == before["handoffs"], (
            f"{name}: C arm handed off instead of serving natively"
        )
        moved = ("not_modified",) if status == 304 else ("served",)
        for key in moved:
            assert after[key] > before[key], f"{name}: {key} did not move"
        if status == 304:
            # a 304 never carries a body
            assert c.partition(b"\r\n\r\n")[2] == b""
            assert b"Content-Length: 0" in c

    def test_head_with_matching_inm(self, pair, ref_pair):
        before = _stats()
        c, py = _both(
            pair,
            _req(
                pair.fids["small"],
                f'If-None-Match: "{SMALL_ETAG}"',
                method="HEAD",
            ),
        )
        after = _stats()
        assert c == py
        assert c.startswith(b"HTTP/1.1 304 ")
        assert after["handoffs"] == before["handoffs"]

    def test_named_needle_served_from_c_with_disposition(self, pair, ref_pair):
        before = _stats()
        c, py = _three(pair, ref_pair, _req(pair.fids["named"]))
        after = _stats()
        assert c == py
        head = c.partition(b"\r\n\r\n")[0]
        assert b'Content-Disposition: inline; filename="f.bin"' in head
        assert b"Content-Type: application/octet-stream" in head
        assert c.endswith(b"named blob")
        assert after["handoffs"] == before["handoffs"]
        assert after["served"] > before["served"]

    def test_mime_needle_served_from_c_with_content_type(self, pair, ref_pair):
        before = _stats()
        c, py = _three(pair, ref_pair, _req(pair.fids["mime"]))
        after = _stats()
        assert c == py
        assert b"Content-Type: text/html" in c.partition(b"\r\n\r\n")[0]
        assert after["handoffs"] == before["handoffs"]

    def test_flagged_needle_conditional_stays_in_c(self, pair, ref_pair):
        before = _stats()
        c, py = _three(pair, ref_pair, _req(pair.fids["named"], "If-None-Match: *"))
        after = _stats()
        assert c == py
        assert c.startswith(b"HTTP/1.1 304 ")
        assert after["not_modified"] > before["not_modified"]
        assert after["handoffs"] == before["handoffs"]

    def test_conditional_gets_hit_the_plan_cache(self, pair, ref_pair):
        payload = _req(pair.fids["small"], f'If-None-Match: "{SMALL_ETAG}"')
        assert pair.fids["small"] == ref_pair.fids["small"]
        fuzz_serve.drive(pair.c_port, {"fragments": [payload]})
        before = _stats()
        out = fuzz_serve.drive(pair.c_port, {"fragments": [payload]})
        after = _stats()
        assert out.startswith(b"HTTP/1.1 304 ")
        assert after["cache_hits"] > before["cache_hits"], (
            "second conditional GET should reuse the cached plan"
        )

    def test_pipelined_mixed_conditionals(self, pair, ref_pair):
        stream = (
            _req(pair.fids["small"], f'If-None-Match: "{SMALL_ETAG}"')
            + _req(pair.fids["small"])
            + _req(pair.fids["named"], "If-None-Match: *")
            + _req(pair.fids["mime"])
            + _req(pair.fids["small"], 'If-None-Match: "zz"',
                   "Connection: close")
        )
        before = _stats()
        c, py = _three(pair, ref_pair, stream)
        after = _stats()
        assert c == py
        assert c.count(b"HTTP/1.1 304 ") == 2
        assert c.count(b"HTTP/1.1 200 ") == 3
        assert after["handoffs"] == before["handoffs"]


# ---------------------------------------------------------------------------
# 2. fd/offset-cache invalidation


class TestFdCacheInvalidation:
    def test_overwrite_invalidates_cached_plan(self, pair):
        from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
        from seaweedfs_tpu_torch.storage.needle import Needle

        v = pair.vs.store.find_volume(1)
        n = Needle(cookie=0xCAFE01, id=60, data=b"first body")
        v.write_needle(n)
        fid = f"1,{format_needle_id_cookie(60, 0xCAFE01)}"
        payload = _req(fid)
        c1, py1 = _both(pair, payload)
        assert c1 == py1 and c1.endswith(b"first body")
        n2 = Needle(cookie=0xCAFE01, id=60, data=b"second body, longer")
        v.write_needle(n2)
        c2, py2 = _both(pair, payload)
        assert c2 == py2
        assert c2.endswith(b"second body, longer"), (
            "C arm served a stale cached plan after overwrite"
        )

    def test_vacuum_fd_swap_invalidates(self, pair):
        payload = _req(pair.fids["small"])
        c1, _ = _both(pair, payload)
        v = pair.vs.store.find_volume(1)
        gen_before = native_serve.generation()
        v.compact()
        v.commit_compact()
        assert native_serve.generation() > gen_before
        c2, py2 = _both(pair, payload)
        assert c2 == py2
        assert c2 == c1, "same needle must serve identically across vacuum"

    def test_concurrent_vacuum_never_serves_stale(self, pair):
        from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
        from seaweedfs_tpu_torch.storage.needle import Needle

        v = pair.vs.store.find_volume(1)
        body = np.random.default_rng(61).bytes(4096)
        v.write_needle(Needle(cookie=0xCAFE02, id=61, data=body))
        # a tombstone ahead of id 61 so compaction shifts its offset
        v.write_needle(Needle(cookie=0xCAFE03, id=62, data=b"x" * 2048))
        v.delete_needle(Needle(cookie=0xCAFE03, id=62))
        fid = f"1,{format_needle_id_cookie(61, 0xCAFE02)}"
        stop = threading.Event()
        errors: list[bytes] = []

        def hammer():
            # one keep-alive connection: plain GETs stay on the C fast
            # path, and a connection a GET would leave a TIME_WAIT socket
            # on an ephemeral port thousands of times over
            conn = http.client.HTTPConnection("127.0.0.1", pair.c_port, timeout=10)
            try:
                while not stop.is_set():
                    conn.request("GET", f"/{fid}")
                    r = conn.getresponse()
                    out = r.read()
                    if r.status != 200 or out != body:
                        errors.append(out[:200])
                        stop.set()
                        return
            finally:
                conn.close()

        before = _stats()
        t = threading.Thread(target=hammer)
        t.start()
        try:
            deadline = time.monotonic() + 3.0
            while time.monotonic() < deadline and not stop.is_set():
                v.compact()
                v.commit_compact()
                time.sleep(0.02)
        finally:
            stop.set()
            t.join()
        assert not errors, (
            f"stale/failed reads during concurrent vacuum: {errors[:2]}"
        )
        after = _stats()
        assert after["served"] > before["served"]
        assert after["handoffs"] == before["handoffs"]


# ---------------------------------------------------------------------------
# 3. shared-memory admission


@contextmanager
def _shm_bucket(path: str, rate: float, burst: float, retry: float = 0.5):
    """Attach-once is process-global: tear down whatever mapping an
    earlier test (or controller) left behind, attach fresh, detach
    after so later tests see a clean slate."""
    native_serve.admission_shm_detach()
    assert native_serve.admission_shm_attach(path, rate, burst, retry)
    try:
        yield
    finally:
        native_serve.admission_shm_detach()


class TestSharedAdmission:
    def test_cold_burst_exactness_and_windowed_rate(self, pair, tmp_path):
        rate, burst = 50.0, 10.0
        with _shm_bucket(str(tmp_path / "adm.tb"), rate, burst):
            admit = native_serve.admission_shm_admit
            cold = sum(1 for _ in range(40) if admit("tenant-a") == 0.0)
            assert cold == int(burst), (
                f"cold bucket admitted {cold}, want exactly {burst:.0f}"
            )
            # fully-skewed sustained load: every charge from this one
            # sibling; the GLOBAL rate must hold within ±10%
            t0 = time.monotonic()
            admitted = polls = 0
            while time.monotonic() - t0 < 1.0:
                if admit("tenant-a") == 0.0:
                    admitted += 1
                polls += 1
                time.sleep(0.0005)
            elapsed = time.monotonic() - t0
            expect = rate * elapsed
            # high side is the contract — the GLOBAL rate cap holds
            assert admitted <= 1.1 * expect + 1, (
                f"admitted {admitted} over {elapsed:.2f}s, "
                f"cap is {expect:.1f} +10%"
            )
            # low side degrades with poll granularity: a token frees
            # every 1/rate seconds but is only CLAIMED at the next
            # poll, so the achievable rate is 1/(1/rate + gap).
            # Sanitizer builds stretch the per-poll cost; deriving the
            # bound from the measured gap keeps the assertion exact on
            # fast builds and honest on instrumented ones.
            gap = elapsed / max(polls, 1)
            reachable = elapsed / (1.0 / rate + gap)
            assert admitted >= 0.9 * min(expect, reachable) - 1, (
                f"admitted {admitted} over {elapsed:.2f}s "
                f"({polls} polls), expected >= 90% of "
                f"{min(expect, reachable):.1f}"
            )
            # a different tenant still gets its own full burst
            other = sum(1 for _ in range(40) if admit("tenant-b") == 0.0)
            assert other == int(burst)

    def test_second_process_shares_the_bucket(self, pair, tmp_path):
        shm = str(tmp_path / "adm.tb")
        rate, burst = 5.0, 30.0
        with _shm_bucket(shm, rate, burst):
            admit = native_serve.admission_shm_admit
            t0 = time.monotonic()
            local = sum(1 for _ in range(60) if admit("tenant") == 0.0)
            assert local == int(burst)
            # a sibling attaching the same file must NOT get a fresh
            # burst: its admits are bounded by refill over its lifetime
            child = subprocess.run(
                [
                    sys.executable,
                    "-c",
                    "import sys\n"
                    "from seaweedfs_tpu_torch.util import native_serve as ns\n"
                    "assert ns.admission_shm_attach("
                    f"{shm!r}, {rate}, {burst}, 0.5)\n"
                    "print(sum(1 for _ in range(60)"
                    " if ns.admission_shm_admit('tenant') == 0.0))\n",
                ],
                cwd=os.path.dirname(os.path.dirname(__file__)),
                capture_output=True,
                text=True,
                timeout=120,
            )
            assert child.returncode == 0, child.stderr[-2000:]
            child_admits = int(child.stdout.strip())
            elapsed = time.monotonic() - t0
            budget = burst + rate * elapsed
            total = local + child_admits
            assert total <= budget + 1, (
                f"{total} admits exceed the shared budget {budget:.1f} "
                f"(child got its own burst?)"
            )
            assert child_admits < burst, (
                "child process was granted a full fresh burst — the "
                "bucket is not shared"
            )

    def test_c_shed_reply_matches_python_gate(self, pair, tmp_path):
        from seaweedfs_tpu_torch.qos.admission import AdmissionController
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
        from seaweedfs_tpu_torch.storage.needle import Needle
        from seaweedfs_tpu_torch.util.httpd import WeedHTTPServer

        native_serve.admission_shm_detach()
        vol_dir = str(tmp_path / "vols")
        os.makedirs(vol_dir)
        vs = VolumeServer([vol_dir], port=0, scrub_interval=0, device="cpu")
        servers = []
        try:
            vs.store.add_volume(1, "", "000", "")
            v = vs.store.find_volume(1)
            v.write_needle(Needle(cookie=0x1, id=1, data=b"hello"))
            fid = f"1,{format_needle_id_cookie(1, 0x1)}"
            # rate ~0: one burst token, then everything sheds with a
            # deterministic huge Retry-After
            adm = AdmissionController(
                rate=0.000001,
                burst=1.0,
                label="t",
                retry_after_s=1.0,
                shm_path=str(tmp_path / "adm.tb"),
            )
            assert adm.shared, "shm attach failed"
            handler = vs._http_handler_class()
            resolver = vs._make_fast_resolver()
            ports = []
            # admission must be installed BEFORE serve_forever: the C
            # loop latches it at loop start (mid-run flips need restart)
            for native in (True, False):
                srv = WeedHTTPServer(("127.0.0.1", 0), handler)
                srv.trace_name = "volume"
                srv.trace_node = "t"
                srv.fast_resolver = resolver
                srv.native_serve = native
                srv.admission = adm
                threading.Thread(
                    target=srv.serve_forever, daemon=True
                ).start()
                servers.append(srv)
                ports.append(srv.server_address[1])
            for srv in servers:
                srv.wait_armed()
            c_port, py_port = ports
            req = _req(fid)
            before = _stats()
            out_c = fuzz_serve.drive(c_port, {"fragments": [req * 3]})
            after = _stats()
            assert out_c.count(b"HTTP/1.1 200 ") == 1
            assert out_c.count(b"HTTP/1.1 503 ") == 2
            assert after["shed"] - before["shed"] == 2, (
                "C loop should shed natively, not hand off"
            )
            assert after["handoffs"] == before["handoffs"]
            out_py = fuzz_serve.drive(py_port, {"fragments": [req]})
            assert out_py.count(b"HTTP/1.1 503 ") == 1
            # Retry-After carries the GCRA wait — time-dependent digits,
            # normalize before comparing the shed bytes
            norm = lambda b: re.sub(  # noqa: E731
                rb"Retry-After: [0-9.]+", b"Retry-After: X", b
            )
            shed_c = norm(out_c[out_c.index(b"HTTP/1.1 503 "):])
            shed_py = norm(out_py)
            assert shed_c.startswith(shed_py), (
                f"shed replies diverge:\nC : {shed_c[:220]!r}\n"
                f"PY: {shed_py[:220]!r}"
            )
            assert b'{"error": "admission control: over per-client budget"}' \
                in shed_py
        finally:
            for srv in servers:
                srv.shutdown()
                srv.server_close()
            vs.store.close()
            native_serve.admission_shm_detach()

    def test_controller_falls_back_without_shm(self, tmp_path):
        from seaweedfs_tpu_torch.qos.admission import AdmissionController

        native_serve.admission_shm_detach()
        adm = AdmissionController(rate=100.0, burst=10.0, procs=4, label="t")
        assert not adm.shared
        assert adm.rate == pytest.approx(25.0)  # legacy rate/N split
        shared = AdmissionController(
            rate=100.0,
            burst=10.0,
            procs=4,
            label="t",
            shm_path=str(tmp_path / "adm.tb"),
        )
        try:
            assert shared.shared
            assert shared.rate == pytest.approx(100.0)  # global, no /N
            assert shared.status()["Shared"] is True
        finally:
            native_serve.admission_shm_detach()

    def test_unattachable_bucket_raises(self, tmp_path):
        """A shared bucket that cannot be mapped raises: a quiet
        per-process split would admit the group's size times the rate."""
        from seaweedfs_tpu_torch.qos.admission import AdmissionController

        native_serve.admission_shm_detach()
        with pytest.raises(OSError):
            AdmissionController(
                rate=100.0, burst=10.0, procs=4, label="t",
                shm_path=str(tmp_path / "no-such-dir" / "adm.tb"),
            )
