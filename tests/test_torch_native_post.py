"""The port's one-pass C POST (csrc/post.c through
write_path.try_native_post) against the port's Python write path
(write_path.build_upload_needle + Volume.write_needle) and against the
reference's C POST, on the CPU.

The port's C loop either DECLINES (and the Python path serves the
request) or leaves the exact .dat bytes, .idx bytes and HTTP reply body
the Python path leaves — and the reference's C loop leaves the same —
over the upload matrix the handlers support: raw bodies, multipart
with and without a filename, pre-gzipped payloads, ?ts=/?ttl= params,
Seaweed-* pairs, cm=true, and the decline triggers (gzippable text,
.jpg orientation, existing ids, non-ASCII names). The clock is pinned
in both packages. The tolerance is byte identity.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from seaweedfs_tpu.server import write_path as ref_write_path
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu.util.httpd import FastHeaders as RefHeaders
from seaweedfs_tpu_torch.server import write_path
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.util.httpd import FastHeaders

TS = "1700000000"  # pin ?ts= so last_modified is deterministic


def _pin_clock(monkeypatch):
    """Deterministic stamps: each Volume instance (of either package)
    gets its own tick sequence from the same base, so every path writes
    identical append_at_ns trailers, and time.time is frozen (so a
    no-?ts= case derives the same last_modified everywhere)."""
    import time as _time

    def now_ns(self):
        # pure function of volume state, like the real _now_ns (which
        # never mutates): a declined C attempt must not advance time
        return self.last_append_at_ns + 1

    monkeypatch.setattr(Volume, "_now_ns", now_ns)
    monkeypatch.setattr(RefVolume, "_now_ns", now_ns)
    monkeypatch.setattr(_time, "time", lambda: 1_700_000_123.0)


def _headers(d: dict, cls=FastHeaders):
    h = cls()
    for k, v in d.items():
        h[k.lower()] = v
    return h


def _python_write(v, fid, q: dict, body: bytes, headers, url_filename: str):
    n, fname, err = write_path.build_upload_needle(
        fid, q, body, headers, url_filename, fix_jpg_orientation=True
    )
    assert err is None, err
    _, size, _unchanged = v.write_needle(n)
    return size, (
        b'{"name": %s, "size": %d, "eTag": "%s"}'
        % (json.dumps(fname).encode(), size, n.etag().encode())
    )


def _fast_write(v, fid, q: dict, body: bytes, headers, url_filename: str,
                wp=write_path):
    return wp.try_native_post(
        v, fid, q, body, headers, url_filename, fix_jpg_orientation=True
    )


def _files(v) -> tuple[bytes, bytes]:
    with open(v.base_name + ".dat", "rb") as f:
        dat = f.read()
    with open(v.base_name + ".idx", "rb") as f:
        idx = f.read()
    return dat, idx


MP = (
    b"--BouNDary123\r\n"
    b'Content-Disposition: form-data; name="file"; filename="blob.bin"\r\n'
    b"Content-Type: application/x-custom\r\n"
    b"\r\n"
    b"\x00\x01\x02\xff\xfe binary payload \x80\x81" + bytes(range(256)) +
    b"\r\n--BouNDary123--\r\n"
)
MP_CT = "multipart/form-data; boundary=BouNDary123"

MP_NO_FILENAME = (
    b"--bnd\r\n"
    b'Content-Disposition: form-data; name="field"\r\n'
    b"\r\n"
    b"\x07\x08\x00raw field bytes\xff" + np.random.default_rng(5).bytes(64).replace(b"\x00", b"x") +
    b"\r\n--bnd--\r\n"
)

MP_GZ = (
    b"--bnd\r\n"
    b'Content-Disposition: form-data; name="f"; filename="log.txt"\r\n'
    b"Content-Type: text/plain\r\n"
    b"Content-Encoding: gzip\r\n"
    b"\r\n"
    b"\x1f\x8b\x08\x00fake-gzip-bytes-do-not-matter" + bytes(200) +
    b"\r\n--bnd--\r\n"
)

BIN = b"\x03\x80\xff" + bytes(range(255, 0, -1)) * 3  # never gzippable


CASES = [
    # (name, q, body, headers, url_filename, expect_fast)
    ("raw-bin", {"ts": TS}, BIN, {"content-type": "application/octet-stream"}, "", True),
    ("raw-no-ct", {"ts": TS}, BIN, {}, "", True),
    ("raw-url-name", {"ts": TS}, BIN, {}, "pic.bin", True),
    ("raw-query-name", {"ts": TS, "filename": "q.bin"}, BIN, {}, "u.bin", True),
    ("raw-gzipped", {"ts": TS}, b"\x1f\x8b\x08\x00" + bytes(500),
     {"content-encoding": "gzip", "content-type": "text/plain"}, "", True),
    ("raw-pairs", {"ts": TS}, BIN,
     {"seaweed-color": "blue", "seaweed-k2": "v2"}, "", True),
    ("raw-cm", {"ts": TS, "cm": "true"}, BIN, {}, "", True),
    ("mp-filename", {"ts": TS}, MP, {"content-type": MP_CT}, "", True),
    ("mp-no-filename", {"ts": TS}, MP_NO_FILENAME,
     {"content-type": "multipart/form-data; boundary=bnd"}, "", True),
    ("mp-part-gzipped", {"ts": TS}, MP_GZ,
     {"content-type": "multipart/form-data; boundary=bnd"}, "", True),
    ("mp-quoted-boundary", {"ts": TS},
     MP_NO_FILENAME,
     {"content-type": 'multipart/form-data; boundary="bnd"'}, "", True),
    # decline rows: the C path must hand these to Python untouched
    ("decline-gzippable-text", {"ts": TS}, b"compressible text " * 40,
     {"content-type": "text/plain"}, "", False),
    # mime-prefix rules are case-SENSITIVE like Python's startswith:
    # 'Image/svg' does NOT hit the image/ early-out, so a mostly-text
    # body falls to the sniff and Python compresses -> C must decline
    # (review finding: ci_prefix here silently stored raw bytes)
    ("decline-capital-image-mime", {"ts": TS},
     b"looks like text to the sniff " * 20,
     {"content-type": "Image/svg"}, "", False),
    # ...while the same capital trick on a BINARY body changes nothing
    # for either side: sniff says no, C handles it
    ("capital-text-mime-binary", {"ts": TS}, BIN,
     {"content-type": "Text/plain"}, "", True),
    # unterminated quoted filename: Python's regex falls back to the
    # token branch and keeps the opening quote in the stored name —
    # C must decline rather than invent a closing quote
    ("decline-unterminated-quote", {"ts": TS},
     b"--bnd\r\n"
     b'Content-Disposition: form-data; name="f"; filename="abc.bin\r\n'
     b"\r\n" + BIN + b"\r\n--bnd--\r\n",
     {"content-type": "multipart/form-data; boundary=bnd"}, "", False),
    ("decline-jpg", {"ts": TS}, BIN, {}, "photo.jpg", False),
    ("decline-ttl", {"ts": TS, "ttl": "5m"}, BIN, {}, "", False),
    ("decline-nonascii-name", {"ts": TS, "filename": "résumé"},
     BIN, {}, "", False),
    ("no-ts", {}, BIN, {}, "", True),  # wall-clock seconds: same second
]



class TestNativePostByteIdentity:
    @pytest.mark.parametrize(
        "name,q,body,hdrs,url_filename,expect_fast",
        CASES,
        ids=[c[0] for c in CASES],
    )
    def test_dat_idx_reply_identical(
        self, tmp_path, monkeypatch, name, q, body, hdrs, url_filename,
        expect_fast
    ):
        """The port's C path (or, where it declines, its Python path)
        against the port's Python path and the reference's C path."""
        _pin_clock(monkeypatch)
        for d in ("c", "py", "ref"):
            (tmp_path / d).mkdir()
        vc = Volume(str(tmp_path / "c"), 1)
        vp = Volume(str(tmp_path / "py"), 1)
        vr = RefVolume(str(tmp_path / "ref"), 1)
        fid = FileId(1, 0x1234, 0xCAFE)
        try:
            fast = _fast_write(vc, fid, q, body, _headers(hdrs), url_filename)
            if fast is None:
                assert not expect_fast, f"{name}: C path unexpectedly declined"
                # declined: the Python path serves the request on volume C
                _size, fast = _python_write(vc, fid, q, body, _headers(hdrs), url_filename)
            else:
                assert expect_fast, f"{name}: expected decline, C handled it"
            _size, py_reply = _python_write(vp, fid, q, body, _headers(hdrs), url_filename)
            ref = _fast_write(vr, fid, q, body, _headers(hdrs, RefHeaders), url_filename,
                              wp=ref_write_path)
            assert (ref is None) == (not expect_fast), f"{name}: the reference's C path differs"
            files = {k: _files(v) for k, v in (("c", vc), ("py", vp), ("ref", vr))}
            assert files["c"][1] == files["py"][1], f"{name}: .idx diverged"
            assert files["c"][0] == files["py"][0], f"{name}: .dat diverged"
            assert fast == py_reply, f"{name}: reply diverged"
            if ref is not None:
                assert files["c"] == files["ref"], f"{name}: .dat/.idx diverged from the reference"
                assert fast == ref, f"{name}: reply diverged from the reference"
        finally:
            for v in (vc, vp, vr):
                v.close()

    def test_fast_path_actually_engaged(self, tmp_path, monkeypatch):
        """A control: the hot case must NOT silently decline (a decline
        bug would turn this suite into Python-vs-Python tautology)."""
        _pin_clock(monkeypatch)
        v = Volume(str(tmp_path), 7)
        try:
            fid = FileId(7, 1, 2)
            reply = _fast_write(v, fid, {"ts": TS}, BIN, _headers({}), "")
            assert reply is not None
            assert json.loads(reply)["size"] > 0
            # and the stored needle reads back with a passing CRC
            n = v.read_needle(1, cookie=2)
            assert bytes(n.data) == BIN
        finally:
            v.close()

    def test_existing_id_declines_to_python(self, tmp_path, monkeypatch):
        """Overwrite semantics (cookie check, dedup) belong to Python."""
        _pin_clock(monkeypatch)
        v = Volume(str(tmp_path), 7)
        try:
            fid = FileId(7, 1, 2)
            h = _headers({})
            assert _fast_write(v, fid, {"ts": TS}, BIN, h, "") is not None
            assert _fast_write(v, fid, {"ts": TS}, BIN, h, "") is None
        finally:
            v.close()

    def test_kill_switch(self, tmp_path, monkeypatch):
        _pin_clock(monkeypatch)
        monkeypatch.setattr(write_path, "NATIVE_POST_ENABLED", False)
        v = Volume(str(tmp_path), 7)
        try:
            assert _fast_write(v, FileId(7, 1, 2), {}, BIN, _headers({}), "") is None
        finally:
            v.close()


class TestStageNameIdentity:
    """Tracing plane: the C hot loop and the Python path emit the SAME
    write-path stage names (write_path.WRITE_STAGES), the reference's."""

    def test_c_and_python_stage_names_identical(self, tmp_path, monkeypatch):
        _pin_clock(monkeypatch)
        (tmp_path / "c").mkdir()
        (tmp_path / "py").mkdir()
        fid = FileId(1, 0x42, 0xCAFE)
        h = _headers({})

        vc = Volume(str(tmp_path / "c"), 1)
        c_stages: dict = {}
        try:
            reply = write_path.try_native_post(
                vc, fid, {"ts": TS}, BIN, h, "", stages=c_stages
            )
            assert reply is not None  # the C path must have served this
        finally:
            vc.close()

        vp = Volume(str(tmp_path / "py"), 1)
        py_stages: dict = {}
        try:
            n, _fname, err = write_path.build_upload_needle(
                fid, {"ts": TS}, BIN, h, "", stages=py_stages
            )
            assert err is None
            vp.write_needle(n, stages=py_stages)
            py_stages["reply"] = 0.0  # reply formatting is the handler's stage
        finally:
            vp.close()

        assert set(c_stages) == set(write_path.WRITE_STAGES)
        assert set(py_stages) == set(write_path.WRITE_STAGES)
        # C stage values are real (non-negative, pwrite non-zero)
        assert all(v >= 0 for v in c_stages.values())
        assert c_stages["pwrite"] > 0

    def test_stage_order_matches_declaration(self):
        assert write_path.WRITE_STAGES == ref_write_path.WRITE_STAGES == (
            "parse", "assemble", "crc", "pwrite", "reply"
        )


class TestServerPostIdentity:
    """The POST handler end to end: the same uploads to a live port
    server on the C POST and to one with WEED_NATIVE_POST=0 leave the
    same .dat, .idx and replies (the port's counterpart of the
    reference's one-write `bench.py --check` smoke)."""

    def test_server_c_post_equals_python_post(self, tmp_path, monkeypatch):
        import urllib.request

        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.util.availability import free_port

        _pin_clock(monkeypatch)
        rng = np.random.default_rng(13)
        bodies = [rng.bytes(int(n)) for n in rng.integers(1, 5000, 12)]
        served = []
        real = write_path.try_native_post

        def counting(*args, **kwargs):
            reply = real(*args, **kwargs)
            served.append(reply is not None)
            return reply

        monkeypatch.setattr(write_path, "try_native_post", counting)
        out = {}
        for arm, native in (("c", True), ("py", False)):
            monkeypatch.setattr(write_path, "NATIVE_POST_ENABLED", native)
            d = tmp_path / arm
            d.mkdir()
            vs = VolumeServer([str(d)], port=free_port(), device="cpu", scrub_interval=0)
            vs.store.add_volume(3, "", "000", "")
            vs.start()
            try:
                replies = []
                for i, body in enumerate(bodies):
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{vs.port}/3,{i + 1:x}0000abcd?ts={TS}",
                        data=body, method="POST",
                        headers={"Content-Type": "application/octet-stream"},
                    )
                    with urllib.request.urlopen(req, timeout=10) as r:
                        replies.append((r.status, r.read()))
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{vs.port}/3,{1:x}0000abcd", timeout=10
                ) as r:
                    assert r.read() == bodies[0]
                out[arm] = (replies, _files(vs.store.find_volume(3)))
            finally:
                vs.stop()
        assert out["c"] == out["py"]
        # the C arm took the C path for every write, the other arm never
        assert served == [True] * len(bodies) + [False] * len(bodies)
