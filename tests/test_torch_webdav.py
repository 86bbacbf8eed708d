"""The port's WebDAV gateway (seaweedfs_tpu_torch/webdav/) against
seaweedfs_tpu's, on the CPU.

tests/test_webdav.py ported: a master, a volume server, a filer and a
WebDAV gateway of each package in this process, module-scoped (the
port's volume server runs the kernels' plain versions, device="cpu").
Each case sends the same requests, bodies drawn with numpy, to both
gateways: the statuses, the DAV headers (DAV, Allow, MS-Author-Via,
Content-Type, Content-Range, Accept-Ranges, Lock-Token), the bodies, and
the multistatus XML parsed and normalised (namespaces stripped, the
last-modified times and lock tokens masked) are equal, and each meets
the reference test's expectation.

Port cases: WebDavServer.start() raises when the C serving loop cannot
arm; stop() leaves no thread of its own alive and releases its hold on
the sampling profiler; `webdav -serveProcs 2` puts two listeners on one
port and SIGTERM to the lead reaps its sibling, exit code 0. The
smoke's phase 3l (chip_smoke.run_webdav_tier_phase) runs at 24 MiB on
the host codec, every kernel on its plain version. The tolerance
everywhere is exact equality.
"""

import contextlib
import http.client
import importlib
import os
import pathlib
import re
import signal
import subprocess
import sys
import threading
import time
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from seaweedfs_tpu_torch.util.availability import free_port

SIDES = ("ref", "port")
PKG = {"ref": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}
REPO = pathlib.Path(__file__).resolve().parent.parent
KEEP = ("DAV", "Allow", "MS-Author-Via", "Content-Type", "Content-Range",
        "Accept-Ranges", "Lock-Token")


def mod(side, name):
    return importlib.import_module(f"{PKG[side]}.{name}")


def wait_for(cond, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


class Stack:
    """A master, one volume server, a memory filer and a WebDAV gateway,
    all of one package."""

    def __init__(self, side, root):
        self.started = []
        try:
            self.master = mod(side, "server.master_server").MasterServer(
                port=free_port(), volume_size_limit_mb=64)
            self._start(self.master)
            kw = dict(ec_codec="cpu") if side == "ref" else dict(ec_codec="cuda", device="cpu")
            vol_dir = os.path.join(root, f"{side}-vol")
            os.makedirs(vol_dir)
            self.volume = mod(side, "server.volume_server").VolumeServer(
                [vol_dir], port=free_port(), master=f"127.0.0.1:{self.master.port}",
                heartbeat_interval=0.2, max_volume_counts=[20], scrub_interval=0, **kw)
            self._start(self.volume)
            assert wait_for(lambda: self.master.topology.data_nodes())
            self.filer = mod(side, "server.filer_server").FilerServer(
                [f"127.0.0.1:{self.master.port}"], port=free_port(), store="memory")
            self._start(self.filer)
            self.dav = mod(side, "webdav.webdav_server").WebDavServer(
                filer=f"127.0.0.1:{self.filer.port}", port=free_port())
            self._start(self.dav)
        except BaseException:
            self.stop()
            raise

    def _start(self, daemon):
        daemon.start()
        self.started.append(daemon)

    def stop(self):
        for d in reversed(self.started):
            d.stop()
        self.started = []


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dav-stacks"))
    out = {}
    try:
        for side in SIDES:
            out[side] = Stack(side, root)
        yield out
    finally:
        for st in out.values():
            st.stop()


def dav_req(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=15)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def strip_ns(root):
    for el in root.iter():
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]
    return root


def _normal(body: bytes):
    """An XML body parsed, namespaces stripped, times and lock tokens
    masked, serialised again; any other body as it is."""
    if not body.startswith(b"<?xml"):
        return body
    root = strip_ns(ET.fromstring(body))
    for el in root.iter("getlastmodified"):
        el.text = "T"
    for el in root.iter("locktoken"):
        for href in el.iter("href"):
            href.text = "TOKEN"
    return ET.tostring(root)


def view(reply):
    """(status, kept headers, normalised body) of one reply."""
    status, body, headers = reply
    kept = {k: headers[k] for k in KEEP if k in headers}
    if "Lock-Token" in kept:
        kept["Lock-Token"] = re.sub(r"[0-9a-f]+>$", "X>", kept["Lock-Token"])
    return status, kept, _normal(body)


def _each(stacks, script):
    """script(port) -> [raw replies] on each package's gateway; the
    replies' views are equal. Returns the port's raw replies."""
    raw = {side: script(stacks[side].dav.port) for side in SIDES}
    assert [view(r) for r in raw["port"]] == [view(r) for r in raw["ref"]]
    return raw["port"]


def _bytes(seed, n):
    return np.random.default_rng(seed).bytes(n)


class TestWebDav:
    def test_options_advertises_dav(self, stacks):
        (status, _, headers), = _each(stacks, lambda p: [dav_req(p, "OPTIONS", "/")])
        assert status == 200
        assert "1,2" in headers["DAV"]
        assert "PROPFIND" in headers["Allow"]

    def test_mkcol_put_get(self, stacks):
        body = _bytes(1, 777)

        def script(p):
            return [dav_req(p, "MKCOL", "/docs"), dav_req(p, "MKCOL", "/docs"),
                    dav_req(p, "PUT", "/docs/readme.txt", body=body,
                            headers={"Content-Type": "text/plain"}),
                    dav_req(p, "GET", "/docs/readme.txt"), dav_req(p, "GET", "/docs")]
        mk, again, put, get, listing = _each(stacks, script)
        assert (mk[0], again[0], put[0]) == (201, 405, 201)
        assert get[0] == 200 and get[1] == body and get[2]["Content-Type"] == "text/plain"
        assert listing[1] == b"readme.txt"

    def test_propfind_depth(self, stacks):
        def script(p):
            dav_req(p, "MKCOL", "/tree")
            dav_req(p, "PUT", "/tree/a.bin", body=_bytes(2, 5))
            dav_req(p, "PUT", "/tree/b.bin", body=_bytes(3, 2))
            dav_req(p, "MKCOL", "/tree/sub")
            return [dav_req(p, "PROPFIND", "/tree", headers={"Depth": "1"}),
                    dav_req(p, "PROPFIND", "/tree", headers={"Depth": "0"}),
                    dav_req(p, "PROPFIND", "/tree/a.bin", headers={"Depth": "1"})]
        one, zero, leaf = _each(stacks, script)
        assert one[0] == 207
        root = strip_ns(ET.fromstring(one[1]))
        hrefs = [r.findtext("href") for r in root.iter("response")]
        assert hrefs == ["/tree/", "/tree/a.bin", "/tree/b.bin", "/tree/sub/"]
        sizes = {r.findtext("href"): r.findtext("propstat/prop/getcontentlength")
                 for r in root.iter("response")}
        assert sizes["/tree/a.bin"] == "5"
        root = strip_ns(ET.fromstring(zero[1]))
        assert len(list(root.iter("response"))) == 1
        assert root.find("response/propstat/prop/resourcetype/collection") is not None
        assert len(list(strip_ns(ET.fromstring(leaf[1])).iter("response"))) == 1

    def test_propfind_missing_404(self, stacks):
        (status, _, _), = _each(stacks, lambda p: [
            dav_req(p, "PROPFIND", "/nope", headers={"Depth": "0"})])
        assert status == 404

    def test_move(self, stacks):
        body = _bytes(4, 300)

        def script(p):
            dav_req(p, "MKCOL", "/mv")
            dav_req(p, "PUT", "/mv/old.txt", body=body)
            dav_req(p, "PUT", "/mv/other.txt", body=b"x")
            return [dav_req(p, "MOVE", "/mv/old.txt", headers={"Destination": "/mv/new.txt"}),
                    dav_req(p, "GET", "/mv/new.txt"), dav_req(p, "GET", "/mv/old.txt"),
                    dav_req(p, "MOVE", "/mv/new.txt",
                            headers={"Destination": f"http://127.0.0.1:{p}/mv/other.txt"}),
                    dav_req(p, "MOVE", "/mv/gone.txt", headers={"Destination": "/mv/x"})]
        moved, new, old, over, missing = _each(stacks, script)
        assert moved[0] == 201 and new[1] == body and old[0] == 404
        assert over[0] == 204 and missing[0] == 404

    def test_copy(self, stacks):
        body = _bytes(5, 4000)

        def script(p):
            dav_req(p, "MKCOL", "/cp")
            dav_req(p, "PUT", "/cp/src.txt", body=body)
            return [dav_req(p, "COPY", "/cp/src.txt", headers={"Destination": "/cp/dst.txt"}),
                    dav_req(p, "GET", "/cp/dst.txt"), dav_req(p, "GET", "/cp/src.txt"),
                    dav_req(p, "COPY", "/cp/src.txt", headers={"Destination": "/cp/dst.txt"}),
                    dav_req(p, "COPY", "/cp", headers={"Destination": "/cp2"})]
        first, dst, src, again, coll = _each(stacks, script)
        assert first[0] == 201 and dst[1] == src[1] == body
        assert again[0] == 204 and coll[0] == 501

    def test_delete(self, stacks):
        def script(p):
            dav_req(p, "MKCOL", "/rm")
            dav_req(p, "PUT", "/rm/f.txt", body=b"bye")
            out = [dav_req(p, "DELETE", "/rm/f.txt"), dav_req(p, "GET", "/rm/f.txt")]
            dav_req(p, "PUT", "/rm/deep.txt", body=b"x")
            return out + [dav_req(p, "DELETE", "/rm"),
                          dav_req(p, "PROPFIND", "/rm", headers={"Depth": "0"}),
                          dav_req(p, "DELETE", "/rm")]
        gone, get, coll, find, again = _each(stacks, script)
        assert (gone[0], get[0], coll[0], find[0], again[0]) == (204, 404, 204, 404, 404)

    def test_lock_unlock(self, stacks):
        def script(p):
            dav_req(p, "PUT", "/locked.txt", body=b"v1")
            return [dav_req(p, "LOCK", "/locked.txt"), dav_req(p, "UNLOCK", "/locked.txt"),
                    dav_req(p, "PROPPATCH", "/locked.txt", body=b"<x/>")]
        lock, unlock, patch = _each(stacks, script)
        assert lock[0] == 200 and "opaquelocktoken" in lock[2]["Lock-Token"]
        assert unlock[0] == 204 and patch[0] == 207


def test_ranged_get(stacks):
    """WebDAV forwards Range to the filer (video seeks, resumable copies),
    and HEAD passes through as HEAD."""
    payload = _bytes(6, 2048)

    def script(p):
        return [dav_req(p, "PUT", "/r.bin", body=payload),
                dav_req(p, "GET", "/r.bin", headers={"Range": "bytes=100-199"}),
                dav_req(p, "GET", "/r.bin", headers={"Range": "bytes=5000-"}),
                dav_req(p, "HEAD", "/r.bin")]
    put, ranged, past, head = _each(stacks, script)
    assert put[0] in (200, 201)
    assert ranged[0] == 206 and ranged[1] == payload[100:200]
    assert ranged[2]["Content-Range"] == f"bytes 100-199/{len(payload)}"
    assert past[0] == 416 and head == (200, b"", head[2])


# --- the lifecycle ------------------------------------------------------------------


def test_build_failure_makes_webdav_start_raise(monkeypatch):
    """The gateway's listener arms before WebDavServer.start() returns,
    as the S3 gateway's, the filer's and the volume server's do."""
    from seaweedfs_tpu_torch.util import native_serve
    from seaweedfs_tpu_torch.webdav import WebDavServer

    def broken():
        raise RuntimeError("kernel build failed\nserve_ext.c: error: planted")

    monkeypatch.setattr(native_serve, "_ext", broken)
    gw = WebDavServer(filer=f"127.0.0.1:{free_port()}", port=free_port())
    try:
        with pytest.raises(RuntimeError, match="planted"):
            gw.start()
    finally:
        gw.stop()


# threads of the process, not of a daemon: the tracing plane's span drainer
PROCESS_THREADS = ("trace-drain",)


def test_webdav_stop_ends_every_thread_it_started(stacks):
    """stop() joins what start() began: the HTTP listener, the announce
    loop and its hold on the sampling profiler. Threads that outlive it
    are waited for up to 10 s (a connection thread ends when its client
    has gone), then listed by name."""
    from seaweedfs_tpu_torch.telemetry import profiler
    from seaweedfs_tpu_torch.webdav import WebDavServer

    st = stacks["port"]
    before, users = set(threading.enumerate()), profiler._users
    gw = WebDavServer(filer=f"127.0.0.1:{st.filer.port}", port=free_port(),
                      masters=[f"127.0.0.1:{st.master.port}"], announce_interval=0.2)
    gw.start()
    try:
        body = _bytes(7, 5000)
        assert dav_req(gw.port, "PUT", "/threads/o", body=body)[0] == 201
        assert dav_req(gw.port, "GET", "/threads/o")[1] == body
        assert wait_for(lambda: st.master._gateways.get(f"127.0.0.1:{gw.port}",
                                                        {}).get("kind") == "webdav")
        started = {t.name for t in set(threading.enumerate()) - before}
        assert {"webdav-http", "announce-webdav"} <= started, started
    finally:
        gw.stop()

    def left():
        theirs = (set(st.master._grpc_pool._threads) | set(st.volume._grpc_pool._threads)
                  | set(st.filer._grpc_pool._threads))
        return [t for t in set(threading.enumerate()) - before - theirs
                if t.name not in PROCESS_THREADS]

    wait_for(lambda: not left(), 10)
    assert sorted(t.name for t in left()) == []
    assert profiler._users == users


def _listeners(port):
    """TCP sockets listening on `port` (each SO_REUSEPORT sibling one)."""
    with open("/proc/net/tcp") as f:
        rows = [line.split() for line in f.readlines()[1:]]
    return sum(1 for r in rows if r[3] == "0A" and int(r[1].rsplit(":", 1)[1], 16) == port)


def _children(pid) -> list:
    out = []
    for name in os.listdir("/proc"):
        with contextlib.suppress(OSError, IndexError):
            stat = pathlib.Path(f"/proc/{name}/stat").read_text()
            if name.isdigit() and int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(name))
    return out


def _handles_sigterm(pid) -> bool:
    with open(f"/proc/{pid}/status") as f:
        mask = next(line for line in f if line.startswith("SigCgt:")).split()[1]
    return bool(int(mask, 16) & (1 << (signal.SIGTERM - 1)))


def test_serve_procs_sibling_is_reaped():
    """`webdav -serveProcs 2`: the lead spawns one sibling that binds the
    same port with SO_REUSEPORT, both answer OPTIONS, and SIGTERM to the
    lead ends and reaps the sibling; the lead's exit code is 0."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "webdav", "-port", str(port),
         "-filer", f"127.0.0.1:{free_port()}", "-serveProcs", "2"],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    siblings = []
    try:
        assert wait_for(lambda: _listeners(port) == 2, 60), "two listeners on the port"
        assert wait_for(lambda: len(_children(proc.pid)) == 1 and all(
            map(_handles_sigterm, [proc.pid] + _children(proc.pid))), 30)
        siblings = _children(proc.pid)
        assert {dav_req(port, "OPTIONS", "/")[0] for _ in range(8)} == {200}
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            for pid in siblings:
                with contextlib.suppress(OSError):
                    os.kill(pid, signal.SIGKILL)
            raise
    assert proc.returncode == 0, out[-2000:]
    assert _listeners(port) == 0
    # reaped: no process of that pid is left, not even a zombie
    assert siblings and not any(os.path.exists(f"/proc/{pid}") for pid in siblings)


def test_webdav_modules_import_no_torch():
    code = ("import sys\n"
            "import seaweedfs_tpu_torch.webdav, seaweedfs_tpu_torch.command.servers\n"
            "from seaweedfs_tpu_torch.command import COMMANDS\n"
            "assert 'webdav' in COMMANDS\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_chip_smoke_webdav_tier_phase_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 3l at 24 MiB of WebDAV files (a 4 MiB big
    file, an 8 MiB .dat tier and an 8 MiB EC tier) on the host codec:
    every file and needle byte-equal through WebDAV, the Query verb, the
    .dat tier and the EC tier with four shard objects lost (decoded
    intervals and ranged tier reads rising on the serving holder), the
    gateways free of libcuda and torch, every process ending with 0."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    runs = chip_smoke.run_webdav_tier_phase(str(tmp_path), 24 << 20, 0, device="cpu",
                                            card="cpu", big_bytes=4 << 20,
                                            dat_bytes=8 << 20, ec_bytes=8 << 20)
    assert runs["webdav"]["touched"] > 0 and runs["webdav"]["deleted"] > 0
    assert runs["webdav_degraded"]["files"] == runs["webdav"]["files"]
    assert runs["tier_degraded"]["needles"] > 0
