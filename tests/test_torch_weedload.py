"""The port's weedload and hedged reads against seaweedfs_tpu's, on the CPU.

tests/test_telemetry.py's TestLogHistogram and TestWeedloadE2E and
tests/test_qos.py's TestQosCluster.test_load_reaches_master_and_cluster_top
and TestWeedloadQos ported, each case on both packages: log-bucketed
histograms (and, on the same seeded latencies, equal counts and
quantiles), a real multi-process run against each package's in-process
cluster (the port's volume servers on the cuda backend with
device="cpu"), the coordinated-omission-safe paced mode against a
stalling fake server, live load reaching the master and `cluster.top`,
and the mixed, hedged and shed worker modes against stub servers.
Reports are compared by their keys and counts, not their latencies.
A weedload worker only speaks HTTP: a worker run in a process of its own
holds no torch, numpy, jax or seaweedfs_tpu module, and the spawned
workers of a run map no torch library.
"""

from __future__ import annotations

import importlib
import json
import multiprocessing
import os
import queue
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

SIDES = ("ref", "port")
PKG = {"ref": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mod(side: str, name: str):
    return importlib.import_module(f"{PKG[side]}.{name}")


def _codec(side: str) -> dict:
    return dict(ec_codec="cpu") if side == "ref" else dict(ec_codec="cuda", device="cpu")


def _cluster(side: str, d: str, **master_kwargs):
    return mod(side, "util.availability").start_cluster(
        [tempfile.mkdtemp(dir=d)], scrub_interval=0.0,
        master_kwargs=master_kwargs or None, **_codec(side))


def _stop(master, servers) -> None:
    for s in servers:
        s.stop()
    master.stop()


class _StubServer:
    """Minimal HTTP/1.1 blob server: serves a fixed body, optionally after
    a delay (tests/test_qos.py's stub)."""

    def __init__(self, body: bytes = b"stub-body", delay_s: float = 0.0):
        self.body = body
        self.delay_s = delay_s
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(16)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @property
    def addr(self) -> str:
        return "127.0.0.1:%d" % self._sock.getsockname()[1]

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _read_head(self, conn) -> bool:
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = conn.recv(65536)
            if not chunk:
                return False
            buf += chunk
        return True

    def _serve(self, conn) -> None:
        try:
            if not self._read_head(conn):
                return
            if self.delay_s:
                time.sleep(self.delay_s)
            head = (b"HTTP/1.1 200 OK\r\nContent-Length: %d\r\n"
                    b"Connection: close\r\n\r\n" % len(self.body))
            try:
                conn.sendall(head + self.body)
            except OSError:
                pass
        finally:
            conn.close()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


class _Shedder(_StubServer):
    def _serve(self, conn):
        try:
            if self._read_head(conn):
                conn.sendall(b"HTTP/1.1 503 Service Unavailable\r\nRetry-After: 1\r\n"
                             b"Content-Length: 0\r\nConnection: close\r\n\r\n")
        finally:
            conn.close()


# ----------------------------------------------------------------------
# log histograms


@pytest.mark.parametrize("side", SIDES)
class TestLogHistogram:
    def test_record_merge_quantile(self, side):
        LogHistogram = mod(side, "telemetry.weedload").LogHistogram
        a, b = LogHistogram(), LogHistogram()
        for _ in range(99):
            a.record(0.001)
        b.record(1.0)
        a.merge(LogHistogram.from_row(b.to_row()))
        assert a.total == 100
        assert a.quantile(0.5) == pytest.approx(0.001, rel=0.3)
        assert a.quantile(0.999) == pytest.approx(1.0, rel=0.3)
        assert a.max == pytest.approx(1.0)

    def test_quantiles_monotone(self, side):
        h = mod(side, "telemetry.weedload").LogHistogram()
        for i in range(1, 1000):
            h.record(i * 1e-4)
        qs = [h.quantile(q) for q in (0.5, 0.9, 0.99, 0.999)]
        assert qs == sorted(qs)


@pytest.mark.parametrize("seed", range(4))
def test_log_histograms_equal_the_references(seed):
    got = {}
    for side in SIDES:
        wl = mod(side, "telemetry.weedload")
        rng = np.random.default_rng(seed)
        parts = []
        for _ in range(3):
            h = wl.LogHistogram()
            for v in rng.lognormal(-6.0, 1.5, int(rng.integers(1, 2000))).tolist():
                h.record(v)
            parts.append(h)
        merged = wl.LogHistogram()
        for h in parts:
            merged.merge(wl.LogHistogram.from_row(h.to_row()))
        got[side] = (merged.to_row(), merged.total,
                     [merged.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0)],
                     wl._summarize(merged, merged.total, 3, 12345, 2.5))
    assert got["port"] == got["ref"]


# ----------------------------------------------------------------------
# multi-process runs


def _shape(report: dict) -> dict:
    return {k: sorted(v) if isinstance(v, dict) else v for k, v in report.items()}


def test_multiprocess_load_reports_quantiles(tmp_path):
    reports = {}
    for side in SIDES:
        (tmp_path / side).mkdir()
        master, servers = _cluster(side, str(tmp_path / side))
        try:
            reports[side] = mod(side, "telemetry.weedload").run_load(
                f"127.0.0.1:{master.port}", duration_s=2.0, writers=1, readers=1,
                payload_bytes=512, rate=0.0, seed_n=8)
        finally:
            _stop(master, servers)
        report = reports[side]
        assert report["config"]["processes"] == 2
        for mode in ("put", "get"):
            row = report[mode]
            assert row["ops"] > 0, report
            assert row["errors"] == 0, report
            assert 0 < row["p50_ms"] <= row["p99_ms"] <= row["p999_ms"]
    assert _shape(reports["port"]) == _shape(reports["ref"])


@pytest.mark.parametrize("side", SIDES)
def test_paced_mode_is_co_safe(side, monkeypatch):
    """With a rate schedule a stalled server charges the latency of every
    request queued behind the stall, from its SCHEDULED start."""
    wl = mod(side, "telemetry.weedload")

    class FakeQ:
        def __init__(self):
            self.rows = []

        def put(self, row):
            self.rows.append(row)

    calls = {"n": 0}

    def stalling_http(conns, netloc, method, path, body=None, timeout=30.0):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(0.5)
        if method == "GET" and path == "/dir/assign":
            return 200, json.dumps({"fid": "1,ff", "url": "fake"}).encode()
        return 201, b"{}"

    q = FakeQ()
    monkeypatch.setattr(wl, "_http", stalling_http)
    wl._worker({"mode": "put", "master": "fake", "duration_s": 1.0, "payload": b"x",
                "rate": 50.0, "keys": [], "index": 0}, q)
    row = q.rows[0]
    hist = wl.LogHistogram.from_row(row["hist"])
    assert row["ops"] >= 20
    assert hist.quantile(0.9) > 0.05, hist.quantile(0.9)
    assert hist.max > 0.4, hist.max


# ----------------------------------------------------------------------
# QoS: live load into the master and cluster.top


@pytest.mark.parametrize("side", SIDES)
def test_load_reaches_master_and_cluster_top(side, tmp_path):
    master, servers = _cluster(side, str(tmp_path), telemetry_interval=0.5)
    vs = servers[0]
    try:
        for _ in range(5):
            vs.load.enter()
        vs._hb_wake.set()
        dn = master.topology.data_nodes()[0]
        # a beat taken while a scrape is in flight reports one more; the
        # next beat (0.2 s) reports the five again, so each read waits
        deadline = time.time() + 30
        while time.time() < deadline and (dn.in_flight, dn.queue_load()) != (5, 5):
            time.sleep(0.05)
        assert (dn.in_flight, dn.queue_load()) == (5, 5)
        collector = mod(side, "telemetry").ClusterCollector(master, interval=0.5)
        master.telemetry = collector
        collector.collect_once()
        deadline = time.time() + 30
        while True:
            top = collector.top_payload(5)
            vol_rows = [r for r in top["Nodes"] if r["Kind"] == "volume"]
            if (vol_rows and vol_rows[0]["InFlight"] == 5) or time.time() > deadline:
                break
            time.sleep(0.05)
        assert vol_rows and vol_rows[0]["InFlight"] == 5, top
    finally:
        for _ in range(5):
            vs.load.exit()
        _stop(master, servers)


# ----------------------------------------------------------------------
# weedload's QoS modes


@pytest.mark.parametrize("side", SIDES)
def test_mixed_mode_worker_alternates(side, tmp_path):
    wl = mod(side, "telemetry.weedload")
    master, servers = _cluster(side, str(tmp_path))
    m = f"127.0.0.1:{master.port}"
    try:
        payload = b"mix\x00\xff" * 40
        keys = wl.seed_keys(m, 4, payload)
        out: queue.Queue = queue.Queue()
        wl._worker({"mode": "mixed", "master": m, "duration_s": 1.0, "payload": payload,
                    "rate": 0.0, "keys": keys, "index": 0, "hedge": False}, out)
        row = out.get(timeout=5)
        assert row["mode"] == "mixed"
        assert row["errors"] == 0
        assert row["ops"] >= 4
        assert row["shed"] == 0
    finally:
        _stop(master, servers)


@pytest.mark.parametrize("side", SIDES)
def test_hedged_worker_reports_counts(side, monkeypatch):
    wl = mod(side, "telemetry.weedload")
    slow = _StubServer(body=b"W" * 24, delay_s=0.5)
    fast = _StubServer(body=b"W" * 24)
    out: queue.Queue = queue.Queue()
    monkeypatch.setenv("WEED_QOS_HEDGE_MS", "20")
    try:
        wl._worker({"mode": "get", "master": "unused", "duration_s": 1.2, "payload": b"",
                    "rate": 0.0, "keys": [("1,0000000a", [slow.addr, fast.addr])],
                    "index": 0, "hedge": True}, out)
    finally:
        slow.stop()
        fast.stop()
    row = out.get(timeout=5)
    assert row["errors"] == 0
    assert row["ops"] >= 2
    assert row["hedge"].get("fired", 0) >= 1
    assert row["hedge"].get("won", 0) >= 1


@pytest.mark.parametrize("side", SIDES)
def test_shed_counted_separately(side):
    wl = mod(side, "telemetry.weedload")
    srv = _Shedder()
    out: queue.Queue = queue.Queue()
    try:
        wl._worker({"mode": "get", "master": "unused", "duration_s": 0.4, "payload": b"",
                    "rate": 0.0, "keys": [("1,0000000b", srv.addr)], "index": 0,
                    "hedge": False}, out)
    finally:
        srv.stop()
    row = out.get(timeout=5)
    assert row["shed"] >= 1
    assert row["errors"] == 0
    assert row["ops"] == 0


def test_verify_bytes_counts_wrong_length_bodies_as_errors():
    """The degraded-GET worker's certification: a body whose length is
    not `verify_bytes` is an error on both packages."""
    srv = _StubServer(body=b"V" * 100)
    rows = {}
    try:
        for side in SIDES:
            out: queue.Queue = queue.Queue()
            for want in (100, 99):
                mod(side, "telemetry.weedload")._worker(
                    {"mode": "get", "master": "unused", "duration_s": 0.3, "payload": b"",
                     "rate": 0.0, "keys": [("1,0000000c", srv.addr)], "index": 0,
                     "hedge": False, "verify_bytes": want}, out)
            rows[side] = [out.get(timeout=5) for _ in range(2)]
    finally:
        srv.stop()
    for side in SIDES:
        ok, bad = rows[side]
        assert ok["errors"] == 0 and ok["ops"] > 0
        assert bad["ops"] == 0 and bad["errors"] > 0
        assert "expected 99" in bad["err_samples"][0]
    assert sorted(rows["port"][1]) == sorted(rows["ref"][1])


# ----------------------------------------------------------------------
# a worker imports nothing of the card


_WORKER_PROBE = """
import json, queue, sys
sys.path.insert(0, {repo!r})
from seaweedfs_tpu_torch.telemetry import weedload
out = queue.Queue()
weedload._worker({spec}, out)
row = out.get()
print(json.dumps({{"ops": row["ops"], "errors": row["errors"],
                  "heavy": sorted(m for m in ("torch", "numpy", "jax", "seaweedfs_tpu")
                                  if m in sys.modules)}}))
"""


def test_worker_process_holds_no_torch(tmp_path):
    """A real worker, hedged GETs included (qos/hedge.py and the client
    it drives), run in a process of its own: its sys.modules holds no
    torch, numpy, jax or seaweedfs_tpu. And the spawned workers of a
    run_load against a port cluster map no torch library."""
    slow = _StubServer(body=b"H" * 32, delay_s=0.2)
    fast = _StubServer(body=b"H" * 32)
    spec = {"mode": "get", "master": "unused", "duration_s": 0.5, "payload": b"",
            "rate": 0.0, "keys": [["1,0000000d", [slow.addr, fast.addr]]], "index": 0,
            "hedge": True}
    try:
        probe = subprocess.run(
            [sys.executable, "-c", _WORKER_PROBE.format(repo=REPO, spec=repr(spec))],
            capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
            env=dict(os.environ, WEED_QOS_HEDGE_MS="20"))
    finally:
        slow.stop()
        fast.stop()
    assert probe.returncode == 0, probe.stderr[-2000:]
    got = json.loads(probe.stdout.strip().splitlines()[-1])
    assert got["heavy"] == [] and got["ops"] > 0 and got["errors"] == 0, got

    master, servers = _cluster("port", str(tmp_path))
    maps: dict = {}
    done = threading.Event()
    report: dict = {}

    def drive():
        try:
            report.update(mod("port", "telemetry.weedload").run_load(
                f"127.0.0.1:{master.port}", duration_s=2.0, writers=1, readers=1,
                payload_bytes=256, seed_n=4))
        finally:
            done.set()

    t = threading.Thread(target=drive)
    before = {p.pid for p in multiprocessing.active_children()}
    t.start()
    try:
        while not done.is_set():
            for p in multiprocessing.active_children():
                if p.pid in before:
                    continue
                try:
                    with open(f"/proc/{p.pid}/maps") as f:
                        text = f.read()
                except OSError:
                    continue
                maps[p.pid] = maps.get(p.pid, False) or any(
                    lib in text for lib in ("libtorch", "/torch/", "libcuda"))
            done.wait(0.05)
    finally:
        t.join(120)
        _stop(master, servers)
    assert report["put"]["errors"] == 0 and report["get"]["errors"] == 0, report
    assert maps and not any(maps.values()), maps
