"""The port's `volume -workers N` SO_REUSEPORT read workers
(server/volume_workers.py), on the CPU, from the reference's
tests/test_workers.py.

The lead stays the single writer (the reference's per-volume write
ordering, volume_read_write.go:66); workers serve GET/HEAD from the
shared directories with `.idx` tail-replay freshness and proxy
everything else to the lead's internal listener. A worker process
never touches the card: it imports neither torch nor the reference
package (tested on a real `volume.worker` process).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.server.volume_workers import SharedReadVolume, VolumeReadWorker
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import NeedleNotFound, Volume
from seaweedfs_tpu_torch.util.availability import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _volume_port(internal: int = 1) -> int:
    """A volume port for the command line's -workers: the command puts
    its internal listeners at port - 20000 onward (one a writer) when
    port + 20000 would pass 65535. An odd port in 45537..52767 puts them
    below the kernel's ephemeral range, where the suite's closed client
    connections (TIME_WAIT, on even ports) cannot hold them; each port
    the servers bind (itself, + 10000, the internal ones) is probed as
    they bind it, with SO_REUSEADDR."""
    import random
    import socket

    rng = random.Random(os.getpid() ^ time.monotonic_ns())
    for _ in range(200):
        port = 45537 + 2 * rng.randrange((52767 - 45537) // 2)
        try:
            for q in (port, port + 10000, *(port - 20000 + k for k in range(internal))):
                with socket.socket() as s:
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                    s.bind(("127.0.0.1", q))
        except OSError:
            continue
        return port
    raise RuntimeError("no volume port with free internal ports")


def _listeners(port: int) -> int:
    """TCP sockets listening on `port` (SO_REUSEPORT siblings count one
    each), from the kernel's table."""
    with open("/proc/net/tcp") as f:
        rows = [line.split() for line in f.readlines()[1:]]
    return sum(1 for r in rows if r[3] == "0A" and int(r[1].rsplit(":", 1)[1], 16) == port)


class TestSharedReadVolume:
    def _needle(self, nid: int, data: bytes) -> Needle:
        n = Needle(cookie=0x42, id=nid, data=data)
        n.name = b"w.bin"
        n.set_has_name()
        return n

    def test_sees_writes_made_after_open(self, tmp_path):
        owner = Volume(str(tmp_path), 5)
        owner.write_needle(self._needle(1, b"first"))
        reader = SharedReadVolume(str(tmp_path), 5)
        assert reader.read_needle(1, cookie=0x42).data == b"first"
        # writes landing AFTER the reader opened must become visible
        # (idx tail replay — read-your-writes across processes)
        owner.write_needle(self._needle(2, b"second"))
        assert reader.read_needle(2, cookie=0x42).data == b"second"
        # overwrite: the reader must serve the new version
        owner.write_needle(self._needle(1, b"first-v2"))
        assert reader.read_needle(1, cookie=0x42).data == b"first-v2"

    def test_sees_deletes(self, tmp_path):
        owner = Volume(str(tmp_path), 6)
        owner.write_needle(self._needle(1, b"doomed"))
        reader = SharedReadVolume(str(tmp_path), 6)
        assert reader.read_needle(1).data == b"doomed"
        owner.delete_needle(Needle(cookie=0x42, id=1))
        with pytest.raises(NeedleNotFound):
            reader.read_needle(1)

    def test_survives_vacuum_commit(self, tmp_path):
        owner = Volume(str(tmp_path), 7)
        for i in range(1, 6):
            owner.write_needle(self._needle(i, b"x%d" % i))
        owner.delete_needle(Needle(cookie=0x42, id=2))
        reader = SharedReadVolume(str(tmp_path), 7)
        assert reader.read_needle(3).data == b"x3"
        owner.compact()
        owner.commit_compact()
        # new inode pair: the reader reopens and keeps serving
        assert reader.read_needle(3).data == b"x3"
        with pytest.raises(NeedleNotFound):
            reader.read_needle(2)
        # post-vacuum writes flow through the reopened index
        owner.write_needle(self._needle(9, b"after-vacuum"))
        assert reader.read_needle(9).data == b"after-vacuum"


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    mport, vport, wport = free_port(), free_port(), free_port()
    iport = free_port()
    master = MasterServer(port=mport, volume_size_limit_mb=64)
    master.start()
    vdir = str(tmp_path_factory.mktemp("wvol"))
    lead = VolumeServer(
        [vdir],
        port=vport,
        master=f"127.0.0.1:{mport}",
        heartbeat_interval=0.2,
        internal_port=iport,
        device="cpu",
        scrub_interval=0,
    )
    lead.start()
    deadline = time.time() + 20
    while time.time() < deadline and not master.topology.data_nodes():
        time.sleep(0.05)
    assert master.topology.data_nodes(), "the lead never registered"
    worker = VolumeReadWorker(
        [vdir],
        host="127.0.0.1",
        port=free_port(),  # its own shared-port stand-in
        lead=f"127.0.0.1:{iport}",
        worker_port=wport,
    )
    worker.start()
    yield master, lead, worker, mport, vport, wport
    worker.stop()
    lead.stop()
    master.stop()


class TestVolumeReadWorker:
    def _assign(self, mport):
        import json

        with urllib.request.urlopen(
            f"http://127.0.0.1:{mport}/dir/assign"
        ) as r:
            return json.load(r)

    def test_worker_serves_lead_writes(self, stack):
        master, lead, worker, mport, vport, wport = stack
        a = self._assign(mport)
        req = urllib.request.Request(
            f"http://127.0.0.1:{vport}/{a['fid']}?filename=t.txt",
            data=b"through the lead",
            method="POST",
        )
        urllib.request.urlopen(req).read()
        # read via the WORKER port: local fast path, not the lead
        with urllib.request.urlopen(
            f"http://127.0.0.1:{wport}/{a['fid']}"
        ) as r:
            assert r.read() == b"through the lead"
            assert r.headers.get("ETag")

    def test_worker_proxies_writes_to_lead(self, stack):
        master, lead, worker, mport, vport, wport = stack
        a = self._assign(mport)
        req = urllib.request.Request(
            f"http://127.0.0.1:{wport}/{a['fid']}",
            data=b"written via worker proxy",
            method="POST",
        )
        body = urllib.request.urlopen(req).read()
        assert b"eTag" in body
        # and the lead really owns it
        with urllib.request.urlopen(
            f"http://127.0.0.1:{vport}/{a['fid']}"
        ) as r:
            assert r.read() == b"written via worker proxy"

    def test_worker_read_your_write_after_proxy(self, stack):
        master, lead, worker, mport, vport, wport = stack
        a = self._assign(mport)
        req = urllib.request.Request(
            f"http://127.0.0.1:{wport}/{a['fid']}",
            data=b"immediately visible",
            method="POST",
        )
        urllib.request.urlopen(req).read()
        with urllib.request.urlopen(
            f"http://127.0.0.1:{wport}/{a['fid']}"
        ) as r:
            assert r.read() == b"immediately visible"

    def test_worker_proxies_deletes_and_sees_tombstone(self, stack):
        master, lead, worker, mport, vport, wport = stack
        a = self._assign(mport)
        urllib.request.urlopen(
            urllib.request.Request(
                f"http://127.0.0.1:{wport}/{a['fid']}",
                data=b"doomed",
                method="POST",
            )
        ).read()
        urllib.request.urlopen(
            urllib.request.Request(
                f"http://127.0.0.1:{wport}/{a['fid']}", method="DELETE"
            )
        ).read()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{wport}/{a['fid']}")
        assert ei.value.code == 404

    def test_worker_proxies_status_pages(self, stack):
        master, lead, worker, mport, vport, wport = stack
        with urllib.request.urlopen(f"http://127.0.0.1:{wport}/status") as r:
            assert b"Volumes" in r.read()

    def test_worker_range_and_304(self, stack):
        master, lead, worker, mport, vport, wport = stack
        a = self._assign(mport)
        urllib.request.urlopen(
            urllib.request.Request(
                f"http://127.0.0.1:{vport}/{a['fid']}",
                data=b"0123456789",
                method="POST",
            )
        ).read()
        req = urllib.request.Request(f"http://127.0.0.1:{wport}/{a['fid']}")
        req.add_header("Range", "bytes=2-5")
        with urllib.request.urlopen(req) as r:
            assert r.status == 206 and r.read() == b"2345"
        with urllib.request.urlopen(
            f"http://127.0.0.1:{wport}/{a['fid']}"
        ) as r:
            etag = r.headers["ETag"]
        req = urllib.request.Request(f"http://127.0.0.1:{wport}/{a['fid']}")
        req.add_header("If-None-Match", etag)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 304

    def test_concurrent_mixed_load(self, stack):
        """Writes proxied + reads served locally under concurrency —
        the worker must never serve stale or torn data."""
        master, lead, worker, mport, vport, wport = stack
        errors = []

        def one(i):
            try:
                a = self._assign(mport)
                payload = b"payload-%d" % i
                urllib.request.urlopen(
                    urllib.request.Request(
                        f"http://127.0.0.1:{wport}/{a['fid']}",
                        data=payload,
                        method="POST",
                    )
                ).read()
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{wport}/{a['fid']}"
                ) as r:
                    got = r.read()
                if got != payload:
                    errors.append((i, got, payload))
            except Exception as e:  # noqa: BLE001
                errors.append((i, repr(e)))

        threads = [
            threading.Thread(target=one, args=(i,)) for i in range(24)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors[:3]


class TestWorkersCli:
    """The real `volume -workers N` spawn path: a CLI lead brings up
    SO_REUSEPORT worker subprocesses sharing its port; fresh-connection
    reads spread across processes and writes land through whichever
    process accepts."""

    def test_cli_workers_share_port(self, tmp_path):
        mport, vport = free_port(), _volume_port()
        env = dict(os.environ, WEED_EC_CODEC="cpu")

        logs = []

        def spawn(*args):
            logs.append(tmp_path / f"{args[0]}.log")
            return subprocess.Popen(
                [sys.executable, "-m", "seaweedfs_tpu_torch", *args],
                env=env,
                cwd=REPO,
                stdout=open(logs[-1], "w"),
                stderr=subprocess.STDOUT,
            )

        def tails() -> str:
            return "\n".join(f"{p.name}: {p.read_text()[-1500:]}" for p in logs)

        procs = [spawn("master", "-port", str(mport), "-telemetryInterval", "0")]
        try:
            deadline = time.time() + 60
            while time.time() < deadline:
                try:
                    urllib.request.urlopen(
                        f"http://127.0.0.1:{mport}/stats/health", timeout=2
                    ).read()
                    break
                except OSError:
                    time.sleep(0.2)
            procs.append(
                spawn(
                    "volume",
                    "-port", str(vport),
                    "-mserver", f"127.0.0.1:{mport}",
                    "-dir", str(tmp_path),
                    "-max", "8",
                    "-workers", "3",
                )
            )

            def assigned():
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{mport}/dir/assign", timeout=2
                ) as r:
                    return json.loads(r.read())

            deadline = time.time() + 120
            fid = None
            while time.time() < deadline:
                try:
                    a = assigned()
                    if "fid" in a:
                        fid = a["fid"]
                        break
                except OSError:
                    pass
                time.sleep(0.3)
            assert fid, f"volume lead never registered: {tails()}"
            url = f"http://127.0.0.1:{vport}/{fid}"
            urllib.request.urlopen(
                urllib.request.Request(url, data=b"cli worker payload", method="POST"),
                timeout=10,
            ).read()
            # wait until the worker subprocesses listen, then read over
            # MANY fresh connections: the kernel spreads them over all
            # SO_REUSEPORT listeners, so every process must serve
            deadline = time.time() + 60
            while time.time() < deadline and _listeners(vport) < 3:
                time.sleep(0.2)
            assert _listeners(vport) == 3, "the worker processes never listened"
            for _ in range(12):
                with urllib.request.urlopen(url, timeout=10) as r:
                    assert r.read() == b"cli worker payload"
            # delete propagates through whichever process accepts
            urllib.request.urlopen(
                urllib.request.Request(url, method="DELETE"), timeout=10
            ).read()
            for _ in range(6):
                with pytest.raises(urllib.error.HTTPError):
                    urllib.request.urlopen(url, timeout=10)
            # SIGTERM ends the lead (which ends its workers) with 0
            procs[1].send_signal(signal.SIGTERM)
            assert procs[1].wait(timeout=60) == 0
        finally:
            for p in reversed(procs):
                p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()


class TestTornReadUnderVacuum:
    """The worker freshness design rests on
    fstat-per-lookup; the feared window is a vacuum commit landing
    between a worker's fstat and its pread of the old .dat fd. The
    design answer is that the window is CLOSED by construction — the
    worker preads a BOUND fd, and commit_compact renames a fresh
    .cpd/.cpx pair over the names, so an fd opened before the commit
    still addresses the pre-vacuum bytes that its replayed index
    offsets describe (consistent, at worst one commit stale); the next
    fstat sees the inode change and reopens. These tests hammer that
    story across ≥50 real commits and fail on ANY torn byte: needle
    CRC is verified on every read (Volume.read_needle), cookies are
    enforced, and every body must be a version that was actually
    written."""

    def _needle(self, nid: int, data: bytes) -> Needle:
        n = Needle(cookie=0x42, id=nid, data=data)
        return n

    def test_inprocess_reader_vs_looped_vacuum(self, tmp_path):
        owner = Volume(str(tmp_path), 21)
        # stable keys that survive every vacuum
        stable = {i: b"stable-%d " % i * 40 for i in range(1, 6)}
        for nid, data in stable.items():
            owner.write_needle(self._needle(nid, data))
        reader = SharedReadVolume(str(tmp_path), 21)

        hot_lock = threading.Lock()
        hot_round = [0]
        owner.write_needle(self._needle(9, b"hot-v0 " * 50))

        stop = threading.Event()
        failures: list[str] = []
        reads = [0]

        def read_with_retry(nid):
            # mid-commit transients surface as OSError; the worker
            # architecture proxies those to the lead, so the in-process
            # stand-in retries a few times before calling it a failure
            # (a single retry can itself land in the next commit's
            # window when the whole host is loaded)
            last = None
            delay = 0.003
            for _ in range(8):  # ~0.4 s total: spans scheduler stalls
                try:
                    return reader.read_needle(nid, cookie=0x42).data
                except OSError as e:
                    last = e
                    time.sleep(delay)
                    delay *= 2
            raise last

        def read_loop():
            while not stop.is_set():
                for nid, want in stable.items():
                    try:
                        got = read_with_retry(nid)
                    except OSError as e:
                        failures.append(f"stable {nid}: {e!r}")
                        continue
                    if got != want:
                        failures.append(f"stable {nid}: torn/wrong body")
                    reads[0] += 1
                try:
                    got = read_with_retry(9)
                except OSError as e:
                    failures.append(f"hot key: {e!r}")
                    continue
                except NeedleNotFound:
                    failures.append("hot key vanished")
                    continue
                # CRC is verified inside read_needle; here we assert the
                # body is SELF-CONSISTENT — exactly one version repeated
                # in the written pattern. Staleness is allowed (a reader
                # descheduled across commits legitimately returns an
                # older version); torn or mixed bytes never parse back
                # to a single round's pattern.
                prefix = got.split(b" ", 1)[0]  # b"hot-vN"
                with hot_lock:
                    current = hot_round[0]
                ok = (
                    prefix.startswith(b"hot-v")
                    and prefix[5:].isdigit()
                    and int(prefix[5:]) <= current
                    and got == (prefix + b" ") * 50
                )
                if not ok:
                    failures.append(f"hot key: torn body {got[:40]!r}")
                reads[0] += 1

        threads = [threading.Thread(target=read_loop) for _ in range(2)]
        for t in threads:
            t.start()
        commits = 0
        try:
            for round_no in range(1, 56):  # >= 50 commits
                body = (b"hot-v%d " % round_no) * 50
                with hot_lock:
                    hot_round[0] = round_no
                owner.write_needle(self._needle(9, body))
                # churn: a doomed needle per round keeps vacuum honest
                owner.write_needle(self._needle(1000 + round_no, b"junk" * 64))
                owner.delete_needle(Needle(cookie=0x42, id=1000 + round_no))
                owner.compact()
                owner.commit_compact()
                commits += 1
                # PACE, don't race: wait until the readers demonstrably
                # crossed this commit before firing the next one. The
                # old free-running loop asserted a read RATE
                # (reads > 3×commits), which is a scheduler property —
                # on a loaded 1-vCPU host the readers can legitimately
                # starve and the assertion flaked. The
                # torn-read property needs INTERLEAVING, and pacing
                # guarantees ≥1 read per commit deterministically.
                target = reads[0] + 1
                deadline = time.time() + 30
                while reads[0] < target and time.time() < deadline:
                    time.sleep(0.002)
                assert reads[0] >= target, (
                    f"readers made no progress across commit {commits} "
                    f"within 30s; failures so far: {failures[:5]}"
                )
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)

        assert commits >= 50
        assert not failures, failures[:10]
        # interleaving floor now holds by construction (paced loop)
        assert reads[0] >= commits, f"only {reads[0]} reads crossed the loop"

    def test_stack_reader_vs_grpc_vacuum_loop(self, stack):
        """Same property through the wire: hammer the worker's HTTP
        port while the lead runs compact→commit cycles over gRPC."""
        import grpc
        import json

        from seaweedfs_tpu_torch.pb import rpc, volume_pb2

        master, lead, worker, mport, vport, wport = stack
        assign = self._assign_to(mport)
        vid = int(assign["fid"].split(",")[0])
        payload = b"torn-read stack payload " * 64
        urllib.request.urlopen(
            urllib.request.Request(
                f"http://{assign['url']}/{assign['fid']}",
                data=payload,
                method="POST",
            ),
            timeout=10,
        ).close()

        stop = threading.Event()
        failures: list[str] = []
        reads = [0]

        def read_loop():
            url = f"http://127.0.0.1:{wport}/{assign['fid']}"
            while not stop.is_set():
                try:
                    with urllib.request.urlopen(url, timeout=10) as r:
                        if r.read() != payload:
                            failures.append("body mismatch")
                except Exception as e:  # noqa: BLE001
                    failures.append(repr(e))
                reads[0] += 1

        t = threading.Thread(target=read_loop)
        t.start()
        commits = 0
        try:
            with grpc.insecure_channel(f"127.0.0.1:{lead.grpc_port}") as ch:
                stub = rpc.volume_stub(ch)
                for i in range(52):
                    # churn then vacuum: doomed needle makes real garbage
                    _, a2 = 0, self._assign_to(mport)
                    if int(a2["fid"].split(",")[0]) == vid:
                        urllib.request.urlopen(
                            urllib.request.Request(
                                f"http://{a2['url']}/{a2['fid']}",
                                data=b"doomed",
                                method="POST",
                            ),
                            timeout=10,
                        ).close()
                        urllib.request.urlopen(
                            urllib.request.Request(
                                f"http://{a2['url']}/{a2['fid']}",
                                method="DELETE",
                            ),
                            timeout=10,
                        ).close()
                    stub.VacuumVolumeCompact(
                        volume_pb2.VacuumVolumeCompactRequest(volume_id=vid)
                    )
                    stub.VacuumVolumeCommit(
                        volume_pb2.VacuumVolumeCommitRequest(volume_id=vid)
                    )
                    commits += 1
                    # PACE the commit loop on demonstrated read
                    # progress (same deflake as the in-process test):
                    # the wire property is reads INTERLEAVING commits,
                    # and the old free-running `reads > 50` floor was
                    # a scheduler-rate assertion that flaked whenever
                    # the reader thread starved on a loaded host
                    target = reads[0] + 1
                    deadline = time.time() + 30
                    while reads[0] < target and time.time() < deadline:
                        time.sleep(0.002)
                    assert reads[0] >= target, (
                        f"reader made no progress across commit "
                        f"{commits} within 30s; failures: {failures[:5]}"
                    )
        finally:
            stop.set()
            t.join(timeout=30)

        assert commits >= 50
        assert not failures, failures[:10]
        # ≥1 read per commit holds by construction (paced loop)
        assert reads[0] >= commits

    def _assign_to(self, mport):
        import json

        with urllib.request.urlopen(
            f"http://127.0.0.1:{mport}/dir/assign"
        ) as r:
            return json.load(r)


class TestWorkerAdmission:
    """`volume -workers N` read workers enforce admission control (else
    N-1 of every N SO_REUSEPORT connections would bypass the budget)."""

    def _worker_with_admission(self, tmp_path, rate=1.0, procs=1):
        vol = Volume(str(tmp_path), 9)
        n = Needle(cookie=0x42, id=1, data=b"gated" * 8)
        vol.write_needle(n)
        vol.close()
        worker = VolumeReadWorker(
            [str(tmp_path)],
            host="127.0.0.1",
            port=free_port(),
            lead="127.0.0.1:1",  # never dialed: the blob is local
            admission_rate=rate,
            admission_burst=rate,
            admission_procs=procs,
        )
        worker.start()
        return worker

    def test_worker_sheds_over_budget_with_retry_after(self, tmp_path):
        worker = self._worker_with_admission(tmp_path, rate=1.0)
        try:
            from seaweedfs_tpu_torch.storage.file_id import FileId

            url = f"http://127.0.0.1:{worker.port}/{FileId(9, 1, 0x42)}"
            with urllib.request.urlopen(url, timeout=10) as r:
                assert r.status == 200
                assert r.read() == b"gated" * 8
            # burst spent: the immediate second request must shed with
            # 503 + Retry-After through the worker's own gate (the
            # lead is unreachable, so a proxy fallback would 502)
            try:
                urllib.request.urlopen(url, timeout=10)
                raise AssertionError("second request was not shed")
            except urllib.error.HTTPError as e:
                assert e.code == 503
                assert float(e.headers["Retry-After"]) > 0
            assert worker.admission.rejected == 1
        finally:
            worker.stop()

    def test_budget_splits_across_group(self, tmp_path):
        """Same convention as -serveProcs siblings: each member of a
        -workers group enforces rate/procs of the per-client budget."""
        worker = self._worker_with_admission(tmp_path, rate=8.0, procs=4)
        try:
            assert worker.admission.rate == pytest.approx(2.0)
        finally:
            worker.stop()

    def test_internal_listener_not_gated(self, tmp_path):
        """The lead↔worker release handshake must never be shed — a
        503 mid-handback would wedge write ownership."""
        vol = Volume(str(tmp_path), 9)
        vol.close()
        worker = VolumeReadWorker(
            [str(tmp_path)],
            host="127.0.0.1",
            port=free_port(),
            lead="127.0.0.1:1",
            shard_writes=True,
            writer_index=1,
            n_writers=2,
            internal_port=free_port(),
            admission_rate=1.0,
            admission_burst=1.0,
        )
        worker.start()
        try:
            assert worker._internal_server is not None
            assert worker._internal_server.admission is None
            for s in worker._servers:
                if s is not worker._internal_server:
                    assert s.admission is worker.admission
        finally:
            worker.stop()


def _handles_sigterm(pid) -> bool:
    """Whether `pid` has installed its SIGTERM handler (SigCgt in /proc)."""
    with open(f"/proc/{pid}/status") as f:
        mask = next(line for line in f if line.startswith("SigCgt:")).split()[1]
    return bool(int(mask, 16) & (1 << (signal.SIGTERM - 1)))


class TestWorkerProcessStaysOffTheCard:
    def test_worker_process_imports_neither_torch_nor_the_reference(self, stack, tmp_path):
        """A real `volume.worker` process (the command the lead spawns)
        serves a fast-path GET and a proxied request, ends on SIGTERM
        with 0, and at exit has neither torch nor seaweedfs_tpu loaded."""
        master, lead, worker, mport, vport, wport = stack
        a = TestVolumeReadWorker()._assign(mport)
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{vport}/{a['fid']}", data=b"off the card",
            method="POST")).read()
        port, out = free_port(), tmp_path / "modules.json"
        code = (
            "import atexit, json, sys\n"
            f"atexit.register(lambda: open({str(out)!r}, 'w').write("
            "json.dumps(sorted(sys.modules))))\n"
            "from seaweedfs_tpu_torch.command import main\n"
            "sys.exit(main())\n"
        )
        proc = subprocess.Popen(
            [sys.executable, "-c", code, "volume.worker", "-port", str(port),
             "-dir", lead.store.locations[0].directory,
             "-lead", f"127.0.0.1:{lead.internal_port}"],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        )
        try:
            deadline = time.time() + 60
            got = None
            while time.time() < deadline:
                try:
                    with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/{a['fid']}", timeout=5
                    ) as r:
                        got = r.read()
                    break
                except OSError:
                    assert proc.poll() is None, proc.stderr.read()
                    time.sleep(0.1)
            assert got == b"off the card"
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/status", timeout=10) as r:
                assert b"Volumes" in r.read()  # proxied to the lead
            # the worker serves a moment before its SIGTERM handler is in
            # place (it comes once start() returns); signalled in between
            # it would die of the default action, so the signal waits
            deadline = time.time() + 60
            while not _handles_sigterm(proc.pid) and time.time() < deadline:
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0, proc.stderr.read()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        modules = json.loads(out.read_text())
        assert "seaweedfs_tpu_torch.server.volume_workers" in modules
        assert not [m for m in modules if m == "torch" or m.startswith("torch.")]
        assert not [m for m in modules
                    if m == "seaweedfs_tpu" or m.startswith("seaweedfs_tpu.")]


def test_chip_smoke_edge_phase_on_the_cpu(tmp_path):
    """chip_smoke.py's serving-edge phase at a small size on the host
    codec: the threaded arm, the C loop and the C loop with workers, each
    started from the command line and loaded by the port's benchmark;
    then EC GETs through the workers' shared port, proxied to the lead,
    every body equal to its payload, and every process ending with 0."""
    import chip_smoke

    runs = chip_smoke.run_edge_phase(str(tmp_path), 0, device="cpu", card="cpu", files=256)
    assert sorted(runs) == ["edge_c_loop", "edge_ec", "edge_threaded", "edge_workers"]
    assert runs["edge_threaded"]["serve_stats"] == {}
    assert runs["edge_c_loop"]["serve_stats"]["served"] >= 128
    assert len(runs["edge_workers"]["spread"]) == chip_smoke.EDGE_WORKERS
    assert runs["edge_ec"]["needles"] == 256 and runs["edge_ec"]["serve_stats"]["handoffs"] > 0
