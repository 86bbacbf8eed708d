"""The port's `volume -workers N -shardWrites`: volume-ownership write
sharding, on the CPU, from the reference's tests/test_shard_writes.py.

The single-writer-per-volume invariant (reference
volume_read_write.go:66, enforced in-process there) partitions cleanly
across processes: writer k of N owns vids with vid % N == k (lead is
writer 0) and is the only process appending those volumes' .dat/.idx.
Everything else routes: the lead forwards worker-owned writes to the
owner's internal listener, workers forward lead-owned (or released)
writes to the lead, reads are served anywhere via .idx tail replay.
Admin ops that rewrite files (vacuum, EC encode via readonly, delete)
take ownership back first through the release handshake
(VolumeServer._ensure_owned ↔ the worker's /__shard/release).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import grpc
import pytest

from seaweedfs_tpu_torch.pb import rpc, volume_pb2
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.server.volume_workers import VolumeReadWorker
from seaweedfs_tpu_torch.util.availability import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _volume_port(internal: int = 2) -> int:
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


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def _post(url, data):
    with urllib.request.urlopen(
        urllib.request.Request(url, data=data, method="POST"), timeout=10
    ) as r:
        return r.status, r.read()


@pytest.fixture(scope="module")
def shard_stack(tmp_path_factory):
    """Master + sharded lead (writer 0 of 2) + one write worker
    (writer 1 of 2). The worker gets a private worker_port so tests can
    aim requests at a specific process (no SO_REUSEPORT lottery)."""
    mport = free_port()
    master = MasterServer(port=mport, volume_size_limit_mb=64)
    master.start()
    vdir = str(tmp_path_factory.mktemp("shardv"))
    vport, wport = free_port(), free_port()
    iport = free_port()
    winternal = free_port()
    lead = VolumeServer(
        [vdir],
        port=vport,
        master=f"127.0.0.1:{mport}",
        heartbeat_interval=0.2,
        max_volume_counts=[100],
        device="cpu",
        scrub_interval=0,
        internal_port=iport,
        shard_writes=True,
        n_writers=2,
    )
    # worker 1's internal listener must be where the lead expects it
    lead._writer_internal_addr = lambda k: (
        f"127.0.0.1:{winternal}" if k == 1 else f"127.0.0.1:{iport}"
    )
    lead.start()
    deadline = time.time() + 20
    while time.time() < deadline and not master.topology.data_nodes():
        time.sleep(0.05)
    assert master.topology.data_nodes(), "the lead never registered"
    worker = VolumeReadWorker(
        [vdir],
        host="127.0.0.1",
        port=free_port(),
        lead=f"127.0.0.1:{iport}",
        worker_port=wport,
        shard_writes=True,
        writer_index=1,
        n_writers=2,
        master=f"127.0.0.1:{mport}",
        internal_port=winternal,
    )
    worker.start()
    yield master, lead, worker, mport, vport, wport
    worker.stop()
    lead.stop()
    master.stop()


def assign_vid_parity(mport, parity, collection="", n=40):
    """Assign until we get a fid on a vid with vid % 2 == parity."""
    for _ in range(n):
        with urllib.request.urlopen(
            f"http://127.0.0.1:{mport}/dir/assign"
            + (f"?collection={collection}" if collection else "")
        ) as r:
            a = json.load(r)
        if int(a["fid"].split(",")[0]) % 2 == parity:
            return a
    raise AssertionError(f"no vid with parity {parity} in {n} assigns")


class TestShardWriteRouting:
    def test_worker_owned_write_lands_and_reads_everywhere(self, shard_stack):
        master, lead, worker, mport, vport, wport = shard_stack
        a = assign_vid_parity(mport, 1)  # worker-owned vid
        vid = int(a["fid"].split(",")[0])
        payload = b"worker-owned write " * 100

        # write through the LEAD's public port: it must route to the
        # worker, whose append the lead then serves via tail replay
        status, body = _post(f"http://127.0.0.1:{vport}/{a['fid']}", payload)
        assert status == 201
        assert json.loads(body)["size"] > 0
        # the WORKER really wrote it: its SharedReadVolume holds the key
        assert worker._find_volume(vid) is not None
        # read via lead
        status, body = _get(f"http://127.0.0.1:{vport}/{a['fid']}")
        assert status == 200 and body == payload
        # read via worker
        status, body = _get(f"http://127.0.0.1:{wport}/{a['fid']}")
        assert status == 200 and body == payload

    def test_worker_port_write_handled_locally(self, shard_stack):
        master, lead, worker, mport, vport, wport = shard_stack
        a = assign_vid_parity(mport, 1)
        payload = b"direct worker write"
        status, _ = _post(f"http://127.0.0.1:{wport}/{a['fid']}", payload)
        assert status == 201
        status, body = _get(f"http://127.0.0.1:{vport}/{a['fid']}")
        assert status == 200 and body == payload

    def test_lead_owned_write_from_worker_port_proxies(self, shard_stack):
        master, lead, worker, mport, vport, wport = shard_stack
        a = assign_vid_parity(mport, 0)  # lead-owned vid
        payload = b"lead-owned via worker"
        status, _ = _post(f"http://127.0.0.1:{wport}/{a['fid']}", payload)
        assert status == 201
        status, body = _get(f"http://127.0.0.1:{vport}/{a['fid']}")
        assert status == 200 and body == payload

    def test_overwrite_wrong_cookie_409_on_worker_path(self, shard_stack):
        master, lead, worker, mport, vport, wport = shard_stack
        a = assign_vid_parity(mport, 1)
        _post(f"http://127.0.0.1:{vport}/{a['fid']}", b"v1")
        vid_str, key_cookie = a["fid"].split(",")
        forged = f"{vid_str},{key_cookie[:-8]}{'f' * 8}"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"http://127.0.0.1:{vport}/{forged}", b"evil")
        assert ei.value.code == 409

    def test_delete_routes_to_owner(self, shard_stack):
        master, lead, worker, mport, vport, wport = shard_stack
        a = assign_vid_parity(mport, 1)
        _post(f"http://127.0.0.1:{vport}/{a['fid']}", b"to be deleted")
        req = urllib.request.Request(
            f"http://127.0.0.1:{vport}/{a['fid']}", method="DELETE"
        )
        with urllib.request.urlopen(req, timeout=10) as r:
            # 202 Accepted like the lead's do_DELETE: the cluster must
            # answer the same whichever process takes the first hop
            assert r.status == 202
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"http://127.0.0.1:{vport}/{a['fid']}")
        assert ei.value.code == 404
        # tombstone visible through the worker too
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"http://127.0.0.1:{wport}/{a['fid']}")
        assert ei.value.code == 404

    def test_client_supplied_hop_header_does_not_seize(self, shard_stack):
        """x-shard-hop is trusted only from the loopback internal
        listener: an anonymous client setting it on the PUBLIC port
        must not strip write ownership from a healthy worker."""
        master, lead, worker, mport, vport, wport = shard_stack
        a = assign_vid_parity(mport, 1)  # worker-owned vid
        vid = int(a["fid"].split(",")[0])
        req = urllib.request.Request(
            f"http://127.0.0.1:{vport}/{a['fid']}",
            data=b"hop forgery",
            method="POST",
            headers={"x-shard-hop": "1"},
        )
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 201
        assert vid not in lead._shard_taken
        with worker._release_lock:
            assert vid not in worker.released
        # the write still landed through the owner and reads back
        status, body = _get(f"http://127.0.0.1:{vport}/{a['fid']}")
        assert status == 200 and body == b"hop forgery"

    def test_owned_delete_fans_out_to_replicas(self, shard_stack, monkeypatch):
        """A first-hop DELETE on a worker-owned vid must run the same
        replica fan-out as the lead's do_DELETE (store_replicate.go's
        ReplicatedDelete) — an acknowledged delete that skipped its
        replicas would resurrect there."""
        master, lead, worker, mport, vport, wport = shard_stack
        a = assign_vid_parity(mport, 1)  # worker-owned vid
        vid = int(a["fid"].split(",")[0])
        _post(f"http://127.0.0.1:{vport}/{a['fid']}", b"replicated doomed")

        from seaweedfs_tpu_torch.client import operation as op
        from seaweedfs_tpu_torch.server import write_path
        from seaweedfs_tpu_torch.storage.replica_placement import ReplicaPlacement

        v = worker._find_volume(vid)
        assert v is not None
        monkeypatch.setattr(
            v.volume.super_block,
            "replica_placement",
            ReplicaPlacement.parse("001"),
        )
        me = f"{worker.host}:{worker.port}"

        class FakeLookup:
            error = ""
            locations = [{"url": me}, {"url": "127.0.0.1:59999"}]

        calls = []

        def fake_replicate(fid, q, method, body, headers, locations):
            calls.append((method, tuple(locations)))
            return None

        monkeypatch.setattr(op, "lookup", lambda m, vs, collection="": FakeLookup())
        monkeypatch.setattr(write_path, "replicate_to_peers", fake_replicate)

        req = urllib.request.Request(
            f"http://127.0.0.1:{wport}/{a['fid']}", method="DELETE"
        )
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 202
        assert calls == [("DELETE", ("127.0.0.1:59999",))]

    def test_owned_delete_replica_error_fails_request(
        self, shard_stack, monkeypatch
    ):
        """All-or-error like the reference: a replica that refuses the
        delete fails the client's request (500), it is not silently
        acknowledged."""
        master, lead, worker, mport, vport, wport = shard_stack
        a = assign_vid_parity(mport, 1)
        vid = int(a["fid"].split(",")[0])
        _post(f"http://127.0.0.1:{vport}/{a['fid']}", b"replica refuses")

        from seaweedfs_tpu_torch.client import operation as op
        from seaweedfs_tpu_torch.server import write_path
        from seaweedfs_tpu_torch.storage.replica_placement import ReplicaPlacement

        v = worker._find_volume(vid)
        monkeypatch.setattr(
            v.volume.super_block,
            "replica_placement",
            ReplicaPlacement.parse("001"),
        )

        class FakeLookup:
            error = ""
            locations = [{"url": "127.0.0.1:59999"}]

        monkeypatch.setattr(op, "lookup", lambda m, vs, collection="": FakeLookup())
        monkeypatch.setattr(
            write_path,
            "replicate_to_peers",
            lambda *args: "replica 127.0.0.1:59999 failed",
        )
        req = urllib.request.Request(
            f"http://127.0.0.1:{wport}/{a['fid']}", method="DELETE"
        )
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 500


class TestShardHandback:
    def test_readonly_takes_ownership_back(self, shard_stack):
        master, lead, worker, mport, vport, wport = shard_stack
        a = assign_vid_parity(mport, 1, collection="hb")
        vid = int(a["fid"].split(",")[0])
        payload = b"written by worker before handback " * 50
        status, _ = _post(f"http://127.0.0.1:{vport}/{a['fid']}", payload)
        assert status == 201

        with grpc.insecure_channel(f"127.0.0.1:{lead.grpc_port}") as ch:
            rpc.volume_stub(ch).VolumeMarkReadonly(
                volume_pb2.VolumeMarkReadonlyRequest(volume_id=vid)
            )
        assert vid in lead._shard_taken
        assert vid in worker.released
        # the lead's own map caught up with the worker's append: the
        # blob reads through the lead's REGULAR volume path
        v = lead.store.find_volume(vid)
        got = v.read_needle(int(a["fid"].split(",")[1][:-8], 16))
        raw = bytes(got.data)
        if got.is_gzipped():  # transparent write-path compression
            import gzip

            raw = gzip.decompress(raw)
        assert raw == payload
        # writes now 409 at the LEAD (read-only), not lost at the worker
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"http://127.0.0.1:{vport}/{a['fid']}", b"rejected")
        assert ei.value.code == 409
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"http://127.0.0.1:{wport}/{a['fid']}", b"rejected")
        assert ei.value.code == 409

    def test_vacuum_handback_preserves_worker_writes(self, shard_stack):
        master, lead, worker, mport, vport, wport = shard_stack
        a = assign_vid_parity(mport, 1, collection="vac")
        vid = int(a["fid"].split(",")[0])
        payload = b"survives vacuum handback"
        _post(f"http://127.0.0.1:{vport}/{a['fid']}", payload)

        with grpc.insecure_channel(f"127.0.0.1:{lead.grpc_port}") as ch:
            stub = rpc.volume_stub(ch)
            stub.VacuumVolumeCompact(
                volume_pb2.VacuumVolumeCompactRequest(volume_id=vid)
            )
            stub.VacuumVolumeCommit(
                volume_pb2.VacuumVolumeCommitRequest(volume_id=vid)
            )
        status, body = _get(f"http://127.0.0.1:{vport}/{a['fid']}")
        assert status == 200 and body == payload
        # post-handback writes are lead-local
        a2_fid = None
        for _ in range(40):
            with urllib.request.urlopen(
                f"http://127.0.0.1:{mport}/dir/assign?collection=vac"
            ) as r:
                cand = json.load(r)
            if int(cand["fid"].split(",")[0]) == vid:
                a2_fid = cand["fid"]
                break
        if a2_fid:
            status, _ = _post(f"http://127.0.0.1:{vport}/{a2_fid}", b"post-vac")
            assert status == 201
            status, body = _get(f"http://127.0.0.1:{wport}/{a2_fid}")
            assert status == 200 and body == b"post-vac"


class TestShardConcurrency:
    def test_concurrent_writes_across_owners_all_land(self, shard_stack):
        """16 threads × mixed-parity fids through both entry ports:
        every blob must read back exactly from both processes."""
        master, lead, worker, mport, vport, wport = shard_stack
        written: dict[str, bytes] = {}
        lock = threading.Lock()
        errors: list[str] = []

        def one(i):
            try:
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{mport}/dir/assign?collection=conc"
                ) as r:
                    a = json.load(r)
                payload = (f"concurrent blob {i} ".encode()) * 37
                port = vport if i % 2 == 0 else wport
                status, _ = _post(f"http://127.0.0.1:{port}/{a['fid']}", payload)
                if status != 201:
                    raise RuntimeError(f"status {status}")
                with lock:
                    written[a["fid"]] = payload
            except Exception as e:  # noqa: BLE001
                errors.append(f"{i}: {e!r}")

        threads = [
            threading.Thread(target=one, args=(i,)) for i in range(48)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors[:5]
        assert len(written) == 48
        for fid, want in written.items():
            for port in (vport, wport):
                status, body = _get(f"http://127.0.0.1:{port}/{fid}")
                assert status == 200 and body == want, (fid, port)


class TestShardWritesCli:
    """Real multiprocess write scaling: `volume -workers 2 -shardWrites`
    spawns an actual write-worker subprocess; writes for both vid
    parities must land through the shared SO_REUSEPORT port and read
    back exactly — the multi-core write-scaling deployment shape."""

    def test_cli_shard_writes_both_parities(self, tmp_path):
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
            deadline = time.time() + 30
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
                    "-max", "16",
                    "-workers", "2",
                    "-shardWrites",
                )
            )

            def assign():
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{mport}/dir/assign", timeout=2
                ) as r:
                    return json.load(r)

            deadline = time.time() + 60
            ready = False
            while time.time() < deadline:
                try:
                    if "fid" in assign():
                        ready = True
                        break
                except OSError:
                    pass
                time.sleep(0.3)
            assert ready, f"volume lead never registered: {tails()}"
            # the worker subprocess needs to come up before its vids
            # accept writes without lead-takeover; writes to its parity
            # would otherwise still succeed (fallback) but the test
            # wants the sharded path — wait for the worker's internal
            # listener via a parity-1 write retry loop
            written = {}
            deadline = time.time() + 60
            while len(written) < 12 and time.time() < deadline:
                a = assign()
                payload = f"shard cli {a['fid']} ".encode() * 19
                try:
                    urllib.request.urlopen(
                        urllib.request.Request(
                            f"http://127.0.0.1:{vport}/{a['fid']}",
                            data=payload,
                            method="POST",
                        ),
                        timeout=10,
                    ).read()
                    written[a["fid"]] = payload
                except OSError:
                    time.sleep(0.3)
            assert len(written) >= 12
            parities = {int(f.split(",")[0]) % 2 for f in written}
            assert parities == {0, 1}, "writes must cover both owners"
            for fid, want in written.items():
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{vport}/{fid}", timeout=10
                ) as r:
                    assert r.read() == want, fid
        finally:
            for pr in procs:
                pr.terminate()
            for pr in procs:
                try:
                    pr.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pr.kill()


class TestThreeWriterRouting:
    """-workers 3: a write landing on a NON-owner worker must reach the
    true owner via the lead WITHOUT the lead seizing the vid — the hop
    marker is owner-decline-only (a non-owner's proxy setting it would
    collapse sharding for every N>=3 deployment under load)."""

    @pytest.fixture(scope="class")
    def three_stack(self, tmp_path_factory):
        mport = free_port()
        master = MasterServer(port=mport, volume_size_limit_mb=64)
        master.start()
        vdir = str(tmp_path_factory.mktemp("shard3"))
        vport = free_port()
        iport = free_port()
        winternals = {1: free_port(), 2: free_port()}
        lead = VolumeServer(
            [vdir],
            port=vport,
            master=f"127.0.0.1:{mport}",
            heartbeat_interval=0.2,
            max_volume_counts=[100],
            device="cpu",
            scrub_interval=0,
            internal_port=iport,
            shard_writes=True,
            n_writers=3,
        )
        lead._writer_internal_addr = lambda k: (
            f"127.0.0.1:{winternals[k]}" if k else f"127.0.0.1:{iport}"
        )
        lead.start()
        deadline = time.time() + 20
        while time.time() < deadline and not master.topology.data_nodes():
            time.sleep(0.05)
        workers = []
        wports = {}
        for k in (1, 2):
            wports[k] = free_port()
            w = VolumeReadWorker(
                [vdir],
                host="127.0.0.1",
                port=free_port(),
                lead=f"127.0.0.1:{iport}",
                worker_port=wports[k],
                shard_writes=True,
                writer_index=k,
                n_writers=3,
                master=f"127.0.0.1:{mport}",
                internal_port=winternals[k],
            )
            w.start()
            workers.append(w)
        yield master, lead, workers, mport, vport, wports
        for w in workers:
            w.stop()
        lead.stop()
        master.stop()

    def test_nonowner_worker_routes_without_seizure(self, three_stack):
        master, lead, workers, mport, vport, wports = three_stack
        # find a fid on a vid owned by worker 2 (vid % 3 == 2)
        a = None
        for _ in range(60):
            with urllib.request.urlopen(
                f"http://127.0.0.1:{mport}/dir/assign"
            ) as r:
                cand = json.load(r)
            if int(cand["fid"].split(",")[0]) % 3 == 2:
                a = cand
                break
        assert a, "no worker-2-owned vid assigned"
        vid = int(a["fid"].split(",")[0])
        payload = b"three-writer routed payload " * 40

        # write through WORKER 1's port (non-owner): worker1 -> lead ->
        # worker2
        status, _ = _post(f"http://127.0.0.1:{wports[1]}/{a['fid']}", payload)
        assert status == 201
        # the lead must NOT have seized the vid: worker 2 still owns it
        assert vid not in lead._shard_taken
        assert vid not in workers[1].released and vid not in workers[0].released
        # and worker 2 genuinely holds the volume (it wrote it)
        assert workers[1]._find_volume(vid) is not None  # writer_index 2
        # readable from every process
        for port in (vport, wports[1], wports[2]):
            status, body = _get(f"http://127.0.0.1:{port}/{a['fid']}")
            assert status == 200 and body == payload


class TestShardWritesWithJwt:
    """Sharded local writes enforce the same JWT gate as the lead
    (write_path.check_write_auth): an unsigned write to a worker-owned
    vid 401s at the WORKER, a signed one lands."""

    @pytest.fixture(scope="class")
    def jwt_shard_stack(self, tmp_path_factory):
        from seaweedfs_tpu_torch.security.guard import Guard

        key = "shard-signing-key"
        mport = free_port()
        master = MasterServer(
            port=mport,
            volume_size_limit_mb=64,
            guard=Guard(signing_key=key, expires_after_sec=30),
        )
        master.start()
        vdir = str(tmp_path_factory.mktemp("jwtshard"))
        vport, wport, iport, winternal = (
            free_port(), free_port(), free_port(), free_port(),
        )
        lead = VolumeServer(
            [vdir],
            port=vport,
            master=f"127.0.0.1:{mport}",
            heartbeat_interval=0.2,
            max_volume_counts=[100],
            device="cpu",
            scrub_interval=0,
            internal_port=iport,
            shard_writes=True,
            n_writers=2,
            guard=Guard(signing_key=key, expires_after_sec=30),
        )
        lead._writer_internal_addr = lambda k: (
            f"127.0.0.1:{winternal}" if k == 1 else f"127.0.0.1:{iport}"
        )
        lead.start()
        deadline = time.time() + 20
        while time.time() < deadline and not master.topology.data_nodes():
            time.sleep(0.05)
        worker = VolumeReadWorker(
            [vdir],
            host="127.0.0.1",
            port=free_port(),
            lead=f"127.0.0.1:{iport}",
            worker_port=wport,
            shard_writes=True,
            writer_index=1,
            n_writers=2,
            master=f"127.0.0.1:{mport}",
            internal_port=winternal,
            guard=Guard(signing_key=key, expires_after_sec=30),
        )
        worker.start()
        yield master, lead, worker, mport, vport, wport
        worker.stop()
        lead.stop()
        master.stop()

    def test_signed_write_lands_unsigned_401s(self, jwt_shard_stack):
        master, lead, worker, mport, vport, wport = jwt_shard_stack
        # worker-owned fid WITH its assign-issued token
        a = None
        for _ in range(40):
            with urllib.request.urlopen(
                f"http://127.0.0.1:{mport}/dir/assign"
            ) as r:
                cand = json.load(r)
            if int(cand["fid"].split(",")[0]) % 2 == 1:
                a = cand
                break
        assert a and a.get("auth"), "assign must mint a write token"
        payload = b"signed sharded write"

        # unsigned: 401 straight from the worker's local-write path
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"http://127.0.0.1:{wport}/{a['fid']}", payload)
        assert ei.value.code == 401

        # signed: lands through the worker
        req = urllib.request.Request(
            f"http://127.0.0.1:{wport}/{a['fid']}",
            data=payload,
            method="POST",
            headers={"Authorization": f"BEARER {a['auth']}"},
        )
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 201
        status, body = _get(f"http://127.0.0.1:{vport}/{a['fid']}")
        assert status == 200 and body == payload
        # the WORKER wrote it (not a proxy-to-lead fallback)
        assert worker._find_volume(int(a["fid"].split(",")[0])) is not None


class TestHandbackUnderWriteLoad:
    """The release/write race end-to-end: writers hammer a worker-owned
    vid WHILE the lead takes ownership back for vacuum. Every write
    acknowledged with 201 must be readable afterwards — the
    VolumeReleased abort in the worker re-routes in-flight writes to
    the lead instead of appending past the lead's catch-up refresh."""

    def test_no_acknowledged_write_lost_across_handback(self, shard_stack):
        master, lead, worker, mport, vport, wport = shard_stack
        a = assign_vid_parity(mport, 1, collection="race")
        vid = int(a["fid"].split(",")[0])

        acked: dict[str, bytes] = {}
        lock = threading.Lock()
        stop = threading.Event()
        errors: list[str] = []

        def writer(tid):
            i = 0
            while not stop.is_set():
                i += 1
                # same-vid fids via ?count= delta sub-fids would pin the
                # vid, but plain assigns work: filter to our vid
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{mport}/dir/assign?collection=race"
                ) as r:
                    cand = json.load(r)
                if int(cand["fid"].split(",")[0]) != vid:
                    continue
                payload = f"race {tid}-{i} ".encode() * 23
                try:
                    status, _ = _post(
                        f"http://127.0.0.1:{vport}/{cand['fid']}", payload
                    )
                except urllib.error.HTTPError as e:
                    if e.code == 409:
                        continue  # readonly during compact: acceptable reject
                    errors.append(f"{tid}-{i}: HTTP {e.code}")
                    continue
                except Exception as e:  # noqa: BLE001
                    errors.append(f"{tid}-{i}: {e!r}")
                    continue
                if status == 201:
                    with lock:
                        acked[cand["fid"]] = payload

        threads = [threading.Thread(target=writer, args=(t,)) for t in range(3)]
        for t in threads:
            t.start()
        def acked_at_least(n):
            deadline = time.time() + 30
            while time.time() < deadline and not errors:
                with lock:
                    if len(acked) >= n:
                        return
                time.sleep(0.01)

        acked_at_least(3)  # writes flow through the worker first
        import grpc

        from seaweedfs_tpu_torch.pb import rpc, volume_pb2

        with grpc.insecure_channel(f"127.0.0.1:{lead.grpc_port}") as ch:
            stub = rpc.volume_stub(ch)
            stub.VacuumVolumeCompact(
                volume_pb2.VacuumVolumeCompactRequest(volume_id=vid)
            )
            stub.VacuumVolumeCommit(
                volume_pb2.VacuumVolumeCommitRequest(volume_id=vid)
            )
        with lock:
            before = len(acked)
        acked_at_least(before + 3)  # post-handback writes flow through the lead
        stop.set()
        for t in threads:
            t.join(timeout=30)

        assert not errors, errors[:5]
        assert vid in lead._shard_taken  # the handback really happened
        assert len(acked) > 5, "no writes crossed the handback window"
        # EVERY acknowledged write reads back exactly, from both procs
        for fid, want in acked.items():
            for port in (vport, wport):
                status, body = _get(f"http://127.0.0.1:{port}/{fid}")
                assert status == 200 and body == want, (fid, port)
