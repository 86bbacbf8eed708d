"""The port's notification queues and filer-to-filer replication
(seaweedfs_tpu_torch/notification/, seaweedfs_tpu_torch/replication/)
against the reference's: the counterparts of tests/test_replication.py's
TestQueues, TestReplicationEndToEnd and TestS3Sink over port clusters in
this process, then the same event stream applied by both packages'
replicators through each sink (a local directory, a filer, an S3 bucket
on the port's gateway, and GCS, Azure and B2 over the protocol fakes of
tests/cloud_fakes.py), which must leave the same tree, byte for byte,
equal to the source's. `filer.replicate -config` into sink.gcs runs from
the command line, and WEED_REPL=0 consumes nothing. Every wait polls a
condition under a deadline."""

import base64
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import grpc
import pytest

from seaweedfs_tpu.pb import filer_pb2 as ref_fpb
from seaweedfs_tpu.replication import cloud_sinks as ref_cloud_sinks
from seaweedfs_tpu.replication import replicator as ref_replicator
from seaweedfs_tpu.replication import sink as ref_sink
from seaweedfs_tpu.replication import source as ref_source
from seaweedfs_tpu_torch import notification
from seaweedfs_tpu_torch.filer import filechunks
from seaweedfs_tpu_torch.notification.logqueue import PartitionedLogQueue
from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.replication import cloud_sinks as port_cloud_sinks
from seaweedfs_tpu_torch.replication import replicate_runner
from seaweedfs_tpu_torch.replication import sink as port_sink
from seaweedfs_tpu_torch.replication.replicator import Replicator
from seaweedfs_tpu_torch.replication.sink import FilerSink, LocalSink, S3Sink
from seaweedfs_tpu_torch.replication.source import FilerSource
from seaweedfs_tpu_torch.s3api import S3ApiServer
from seaweedfs_tpu_torch.s3api.auth import Identity, IdentityAccessManagement
from seaweedfs_tpu_torch.s3api.client import S3Client, S3ClientError
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.util.availability import free_port
from seaweedfs_tpu_torch.util.config import Configuration, load_config
from tests.cloud_fakes import FakeAzure, FakeB2, FakeGcs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def wait_for(cond, timeout: float = 45.0, interval: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


class PortCluster:
    """A port master, one volume server (decoding on the CPU) and a
    memory-store filer, in this process. The filer publishes to the
    notification queue that is set while it is built. With `telemetry`
    the master runs its collector (the replication lag alert past 2
    events) and the filer announces itself to it; with `s3` an S3 gateway
    on the filer holds one identity."""

    def __init__(self, root: str, telemetry: bool = False, s3: bool = False, max_mb: int = 1):
        self.started = []
        try:
            self.master = self._up(MasterServer(
                port=free_port(), volume_size_limit_mb=64, vacuum_interval=0,
                telemetry_interval=0.4 if telemetry else 0.0,
                telemetry_kwargs={"repl_lag_threshold": 2.0} if telemetry else None))
            self.maddr = f"127.0.0.1:{self.master.port}"
            os.makedirs(os.path.join(root, "vol"), exist_ok=True)
            self.vs = self._up(VolumeServer(
                [os.path.join(root, "vol")], port=free_port(), master=self.maddr,
                heartbeat_interval=0.2, max_volume_counts=[20], scrub_interval=0,
                ec_codec="cuda", device="cpu"))
            assert wait_for(lambda: self.master.topology.data_nodes()), "no volume server"
            self.filer = self._up(FilerServer(
                [self.maddr], port=free_port(), store="memory", max_mb=max_mb,
                announce_interval=0.3 if telemetry else 10.0))
            self.filer_addr = f"127.0.0.1:{self.filer.port}"
            self.s3 = None
            if s3:
                iam = IdentityAccessManagement([Identity("r", "rk", "rs")])
                self.s3 = self._up(S3ApiServer(filer=self.filer_addr, port=free_port(),
                                               iam=iam))
                self.s3_addr = f"127.0.0.1:{self.s3.port}"
        except BaseException:
            self.stop()
            raise

    def _up(self, server):
        server.start()
        self.started.append(server)
        return server

    def stop(self):
        for s in reversed(self.started):
            s.stop()
        self.started = []


def post(filer: str, path: str, data: bytes) -> None:
    req = urllib.request.Request(f"http://{filer}{path}", data=data, method="POST")
    urllib.request.urlopen(req, timeout=30).close()


def get(filer: str, path: str) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(f"http://{filer}{path}", timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def delete(filer: str, path: str, recursive: bool = False) -> None:
    url = f"http://{filer}{path}" + ("?recursive=true" if recursive else "")
    urllib.request.urlopen(urllib.request.Request(url, method="DELETE"), timeout=30).close()


def entry_of(filer: str, path: str) -> fpb.Entry:
    d, _, name = path.rpartition("/")
    with rpc.dial(rpc.grpc_address(filer)) as ch:
        return rpc.filer_stub(ch).LookupDirectoryEntry(
            fpb.LookupDirectoryEntryRequest(directory=d or "/", name=name), timeout=30).entry


def filer_tree(filer: str, root: str) -> dict:
    """{path under root: bytes} of every file below `root` on a filer,
    walked over ListEntries."""
    out = {}
    with rpc.dial(rpc.grpc_address(filer)) as ch:
        stub = rpc.filer_stub(ch)
        todo = [root]
        while todo:
            d = todo.pop()
            try:
                resps = list(stub.ListEntries(
                    fpb.ListEntriesRequest(directory=d, limit=10000), timeout=30))
            except grpc.RpcError:
                continue
            for r in resps:
                path = f"{d.rstrip('/')}/{r.entry.name}"
                if r.entry.is_directory:
                    todo.append(path)
                else:
                    status, body = get(filer, path)
                    assert status == 200, (path, status)
                    out[path[len(root):]] = body
    return out


def local_tree(root: str) -> dict:
    return {"/" + os.path.relpath(os.path.join(d, n), root): open(os.path.join(d, n), "rb").read()
            for d, _, names in os.walk(root) for n in names}


# ----------------------------------------------------------------------
# the queues


class TestQueues:
    @staticmethod
    def _event(name: str) -> fpb.EventNotification:
        msg = fpb.EventNotification()
        msg.new_entry.name = name
        return msg

    def test_memory_queue(self):
        q = notification.MemoryQueue()
        q.send_message("/a", self._event("a"))
        key, msg = q.receive(timeout=1)
        assert key == "/a" and msg.new_entry.name == "a"
        assert q.receive(timeout=0.01) is None

    def test_dir_queue_durable_ordering(self, tmp_path):
        q = notification.DirQueue(str(tmp_path))
        for i in range(5):
            q.send_message(f"/k{i}", self._event(f"e{i}"))
        assert [k for _, k, _ in q.consume()] == [f"/k{i}" for i in range(5)]
        q2 = notification.DirQueue(str(tmp_path))
        q2.send_message("/k5", self._event("e5"))
        seqs = [s for s, _, _ in q2.consume()]
        assert seqs == sorted(seqs) and len(seqs) == 6
        assert [k for _, k, _ in q2.consume(after_seq=seqs[3])] == ["/k4", "/k5"]

    def test_configure_from_toml(self, tmp_path):
        cfg = Configuration(
            {"notification": {"dirqueue": {"enabled": True, "dir": str(tmp_path / "q")}}},
            env={})
        try:
            assert isinstance(notification.configure(cfg), notification.DirQueue)
        finally:
            notification.queue = None

    def test_configure_logqueue_from_a_notification_toml(self, tmp_path):
        """notification.toml on disk, found where the daemons look for it,
        builds the logqueue with its directory and partition count."""
        (tmp_path / "notification.toml").write_text(
            f'[notification.logqueue]\nenabled = true\ndir = "{tmp_path / "lq"}"\n'
            f"partitions = 3\n")
        q = notification.configure(load_config("notification", search_dirs=(str(tmp_path),)))
        try:
            assert isinstance(q, PartitionedLogQueue) and notification.queue is q
            assert len(q.partitions) == 3
            assert sorted(os.listdir(tmp_path / "lq")) == ["meta.json", "p000", "p001", "p002"]
        finally:
            q.close()
            notification.queue = None


# ----------------------------------------------------------------------
# a source cluster's events into a sink cluster


@pytest.fixture()
def two_clusters(tmp_path):
    """A source port cluster whose filer publishes to a dirqueue, and a
    sink port cluster."""
    qdir = str(tmp_path / "queue")
    clusters = []
    notification.queue = notification.DirQueue(qdir)
    try:
        clusters.append(PortCluster(str(tmp_path / "src")))
        notification.queue = None  # only the source publishes
        clusters.append(PortCluster(str(tmp_path / "dst")))
        yield clusters[0].filer_addr, clusters[1].filer_addr, qdir
    finally:
        notification.queue = None
        for c in clusters:
            c.stop()


def _drain(qdir: str, replicator) -> int:
    n = 0
    for _, key, msg in notification.DirQueue(qdir).consume():
        replicator.replicate(key, msg)
        n += 1
    return n


class TestReplicationEndToEnd:
    def test_filer_sink_create_and_delete(self, two_clusters):
        src, dst, qdir = two_clusters
        payload = b"replicate-me " * 1000
        notification.queue = notification.DirQueue(qdir)
        try:
            post(src, "/buckets/docs/a.txt", payload)
            post(src, "/buckets/docs/b.txt", b"second-file")
        finally:
            notification.queue = None
        source = FilerSource(src, directory="/buckets")
        sink = FilerSink(dst, directory="/backup")
        replicator = Replicator(source, sink)
        try:
            assert _drain(qdir, replicator) >= 2
            assert get(dst, "/backup/docs/a.txt") == (200, payload)
            assert get(dst, "/backup/docs/b.txt") == (200, b"second-file")
            # the sink cluster holds its own copies of the chunks
            src_fids = {c.fid for c in entry_of(src, "/buckets/docs/a.txt").chunks}
            dst_chunks = entry_of(dst, "/backup/docs/a.txt").chunks
            assert {c.source_fid for c in dst_chunks} == src_fids
            notification.queue = notification.DirQueue(qdir)
            try:
                delete(src, "/buckets/docs/b.txt")
            finally:
                notification.queue = None
            _, key, msg = list(notification.DirQueue(qdir).consume())[-1]
            replicator.replicate(key, msg)
            assert get(dst, "/backup/docs/b.txt")[0] == 404
        finally:
            source.close()
            sink.close()

    def test_local_sink(self, two_clusters, tmp_path):
        src, _, qdir = two_clusters
        notification.queue = notification.DirQueue(qdir)
        try:
            post(src, "/buckets/imgs/x.bin", b"local-sink-bytes")
        finally:
            notification.queue = None
        source = FilerSource(src, directory="/buckets")
        try:
            _drain(qdir, Replicator(source, LocalSink(str(tmp_path / "mirror"))))
            assert (tmp_path / "mirror/imgs/x.bin").read_bytes() == b"local-sink-bytes"
        finally:
            source.close()


# ----------------------------------------------------------------------
# the S3 sink, through the port's own gateway


@pytest.fixture(scope="module")
def s3_cluster(tmp_path_factory):
    c = PortCluster(str(tmp_path_factory.mktemp("s3sink")), s3=True)
    try:
        yield c
    finally:
        c.stop()


class TestS3Sink:
    def test_create_update_delete_through_s3(self, s3_cluster):
        c = s3_cluster
        client = S3Client(c.s3_addr, "rk", "rs")
        client.create_bucket("repl-dest")
        payload = b"replicate me to s3" * 20
        post(c.filer_addr, "/src/doc.bin", payload)
        source = FilerSource(c.filer_addr, directory="/src")
        sink = S3Sink(c.s3_addr, "repl-dest", "rk", "rs", directory="mirror")
        replicator = Replicator(source, sink)
        try:
            entry = entry_of(c.filer_addr, "/src/doc.bin")
            replicator.replicate("/src/doc.bin", fpb.EventNotification(new_entry=entry))
            assert client.get_object("repl-dest", "mirror/doc.bin") == payload
            # an update rewrites the object whole
            post(c.filer_addr, "/src/doc.bin", b"second version")
            new = entry_of(c.filer_addr, "/src/doc.bin")
            replicator.replicate("/src/doc.bin", fpb.EventNotification(
                old_entry=entry, new_entry=new, new_parent_path="/src"))
            assert client.get_object("repl-dest", "mirror/doc.bin") == b"second version"
            replicator.replicate("/src/doc.bin", fpb.EventNotification(
                old_entry=new, delete_chunks=True))
            with pytest.raises(S3ClientError):
                client.get_object("repl-dest", "mirror/doc.bin")
        finally:
            source.close()

    def test_s3_sink_directory_delete_sweeps_prefix(self, s3_cluster):
        """One recursive directory-delete event removes every replicated
        object under the prefix."""
        c = s3_cluster
        client = S3Client(c.s3_addr, "rk", "rs")
        client.create_bucket("dir-del")
        source = FilerSource(c.filer_addr, directory="/sweep")
        replicator = Replicator(source, S3Sink(c.s3_addr, "dir-del", "rk", "rs"))
        try:
            for name in ("sub/a.txt", "sub/b.txt", "keep.txt"):
                post(c.filer_addr, f"/sweep/{name}", b"x" * 64)
                replicator.replicate(f"/sweep/{name}", fpb.EventNotification(
                    new_entry=entry_of(c.filer_addr, f"/sweep/{name}")))
            assert len(client.list_objects("dir-del", "sub/")) == 2
            replicator.replicate("/sweep/sub", fpb.EventNotification(
                old_entry=fpb.Entry(name="sub", is_directory=True), delete_chunks=True))
            assert client.list_objects("dir-del", "sub/") == []
            assert client.list_objects("dir-del", "") == ["keep.txt"]
        finally:
            source.close()


@pytest.mark.parametrize("side", ["ref", "port"])
def test_s3_sink_assemble_respects_visibility(side):
    """Overlapping chunks resolve by mtime (newest wins) and a truncated
    entry stays clamped, in both packages' assembly."""
    sink_cls = {"ref": ref_sink.S3Sink, "port": S3Sink}[side]
    pb = {"ref": ref_fpb, "port": fpb}[side]
    sink = sink_cls.__new__(sink_cls)  # no network needed for _assemble

    class FakeSource:
        def read_chunk(self, fid):
            return {"1,old": b"O" * 50, "1,new": b"N" * 100}[fid]

    old = pb.FileChunk.FromString(filechunks.make_chunk("1,old", 10, 50, mtime=1)
                                  .SerializeToString())
    new = pb.FileChunk.FromString(filechunks.make_chunk("1,new", 0, 100, mtime=2)
                                  .SerializeToString())
    sink.source = FakeSource()
    entry = pb.Entry(name="f", chunks=[old, new])
    entry.attributes.file_size = 100
    assert sink._assemble(entry) == b"N" * 100
    entry2 = pb.Entry(name="g", chunks=[new])
    entry2.attributes.file_size = 40
    assert sink._assemble(entry2) == b"N" * 40


# ----------------------------------------------------------------------
# one event stream, both packages' replicators


@pytest.fixture(scope="module")
def event_stream(tmp_path_factory):
    """A port source cluster (1 MiB chunks) whose filer publishes to a
    logqueue, and a port sink cluster with an S3 gateway. The source's
    mutations: nested files of 0 B to 2.5 MiB (three chunks), one file
    overwritten, one file deleted and one directory deleted recursively.
    Yields (src, dst, events, the source's final tree under /buckets);
    the events are every record of the queue, in poll order, each
    partition's in append order, once every chunk the source dropped
    answers 404."""
    import numpy as np

    root = tmp_path_factory.mktemp("stream")
    lq = PartitionedLogQueue(str(root / "lq"), partitions=4)
    clusters = []
    notification.queue = lq
    try:
        clusters.append(PortCluster(str(root / "src")))
        notification.queue = None
        clusters.append(PortCluster(str(root / "dst"), s3=True))
        src, dst = clusters
        rng = np.random.default_rng(22)
        files = {f"/buckets/t/d{i % 3}/{'e/' * (i % 2)}f{i:02d}.bin":
                 rng.bytes(int(rng.integers(0, 3 << 19))) for i in range(14)}
        files["/buckets/t/big.bin"] = rng.bytes(5 << 19)
        files["/buckets/gone/x.bin"] = rng.bytes(4096)
        notification.queue = lq
        try:
            for path, data in files.items():
                post(src.filer_addr, path, data)
            dropped = {c.fid for p in ("/buckets/t/d0/f00.bin", "/buckets/t/d1/e/f01.bin",
                                       "/buckets/gone/x.bin")
                       for c in entry_of(src.filer_addr, p).chunks}
            files["/buckets/t/d0/f00.bin"] = b"overwritten " * 300
            post(src.filer_addr, "/buckets/t/d0/f00.bin", files["/buckets/t/d0/f00.bin"])
            delete(src.filer_addr, "/buckets/t/d1/e/f01.bin")
            delete(src.filer_addr, "/buckets/gone", recursive=True)
        finally:
            notification.queue = None
        del files["/buckets/t/d1/e/f01.bin"], files["/buckets/gone/x.bin"]
        vs = f"127.0.0.1:{src.vs.port}"
        assert wait_for(lambda: all(get(vs, f"/{fid}")[0] == 404 for fid in dropped), 60), \
            "the source kept chunks it dropped"
        events = [(key, msg.SerializeToString())
                  for _, _, key, msg in lq.poll("collect", max_records=10000)]
        assert len(events) >= len(files) + 4
        yield src, dst, events, {p[len("/buckets"):]: b for p, b in files.items()}
    finally:
        notification.queue = None
        lq.close()
        for c in clusters:
            c.stop()


def _apply(side: str, events: list, source_addr: str, sink) -> list:
    """Each event through one package's Replicator; returns what each
    apply raised (None when it applied)."""
    pb = {"ref": ref_fpb, "port": fpb}[side]
    src_cls = {"ref": ref_source.FilerSource, "port": FilerSource}[side]
    rep_cls = {"ref": ref_replicator.Replicator, "port": Replicator}[side]
    source = src_cls(source_addr, directory="/buckets")
    replicator = rep_cls(source, sink)
    outcomes = []
    try:
        for key, blob in events:
            try:
                replicator.replicate(key, pb.EventNotification.FromString(blob))
                outcomes.append(None)
            except Exception as e:  # noqa: BLE001 — a dropped chunk's create
                outcomes.append(type(e).__name__)
    finally:
        source.close()
    return outcomes


_AZURE_KEY = base64.b64encode(b"k" * 32).decode()
_CLOUD_FAKES = {"gcs": lambda: FakeGcs(), "azure": lambda: FakeAzure("acct", _AZURE_KEY, "c"),
                "backblaze": lambda: FakeB2("kid", "app", "bkt")}


def _cloud_sink(mod, kind: str, endpoint: str):
    if kind == "gcs":
        return mod.GcsSink("bkt", token="t", endpoint=endpoint)
    if kind == "azure":
        return mod.AzureSink("acct", _AZURE_KEY, "c", endpoint=endpoint)
    return mod.B2Sink("kid", "app", "bkt", endpoint=endpoint)


@pytest.mark.parametrize("kind", ["local", "filer", "s3", "gcs", "azure", "backblaze"])
def test_same_events_leave_the_same_tree(event_stream, tmp_path, kind):
    """The reference's and the port's replicators apply the same event
    stream through the same kind of sink (for the clouds, each into a
    fake of its own): the two trees are equal, file for file and byte
    for byte, and equal the source's final tree. Both fail on the same
    events (creates whose chunks the source dropped later in the
    stream). One departure: the port's LocalSink leaves no empty file
    where such a create fails."""
    src, dst, events, want = event_stream
    trees, outcomes, fakes = {}, {}, []
    s3 = S3Client(dst.s3_addr, "rk", "rs")
    try:
        for side in ("ref", "port"):
            mod = {"ref": ref_sink, "port": port_sink}[side]
            if kind == "local":
                sink = mod.LocalSink(str(tmp_path / side))
            elif kind == "filer":
                sink = mod.FilerSink(dst.filer_addr, directory=f"/backup-{side}")
            elif kind == "s3":
                s3.create_bucket(f"par-{side}")
                sink = mod.S3Sink(dst.s3_addr, f"par-{side}", "rk", "rs")
            else:
                fakes.append(_CLOUD_FAKES[kind]())
                fakes[-1].start()
                sink = _cloud_sink({"ref": ref_cloud_sinks, "port": port_cloud_sinks}[side],
                                   kind, fakes[-1].endpoint)
            outcomes[side] = _apply(side, events, src.filer_addr, sink)
            if kind == "local":
                trees[side] = local_tree(str(tmp_path / side))
            elif kind == "filer":
                sink.close()
                trees[side] = filer_tree(dst.filer_addr, f"/backup-{side}")
            elif kind == "s3":
                trees[side] = {"/" + k: s3.get_object(f"par-{side}", k)
                               for k in s3.list_objects(f"par-{side}", "")}
            else:
                trees[side] = {"/" + k: v for k, v in fakes[-1].objects.items()}
    finally:
        for fake in fakes:
            fake.stop()
    assert outcomes["port"] == outcomes["ref"]
    assert 0 < sum(o is not None for o in outcomes["port"]) <= 3
    assert trees["port"] == want
    if kind == "local":
        # the reference's LocalSink writes in place, so a create whose
        # chunk is gone leaves an empty file: /gone/x.bin's create comes
        # after its directory's delete here (another partition)
        assert {p: b for p, b in trees["ref"].items() if p in want} == want
        assert {p: b for p, b in trees["ref"].items() if p not in want} == {"/gone/x.bin": b""}
    else:
        assert trees["ref"] == want
    if kind == "backblaze":
        # every version of a deleted file went, in both fakes
        assert all(set(f.versions) == set(f.objects) for f in fakes)


# ----------------------------------------------------------------------
# the runner's switches and what it refuses


def test_weed_repl_0_consumes_nothing(tmp_path, monkeypatch):
    lq = PartitionedLogQueue(str(tmp_path / "lq"), partitions=2)
    for i in range(3):
        lq.send_message(f"/k{i}", fpb.EventNotification(new_entry=fpb.Entry(name=f"e{i}")))
    monkeypatch.setenv("WEED_REPL", "0")
    assert not replicate_runner.repl_enabled()
    assert replicate_runner.run_replicate(stop_after_idle=0.2) == 0
    assert lq.depth("replicate") == 3
    monkeypatch.setenv("WEED_REPL", "1")
    assert replicate_runner.repl_enabled()
    lq.close()


def test_filer_replicate_command_runs_sink_gcs(tmp_path):
    """From the command line, `filer.replicate -config` with sink.gcs
    drains a logqueue into a GCS fake, each file an object under the
    configured directory, and SIGTERM ends it with exit code 0."""
    qdir = tmp_path / "lq"
    (tmp_path / "notification.toml").write_text(
        f'[notification.logqueue]\nenabled = true\ndir = "{qdir}"\npartitions = 2\n')
    lq = PartitionedLogQueue(str(qdir), partitions=2)
    gcs = FakeGcs()
    gcs.start()
    notification.queue = lq
    cluster, proc = None, None
    try:
        cluster = PortCluster(str(tmp_path / "src"))
        files = {f"/buckets/g/d{i % 2}/f{i}.bin": os.urandom(700 * i + 1) for i in range(4)}
        for path, data in files.items():
            post(cluster.filer_addr, path, data)
        (tmp_path / "replication.toml").write_text(
            f'[source.filer]\nenabled = true\ngrpcAddress = "{cluster.filer_addr}"\n'
            f'directory = "/buckets"\n[sink.gcs]\nenabled = true\nbucket = "b"\n'
            f'directory = "m"\nendpoint = "{gcs.endpoint}"\n')
        proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "filer.replicate", "-config",
             str(tmp_path / "replication.toml")], cwd=str(tmp_path),
            env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        want = {"m" + p[len("/buckets"):]: d for p, d in files.items()}

        def drained() -> bool:
            assert proc.poll() is None, proc.stdout.read().decode()[-3000:]
            return dict(gcs.objects) == want and lq.depth("replicate") == 0

        assert wait_for(drained, 60), sorted(gcs.objects)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
    finally:
        notification.queue = None
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(10)
        if cluster is not None:
            cluster.stop()
        gcs.stop()
        lq.close()


def test_replication_modules_import_no_torch():
    """The runner never touches the card: the queues, the brokers' and
    clouds' clients, the replication modules and the command import
    neither torch nor jax."""
    code = ("import sys\n"
            "import seaweedfs_tpu_torch.notification.logqueue\n"
            "import seaweedfs_tpu_torch.notification.kafka\n"
            "import seaweedfs_tpu_torch.notification.kafka_fake\n"
            "import seaweedfs_tpu_torch.notification.cloud_queues\n"
            "import seaweedfs_tpu_torch.replication.cloud_sinks\n"
            "import seaweedfs_tpu_torch.replication.replicate_runner\n"
            "import seaweedfs_tpu_torch.command.filer_tools\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
