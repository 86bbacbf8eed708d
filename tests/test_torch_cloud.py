"""The port's cloud replication sinks and cloud notification queues
(seaweedfs_tpu_torch/replication/cloud_sinks.py,
notification/cloud_queues.py) against the reference's, over the
in-repo protocol fakes (tests/cloud_fakes.py).

The counterparts of tests/test_replication.py's TestCloudSinks and
TestCloudQueues on the port's modules and port clusters in this process;
then `build_replicator` building each cloud sink from a replication.toml
(and refusing missing credentials with the reference's messages), the
same event sent through both packages' SqsQueue and PubSubQueue into
two fakes (the decoded bodies equal), and chip_smoke.py's phase 3n
rehearsed on the host codec. The tolerance is equality."""

import base64

import pytest
from google.protobuf import text_format

from seaweedfs_tpu.notification import cloud_queues as ref_cloud_queues
from seaweedfs_tpu.replication import replicate_runner as ref_runner
from seaweedfs_tpu.util.config import Configuration as RefConfiguration
from seaweedfs_tpu_torch import notification
from seaweedfs_tpu_torch.notification import cloud_queues as port_cloud_queues
from seaweedfs_tpu_torch.notification.cloud_queues import PubSubQueue, SqsQueue
from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.replication import cloud_sinks
from seaweedfs_tpu_torch.replication.cloud_sinks import AzureSink, B2Sink, GcsSink
from seaweedfs_tpu_torch.replication.replicate_runner import build_replicator
from seaweedfs_tpu_torch.replication.replicator import Replicator
from seaweedfs_tpu_torch.replication.source import FilerSource
from seaweedfs_tpu_torch.util.config import Configuration
from tests.cloud_fakes import FakeAzure, FakeB2, FakeGcs, FakePubSub, FakeSqs
from tests.test_torch_replication import REPO, _drain, delete, post, two_clusters  # noqa: F401

AZURE_KEY = base64.b64encode(b"azure-secret-key-32-bytes-long!!").decode()


@pytest.fixture()
def fakes():
    """One started fake of each cloud kind."""
    started = {"gcs": FakeGcs(), "azure": FakeAzure("acct1", AZURE_KEY, "cont"),
               "backblaze": FakeB2("keyid", "appkey", "bkt2"),
               "sqs": FakeSqs("AKID", "SECRET", "us-east-1", "weedq"),
               "pubsub": FakePubSub("proj1", "weedtopic")}
    for f in started.values():
        f.start()
    yield started
    for f in started.values():
        f.stop()


# ----------------------------------------------------------------------
# TestCloudSinks on the port


class TestCloudSinks:
    def _drive(self, two_clusters, sink, fake, tag):  # noqa: F811
        src_filer, _, qdir = two_clusters
        notification.queue = notification.DirQueue(qdir)
        try:
            for name, data in (("a.bin", b"alpha-" * 100), ("sub/b.bin", b"beta")):
                post(src_filer, f"/buckets/{tag}/{name}", data)
        finally:
            notification.queue = None
        source = FilerSource(src_filer, directory="/buckets")
        replicator = Replicator(source, sink)
        try:
            assert _drain(qdir, replicator) >= 2
            assert fake.objects[f"{tag}/a.bin"] == b"alpha-" * 100
            assert fake.objects[f"{tag}/sub/b.bin"] == b"beta"
            notification.queue = notification.DirQueue(qdir)
            try:
                delete(src_filer, f"/buckets/{tag}", recursive=True)
            finally:
                notification.queue = None
            _, key, msg = list(notification.DirQueue(qdir).consume())[-1]
            replicator.replicate(key, msg)
            assert not any(k.startswith(f"{tag}/") for k in fake.objects), fake.objects
        finally:
            source.close()

    def test_gcs_sink(self, two_clusters, fakes):  # noqa: F811
        fake = fakes["gcs"]
        self._drive(two_clusters, GcsSink("bkt", token="t0k", endpoint=fake.endpoint), fake,
                    "gcs")

    def test_azure_sink_with_shared_key_signing(self, two_clusters, fakes):  # noqa: F811
        fake = fakes["azure"]
        self._drive(two_clusters, AzureSink("acct1", AZURE_KEY, "cont", endpoint=fake.endpoint),
                    fake, "az")
        bad = AzureSink("acct1", base64.b64encode(b"wrong-key").decode(), "cont",
                        endpoint=fake.endpoint)
        with pytest.raises(RuntimeError, match="http 403"):
            bad._put("x", b"y")

    def test_b2_sink(self, two_clusters, fakes):  # noqa: F811
        fake = fakes["backblaze"]
        self._drive(two_clusters, B2Sink("keyid", "appkey", "bkt2", endpoint=fake.endpoint),
                    fake, "b2")

    def test_azure_b2_gate_on_missing_credentials(self):
        for kind, needle in (("azure", "account_key"), ("backblaze", "application_key")):
            cfg = Configuration({"source": {"filer": {"grpcAddress": "x:1"}},
                                 "sink": {kind: {"enabled": True}}})
            with pytest.raises(RuntimeError, match=needle):
                build_replicator(cfg)

    def test_b2_delete_removes_all_versions(self, fakes):
        fake = fakes["backblaze"]
        sink = B2Sink("keyid", "appkey", "bkt2", endpoint=fake.endpoint)
        sink._put("f.bin", b"v1")
        sink._put("f.bin", b"v2")
        assert len(fake.versions["f.bin"]) == 2
        sink._delete("f.bin")
        assert "f.bin" not in fake.objects and "f.bin" not in fake.versions

    def test_list_pagination_sweeps_every_page(self, fakes):
        gcs, b2 = fakes["gcs"], fakes["backblaze"]
        gcs.page_size = b2.page_size = 2
        sink = GcsSink("bkt", token="t", endpoint=gcs.endpoint)
        for i in range(7):
            gcs.objects[f"d/{i}.bin"] = b"x"
        assert len(sink._list("d/")) == 7
        sink2 = B2Sink("keyid", "appkey", "bkt2", endpoint=b2.endpoint)
        for i in range(7):
            sink2._put(f"d/{i}.bin", b"x")
        assert len(sink2._list("d/")) == 7

    def test_azure_list_pagination(self, fakes):
        fake = fakes["azure"]
        fake.page_size = 2
        sink = AzureSink("acct1", AZURE_KEY, "cont", endpoint=fake.endpoint)
        for i in range(5):
            sink._put(f"d/{i} sp.bin", b"x")  # a space: the encoded path is signed
        assert len(sink._list("d/")) == 5


# ----------------------------------------------------------------------
# TestCloudQueues on the port


class TestCloudQueues:
    def test_sqs_queue_sends_signed_messages(self, fakes):
        fake = fakes["sqs"]
        q = notification.configure(Configuration({"notification": {"aws_sqs": {
            "enabled": True, "aws_access_key_id": "AKID", "aws_secret_access_key": "SECRET",
            "region": "us-east-1", "sqs_queue_name": "weedq", "endpoint": fake.endpoint}}}))
        try:
            assert isinstance(q, SqsQueue) and notification.queue is q
            ev = fpb.EventNotification()
            ev.new_entry.name = "sqs-file"
            q.send_message("/buckets/sqs-file", ev)
            key, body = fake.messages[0]
            assert key == "/buckets/sqs-file" and "sqs-file" in body
        finally:
            notification.queue = None

    def test_sqs_wrong_secret_rejected(self, fakes):
        with pytest.raises(RuntimeError, match="http 403"):
            SqsQueue("AKID", "WRONG", "us-east-1", "weedq", endpoint=fakes["sqs"].endpoint)

    def test_pubsub_queue_publishes(self, fakes):
        fake = fakes["pubsub"]
        q = notification.configure(Configuration({"notification": {"google_pub_sub": {
            "enabled": True, "project_id": "proj1", "topic": "weedtopic",
            "endpoint": fake.endpoint}}}))
        try:
            assert isinstance(q, PubSubQueue) and notification.queue is q
            ev = fpb.EventNotification()
            ev.new_entry.name = "ps-file"
            q.send_message("/buckets/ps-file", ev)
            key, data = fake.messages[0]
            assert key == "/buckets/ps-file"
            assert fpb.EventNotification.FromString(data).new_entry.name == "ps-file"
        finally:
            notification.queue = None

    def test_pubsub_gates_without_token_on_real_endpoint(self):
        with pytest.raises(RuntimeError, match="bearer"):
            PubSubQueue("p", "t")


# ----------------------------------------------------------------------
# against the reference


def _event(seed: int) -> fpb.EventNotification:
    ev = fpb.EventNotification(delete_chunks=bool(seed % 2), new_parent_path=f"/b/d{seed}")
    ev.new_entry.name = f"f{seed} é&.bin"
    ev.new_entry.attributes.file_size = 1000 + seed
    for i in range(seed % 4):
        ev.new_entry.chunks.add(fid=f"{seed},{i:x}0a1b2c3d", offset=i << 20, size=1 << 20)
    if seed % 3 == 0:
        ev.old_entry.name = f"old{seed}"
    return ev


@pytest.mark.parametrize("kind", ["sqs", "pubsub"])
def test_queues_deliver_what_the_references_deliver(kind):
    """The same events through both packages' queue into two fakes: the
    keys and the decoded bodies equal (SQS: the text-proto form, signed
    with SigV4; Pub/Sub: the serialized proto under a Bearer token)."""
    got = {}
    for side, mod in (("ref", ref_cloud_queues), ("port", port_cloud_queues)):
        if kind == "sqs":
            fake = FakeSqs("AKID", "SECRET", "eu-west-1", "weedq")
            fake.start()
            q = mod.SqsQueue("AKID", "SECRET", "eu-west-1", "weedq", endpoint=fake.endpoint)
        else:
            fake = FakePubSub("proj1", "weedtopic")
            fake.start()
            q = mod.PubSubQueue("proj1", "weedtopic", token="tok", endpoint=fake.endpoint)
        try:
            for seed in range(6):
                q.send_message(f"/buckets/d{seed}/f{seed} é&.bin", _event(seed))
        finally:
            fake.stop()
        if kind == "sqs":
            got[side] = [(k, text_format.Parse(b, fpb.EventNotification()).SerializeToString())
                         for k, b in fake.messages]
        else:
            got[side] = [(k, fpb.EventNotification.FromString(d).SerializeToString())
                         for k, d in fake.messages]
    assert got["port"] == got["ref"]
    assert got["port"] == [(f"/buckets/d{s}/f{s} é&.bin", _event(s).SerializeToString())
                           for s in range(6)]


def _sink_cfg(kind: str, endpoint: str, **over) -> dict:
    base = {"gcs": {"bucket": "bkt", "token": "t0k", "directory": "g"},
            "azure": {"account_name": "acct1", "account_key": AZURE_KEY, "container": "cont",
                      "directory": "a"},
            "backblaze": {"b2_account_id": "keyid", "b2_master_application_key": "appkey",
                          "bucket": "bkt2", "directory": "b"}}[kind]
    body = dict(base, enabled=True, **over)
    if endpoint:
        body["endpoint"] = endpoint
    return {"source": {"filer": {"grpcAddress": "127.0.0.1:1", "directory": "/buckets"}},
            "sink": {kind: body}}


@pytest.mark.parametrize("kind", ["gcs", "azure", "backblaze"])
def test_build_replicator_builds_each_cloud_sink(kind, fakes):
    """A replication.toml that enables a cloud sink builds it, as the
    reference's builds its own, over the same fake."""
    cfg = _sink_cfg(kind, fakes[kind].endpoint)
    port_rep = build_replicator(Configuration(cfg))
    ref_rep = ref_runner.build_replicator(RefConfiguration(cfg))
    try:
        cls = {"gcs": GcsSink, "azure": AzureSink, "backblaze": B2Sink}[kind]
        assert type(port_rep.sink) is cls and cls.__module__ == cloud_sinks.__name__
        assert port_rep.sink.name == ref_rep.sink.name == kind
        assert port_rep.sink.dir == ref_rep.sink.dir == cfg["sink"][kind]["directory"]
        assert port_rep.sink.source is port_rep.source
        port_rep.sink._put("probe.bin", b"built")
        assert fakes[kind].objects["probe.bin"] == b"built"
    finally:
        port_rep.source.close()
        ref_rep.source.close()


@pytest.mark.parametrize("kind,over", [
    ("gcs", {"token": ""}),
    ("azure", {"account_key": ""}),
    ("backblaze", {"b2_master_application_key": ""}),
])
def test_cloud_sink_without_credentials_raises_the_references_error(kind, over):
    """Missing credentials (for GCS: no token at Google's endpoint) raise
    the reference's RuntimeError, word for word, before any dial."""
    cfg = _sink_cfg(kind, "", **over)
    with pytest.raises(RuntimeError) as ref_err:
        ref_runner.build_replicator(RefConfiguration(cfg))
    with pytest.raises(RuntimeError) as port_err:
        build_replicator(Configuration(cfg))
    assert str(port_err.value) == str(ref_err.value)
    assert "replication/cloud_sinks.py" in str(port_err.value)


def test_chip_smoke_cloud_phase_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 3n at 16 MiB of files and a 4 MiB big one on
    the host codec: the broker's high watermarks equal to the filer's
    events, three runners draining the topic into GCS, Azure and B2 with
    a shard holder lost (every object SHA-256 equal), a directory delete
    carried into all three, the GCS runner's restart uploading only the
    late file, SQS and Pub/Sub each accepting 32 messages, no filer,
    runner or broker mapping libcuda or torch, every process ending
    with 0."""
    import sys

    sys.path.insert(0, REPO)
    import chip_smoke

    runs = chip_smoke.run_cloud_phase(str(tmp_path), 16 << 20, 0, device="cpu", card="cpu",
                                      big_bytes=4 << 20)
    cloud = runs["cloud"]
    assert cloud["touched"] > 0 and cloud["events"] > cloud["files"]
    assert cloud["queues"] == {"sqs": 32, "pubsub": 32}
    assert runs["cloud_degraded"]["files"] == cloud["files"]
    assert set(cloud["walls"]) >= {"a_up", "b_fill", "c_encode_balance", "e_drain",
                                   "f_delete", "g_restart", "h_queues"}


def test_chip_smoke_accepts_a_directory_created_twice_and_no_file_twice():
    """Phase 3n's check of the topic against the filer's tree: two writers
    that find a directory missing both create and announce it, so a
    directory may come twice; a file twice, an entry without an event, an
    event without an entry or an event that is no creation is a fault.
    The filer's own mkdir race is run too: every event it sends passes."""
    import sys
    import threading

    from seaweedfs_tpu_torch.filer.entry import Entry
    from seaweedfs_tpu_torch.filer.filer import Filer
    from seaweedfs_tpu_torch.filer.filerstore import MemoryStore

    sys.path.insert(0, REPO)
    import chip_smoke

    looked_up = threading.Barrier(4)

    class RacingStore(MemoryStore):
        def find_entry(self, full_path):
            try:
                return super().find_entry(full_path)
            finally:
                if full_path == "/cloud":  # every writer finds it missing
                    looked_up.wait(timeout=30)

    published = []

    def on_event(old, new, delete_chunks):
        msg = fpb.EventNotification(delete_chunks=delete_chunks)
        if old is not None:
            msg.old_entry.CopyFrom(old.to_pb())
        if new is not None:
            msg.new_entry.CopyFrom(new.to_pb())
            msg.new_parent_path = new.directory
        published.append(((old or new).full_path, msg))

    filer = Filer(RacingStore(), on_event=on_event)
    start = threading.Barrier(4)

    def write(i):
        start.wait()
        filer.create_entry(Entry(f"/cloud/d0/f{i}"))

    writers = [threading.Thread(target=write, args=(i,)) for i in range(4)]
    for t in writers:
        t.start()
    for t in writers:
        t.join()
    entries = {"/cloud": True, "/cloud/d0": True, **{f"/cloud/d0/f{i}": False for i in range(4)}}
    fault = chip_smoke._creation_events_fault
    assert [k for k, _ in published].count("/cloud") == 4
    assert fault(published, entries) is None
    file_event = next(e for e in published if e[0] == "/cloud/d0/f0")
    assert "files announced more than once" in fault(published + [file_event], entries)
    assert "have no event" in fault(published, {**entries, "/cloud/d1": True})
    assert "are no entry" in fault(published, {k: v for k, v in entries.items()
                                               if k != "/cloud/d0/f3"})
    update = fpb.EventNotification()
    update.CopyFrom(file_event[1])
    update.old_entry.CopyFrom(update.new_entry)
    assert "not the creation" in fault(published + [("/cloud/d0/f0", update)], entries)
