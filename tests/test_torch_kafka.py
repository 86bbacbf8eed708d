"""The port's Kafka client, fake broker and the kafka arm of
`filer.replicate` (seaweedfs_tpu_torch/notification/kafka.py,
kafka_fake.py, replication/replicate_runner.py) against the reference's.

The counterpart of tests/test_replication.py's TestKafkaWireProtocol on
the port's modules and port clusters in this process; then the same
seeded records through both packages' record-batch codecs (the bytes
equal, CRC field included, each side reading the other's), the key to
partition router on 10,000 seeded keys, each package's client against
the other's broker, and `filer.replicate -config` as a process of its
own draining a kafka_fake process into a GCS fake: SIGTERM ends it with
exit code 0 and its offsets committed, restarted it uploads nothing
again, and a broker that is down at startup gives the reference's
error. The tolerance is equality. Every wait polls a condition under a
deadline."""

import os
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.notification import kafka as ref_kafka
from seaweedfs_tpu.notification import kafka_fake as ref_kafka_fake
from seaweedfs_tpu.notification import logqueue as ref_logqueue
from seaweedfs_tpu_torch import notification
from seaweedfs_tpu_torch.notification import kafka as port_kafka
from seaweedfs_tpu_torch.notification import kafka_fake as port_kafka_fake
from seaweedfs_tpu_torch.notification import logqueue as port_logqueue
from seaweedfs_tpu_torch.notification.kafka import (
    KafkaClient,
    KafkaError,
    KafkaQueue,
    KafkaSubscriber,
    decode_record_batches,
    encode_record_batch,
)
from seaweedfs_tpu_torch.notification.kafka_fake import FakeKafkaBroker
from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.replication import replicate_runner
from seaweedfs_tpu_torch.replication.replicate_runner import _KafkaOffsetAdapter, _consume_logqueue
from seaweedfs_tpu_torch.replication.replicator import Replicator
from seaweedfs_tpu_torch.replication.sink import LocalSink
from seaweedfs_tpu_torch.replication.source import FilerSource
from seaweedfs_tpu_torch.util.availability import free_port
from seaweedfs_tpu_torch.util.config import Configuration
from tests.cloud_fakes import FakeGcs
from tests.test_torch_replication import REPO, PortCluster, post, two_clusters, wait_for  # noqa: F401


@pytest.fixture()
def broker():
    b = FakeKafkaBroker(partitions=2)
    b.start()
    yield b
    b.stop()


def _records(seed: int, n: int) -> list:
    """`n` (key, value) pairs from `seed`: keys of 0-40 bytes, one in
    five None; values of 0-5000 bytes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        key = None if rng.random() < 0.2 else rng.bytes(int(rng.integers(0, 41)))
        out.append((key, rng.bytes(int(rng.integers(0, 5001)))))
    return out


# ----------------------------------------------------------------------
# TestKafkaWireProtocol on the port


class TestKafkaWireProtocol:
    def test_record_batch_roundtrip(self):
        recs = [(b"k1", b"v1"), (None, b"v2"), (b"k3", b"x" * 3000)]
        blob = encode_record_batch(recs, 1234567890)
        assert decode_record_batches(blob) == [
            (0, b"k1", b"v1"), (1, None, b"v2"), (2, b"k3", b"x" * 3000)]

    def test_api_versions_handshake_accepts_supported(self, broker):
        c = KafkaClient(f"{broker.host}:{broker.port}")
        assert c.metadata("t") == [0, 1]
        assert c._versions_checked
        c.close()

    def test_api_versions_handshake_rejects_unsupported(self, broker):
        broker.api_ranges[0] = (6, 8)  # Produce v6..v8 only (too new)
        c = KafkaClient(f"{broker.host}:{broker.port}")
        with pytest.raises(RuntimeError, match="Produce v3"):
            c.metadata("t")

    def test_api_versions_probe_killed_falls_back(self, broker):
        broker.drop_api_versions = True
        c = KafkaClient(f"{broker.host}:{broker.port}")
        assert c.metadata("t") == [0, 1]
        c.close()

    def test_metadata_produce_fetch_over_socket(self, broker):
        c = KafkaClient(f"{broker.host}:{broker.port}")
        assert c.metadata("t") == [0, 1]
        assert c.produce("t", 0, [(b"a", b"one"), (b"b", b"two")]) == 0
        assert c.produce("t", 0, [(b"c", b"three")]) == 2
        records, high = c.fetch("t", 0, 0)
        assert high == 3
        assert records == [(0, b"a", b"one"), (1, b"b", b"two"), (2, b"c", b"three")]
        records, _ = c.fetch("t", 0, 2)
        assert [(o, v) for o, _k, v in records] == [(2, b"three")]
        c.close()

    def test_queue_gates_on_connectivity(self):
        with pytest.raises(RuntimeError, match="cannot reach a broker"):
            KafkaQueue("127.0.0.1:1")

    def test_configure_builds_kafka_queue(self, broker):
        cfg = Configuration({"notification": {"kafka": {
            "enabled": True, "hosts": f"{broker.host}:{broker.port}", "topic": "filer_events"}}})
        q = notification.configure(cfg)
        try:
            assert isinstance(q, KafkaQueue) and notification.queue is q
            ev = fpb.EventNotification()
            ev.new_entry.name = "via-configure"
            q.send_message("/some/path", ev)
            assert sum(len(v) for v in broker.logs.values()) == 1
        finally:
            q.close()
            notification.queue = None

    def test_replication_e2e_over_kafka(self, broker, two_clusters, tmp_path):  # noqa: F811
        """filer events -> the kafka producer -> the fake broker -> the
        subscriber -> LocalSink, through the drain loop filer.replicate
        uses, with durable consumer-side offsets."""
        src_filer, _, _ = two_clusters
        hosts = f"{broker.host}:{broker.port}"
        notification.queue = KafkaQueue(hosts, topic="filer_events")
        try:
            post(src_filer, "/buckets/kq/z.bin", b"kafka-wire-bytes")
        finally:
            notification.queue.close()
            notification.queue = None
        assert sum(len(v) for v in broker.logs.values()) >= 1
        source = FilerSource(src_filer, directory="/buckets")
        sub = KafkaSubscriber(hosts, topic="filer_events")
        adapter = _KafkaOffsetAdapter(sub, str(tmp_path / "offsets"))
        assert _consume_logqueue(adapter, Replicator(source, LocalSink(str(tmp_path / "mirror"))),
                                 poll_interval=0.05, stop_after_idle=0.3) == 0
        assert (tmp_path / "mirror/kq/z.bin").read_bytes() == b"kafka-wire-bytes"
        sub2 = KafkaSubscriber(hosts, topic="filer_events")
        assert _KafkaOffsetAdapter(sub2, str(tmp_path / "offsets")).poll("replicate") == []
        sub.close()
        sub2.close()
        source.close()

    def test_broker_outage_does_not_fail_filer_writes(self, two_clusters):  # noqa: F811
        """A raising queue (kafka with a dead broker) must not turn a
        stored filer write into a 500 (filer_notify.go logs and goes on)."""
        src_filer, _, _ = two_clusters

        class ExplodingQueue:
            def send_message(self, key, message):
                raise ConnectionError("broker down")

        notification.queue = ExplodingQueue()
        try:
            req = urllib.request.Request(f"http://{src_filer}/buckets/oq/w.bin",
                                         data=b"survives-broker-outage", method="POST")
            with urllib.request.urlopen(req, timeout=10) as r:
                assert r.status in (200, 201)
            with urllib.request.urlopen(f"http://{src_filer}/buckets/oq/w.bin", timeout=10) as r:
                assert r.read() == b"survives-broker-outage"
        finally:
            notification.queue = None

    def test_subscriber_resets_on_offset_out_of_range(self, broker):
        hosts = f"{broker.host}:{broker.port}"
        c = KafkaClient(hosts)
        c.produce("t2", 0, [(b"k", b"v1"), (b"k", b"v2")])
        c.close()
        sub = KafkaSubscriber(hosts, topic="t2")
        sub.offsets[0] = 99
        orig_fetch = sub.client.fetch

        def erroring_fetch(topic, partition, offset, max_bytes=1 << 20):
            if offset == 99:
                raise KafkaError("fetch", KafkaError.OFFSET_OUT_OF_RANGE, 2)
            return orig_fetch(topic, partition, offset, max_bytes)

        sub.client.fetch = erroring_fetch
        assert sub.poll() == []
        assert sub.offsets[0] == 2
        sub.close()


# ----------------------------------------------------------------------
# byte identity with the reference


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 7), (2, 64), (3, 300)])
def test_record_batches_equal_the_references(seed, n):
    """Seeded records encode to the same bytes in both packages, the
    batch CRC-32C included, and each side's decoder reads the other's."""
    recs = _records(seed, n)
    ts = 1_700_000_000_000 + seed
    port_blob = port_kafka.encode_record_batch(recs, ts)
    ref_blob = ref_kafka.encode_record_batch(recs, ts)
    assert port_blob == ref_blob
    want = [(i, k, v) for i, (k, v) in enumerate(recs)]
    assert port_kafka.decode_record_batches(ref_blob) == want
    assert ref_kafka.decode_record_batches(port_blob) == want
    # two batches back to back, the second rebased as the fake broker does
    two = port_blob + port_blob
    assert port_kafka.decode_record_batches(two) == ref_kafka.decode_record_batches(two)


@pytest.mark.parametrize("partitions", range(1, 9))
def test_partition_of_equals_the_references(partitions):
    """The key to partition router sends 10,000 seeded keys (filer paths
    and random text) where the reference's sends them."""
    rng = np.random.default_rng(100 + partitions)
    keys = [f"/d{int(rng.integers(0, 50))}/f{i}.bin" for i in range(5000)]
    keys += ["".join(chr(int(c)) for c in rng.integers(32, 0x2FF, int(rng.integers(0, 30))))
             for _ in range(5000)]
    got = [port_logqueue._partition_of(k, partitions) for k in keys]
    assert got == [ref_logqueue._partition_of(k, partitions) for k in keys]
    assert port_kafka._partition_of is port_logqueue._partition_of
    if partitions > 1:
        assert len(set(got)) == partitions


@pytest.mark.parametrize("client_side", ["port", "ref"])
def test_cross_wire_produce_and_fetch(client_side):
    """One package's client produces to and fetches from the other's
    broker: the base offsets, the high watermarks and the records equal
    those of the same calls against the client's own package's broker."""
    mods = {"port": (port_kafka, port_kafka_fake), "ref": (ref_kafka, ref_kafka_fake)}
    other = "ref" if client_side == "port" else "port"
    client_mod = mods[client_side][0]
    results = {}
    for broker_side in (client_side, other):
        b = mods[broker_side][1].FakeKafkaBroker(partitions=3)
        b.start()
        c = client_mod.KafkaClient(f"{b.host}:{b.port}")
        try:
            parts = c.metadata("xw")
            bases = [c.produce("xw", p, _records(10 * p + i, 1 + 5 * i))
                     for p in parts for i in range(3)]
            fetched = [c.fetch("xw", p, off) for p in parts for off in (0, 4)]
            results[broker_side] = (parts, bases, fetched)
        finally:
            c.close()
            b.stop()
    assert results["port"] == results["ref"]
    parts, bases, fetched = results[other]
    assert parts == [0, 1, 2] and bases == [0, 1, 7] * 3
    assert [high for _, high in fetched] == [18] * 6


# ----------------------------------------------------------------------
# the kafka arm of filer.replicate


def test_kafka_arm_polls_without_a_depth(broker, tmp_path):
    """The adapter has no `depth`: the drain loop samples the lag only
    where the queue has one, so several polls of an empty and then a
    filled topic run through without AttributeError."""
    hosts = f"{broker.host}:{broker.port}"
    sub = KafkaSubscriber(hosts, topic="lagless")
    adapter = _KafkaOffsetAdapter(sub, str(tmp_path / "off"))
    assert not hasattr(adapter, "depth")
    applied = []

    class Recorder:
        def replicate(self, key, msg):
            applied.append((key, msg.new_entry.name))

    try:
        assert _consume_logqueue(adapter, Recorder(), 0.02, 0.2) == 0
        q = KafkaQueue(hosts, topic="lagless")
        for i in range(5):
            q.send_message(f"/k{i}", fpb.EventNotification(new_entry=fpb.Entry(name=f"e{i}")))
        q.close()
        assert _consume_logqueue(adapter, Recorder(), 0.02, 0.2) == 0
    finally:
        sub.close()
    assert sorted(applied) == [(f"/k{i}", f"e{i}") for i in range(5)]
    offsets = {p: int(open(tmp_path / "off" / f"p{p:03d}").read())
               for p in (0, 1) if (tmp_path / "off" / f"p{p:03d}").exists()}
    assert sum(offsets.values()) == 5


def test_kafka_arm_names_a_broker_that_is_down(tmp_path, monkeypatch):
    """A broker that is down when the runner starts: the reference's
    error, naming the hosts and the in-repo fake to start."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "notification.toml").write_text(
        '[notification.kafka]\nenabled = true\nhosts = "127.0.0.1:1"\n')
    (tmp_path / "replication.toml").write_text(
        '[source.filer]\nenabled = true\ngrpcAddress = "127.0.0.1:1"\ndirectory = "/b"\n'
        f'[sink.local]\nenabled = true\ndirectory = "{tmp_path / "m"}"\n')
    with pytest.raises(RuntimeError, match=r"filer\.replicate cannot reach a kafka broker at "
                       r"'127\.0\.0\.1:1'.*seaweedfs_tpu_torch\.notification\.kafka_fake"):
        replicate_runner.run_replicate(config_path=str(tmp_path / "replication.toml"),
                                       stop_after_idle=0.2)


def _spawn(args, cwd, log):
    return subprocess.Popen([sys.executable, "-m"] + args, cwd=str(cwd),
                            env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=log,
                            stderr=subprocess.STDOUT)


def test_filer_replicate_drains_kafka_into_gcs_and_resumes(tmp_path):
    """`filer.replicate -config` with notification.toml's kafka arm, as a
    process, against a kafka_fake process and sink.gcs at FakeGcs: it
    drains the topic (every file an object, byte for byte), SIGTERM
    ends it with 0 and its offset files at the broker's high
    watermarks, and restarted it uploads only the file written
    meanwhile."""
    kport = free_port()
    log = open(tmp_path / "procs.log", "wb")
    procs = {"broker": _spawn(["seaweedfs_tpu_torch.notification.kafka_fake", str(kport), "4"],
                              tmp_path, log)}
    gcs = FakeGcs()
    puts = []
    gcs.objects = type("Objects", (dict,), {
        "__setitem__": lambda self, k, v: (puts.append(k), dict.__setitem__(self, k, v))})()
    gcs.start()
    cluster = None
    hosts = f"127.0.0.1:{kport}"

    def broker_up() -> bool:
        c = KafkaClient(hosts)
        try:
            return c.metadata("seaweedfs_filer") == [0, 1, 2, 3]
        except OSError:
            return False
        finally:
            c.close()

    try:
        assert wait_for(broker_up, 30), open(tmp_path / "procs.log").read()
        notification.queue = KafkaQueue(hosts)
        cluster = PortCluster(str(tmp_path / "src"))
        rng = np.random.default_rng(23)
        files = {f"/buckets/k/d{i % 3}/f{i}.bin": rng.bytes(int(rng.integers(1, 300_000)))
                 for i in range(9)}
        for path, data in files.items():
            post(cluster.filer_addr, path, data)
        (tmp_path / "notification.toml").write_text(
            f'[notification.kafka]\nenabled = true\nhosts = "{hosts}"\n'
            f'offset_dir = "{tmp_path / "offsets"}"\n')
        (tmp_path / "replication.toml").write_text(
            f'[source.filer]\nenabled = true\ngrpcAddress = "{cluster.filer_addr}"\n'
            f'directory = "/buckets"\n[sink.gcs]\nenabled = true\nbucket = "b"\n'
            f'directory = "mirror"\nendpoint = "{gcs.endpoint}"\n')
        want = {"mirror" + p[len("/buckets"):]: d for p, d in files.items()}
        runner = ["seaweedfs_tpu_torch", "filer.replicate", "-config",
                  str(tmp_path / "replication.toml")]

        def drained() -> bool:
            assert procs["runner"].poll() is None, open(tmp_path / "procs.log").read()[-3000:]
            return dict(gcs.objects) == want

        procs["runner"] = _spawn(runner, tmp_path, log)
        assert wait_for(drained, 60), sorted(gcs.objects)
        procs["runner"].send_signal(signal.SIGTERM)
        assert procs["runner"].wait(30) == 0
        c = KafkaClient(hosts)
        highs = {p: c.fetch("seaweedfs_filer", p, 0)[1] for p in c.metadata("seaweedfs_filer")}
        c.close()
        committed = {p: int((tmp_path / "offsets" / f"p{p:03d}").read_text())
                     for p in highs if (tmp_path / "offsets" / f"p{p:03d}").exists()}
        assert committed == {p: h for p, h in highs.items() if h}
        uploads = len(puts)
        assert uploads == len(files)
        procs["runner"] = _spawn(runner, tmp_path, log)
        late = "/buckets/k/late.bin"
        files[late] = b"written after the restart"
        want["mirror/k/late.bin"] = files[late]
        post(cluster.filer_addr, late, files[late])
        assert wait_for(drained, 60), sorted(gcs.objects)
        assert puts[uploads:] == ["mirror/k/late.bin"]
        procs["runner"].send_signal(signal.SIGTERM)
        assert procs["runner"].wait(30) == 0
        procs["broker"].send_signal(signal.SIGTERM)
        assert procs["broker"].wait(30) == 0
    finally:
        if notification.queue is not None:
            notification.queue.close()
            notification.queue = None
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(10)
        if cluster is not None:
            cluster.stop()
        gcs.stop()
        log.close()
