"""The port's partitioned log queue (seaweedfs_tpu_torch/notification/
logqueue.py) against the reference's (seaweedfs_tpu/notification/
logqueue.py): the counterparts of the reference's TestPartitionedLogQueue
(tests/test_replication.py), then the cross-package cases. Either package
reads a queue directory the other wrote, and the same appends, with the
clock in the record header held, give the same bytes on disk."""

import os
import threading
import time
import types
import urllib.request

import pytest

from seaweedfs_tpu.analysis import crash as ref_crash
from seaweedfs_tpu.notification import logqueue as ref_lq
from seaweedfs_tpu.pb import filer_pb2 as ref_fpb
from seaweedfs_tpu_torch import notification
from seaweedfs_tpu_torch.notification import logqueue as port_lq
from seaweedfs_tpu_torch.notification.logqueue import PartitionedLogQueue, _partition_of
from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.replication import replicate_runner
from seaweedfs_tpu_torch.replication.replicate_runner import _consume_logqueue
from seaweedfs_tpu_torch.replication.replicator import Replicator
from seaweedfs_tpu_torch.replication.sink import LocalSink
from seaweedfs_tpu_torch.replication.source import FilerSource
from seaweedfs_tpu_torch.util.config import Configuration

from tests.test_torch_replication import PortCluster, post

LQ = {"ref": ref_lq, "port": port_lq}
PB = {"ref": ref_fpb, "port": fpb}


def _mk(tmp_path, **kw):
    return PartitionedLogQueue(str(tmp_path / "q"), **kw)


def _event(name: str, side: str = "port"):
    ev = PB[side].EventNotification()
    ev.new_entry.name = name
    return ev


def _segments(part_dir) -> set:
    return {n for n in os.listdir(part_dir) if n.endswith(".seg")}


def test_poll_commit_resume(tmp_path):
    q = _mk(tmp_path, partitions=2)
    for i in range(10):
        q.send_message(f"/k{i}", _event(f"e{i}"))
    assert q.depth("replicate") == 10

    got = q.poll("replicate", max_records=4)
    assert len(got) == 4
    high = {}
    for part, off, key, msg in got:
        high[part] = off + 1
    for part, n in high.items():
        q.commit("replicate", part, n)
    rest = q.poll("replicate", max_records=100)
    assert len(rest) == 6
    seen = {m.new_entry.name for *_, m in got} | {m.new_entry.name for *_, m in rest}
    assert seen == {f"e{i}" for i in range(10)}
    for part, off, key, msg in rest:
        q.commit("replicate", part, off + 1)
    assert q.poll("replicate") == []
    assert q.depth("replicate") == 0
    q.close()


def test_key_order_within_partition_and_groups_independent(tmp_path):
    q = _mk(tmp_path, partitions=4)
    for i in range(6):
        q.send_message("/same/key", _event(f"v{i}"))
    got = q.poll("a", max_records=100)
    assert len({part for part, *_ in got}) == 1
    assert [m.new_entry.name for *_, m in got] == [f"v{i}" for i in range(6)]
    for part, off, _, _ in got:
        q.commit("a", part, off + 1)
    assert len(q.poll("b", max_records=100)) == 6
    q.close()


def test_durable_across_reopen(tmp_path):
    q = _mk(tmp_path, partitions=2)
    for i in range(5):
        q.send_message(f"/k{i}", _event(f"e{i}"))
    got = q.poll("g", max_records=2)
    for part, off, _, _ in got:
        q.commit("g", part, off + 1)
    q.close()

    q2 = _mk(tmp_path, partitions=2)
    rest = q2.poll("g", max_records=100)
    assert len(rest) == 3
    names = {m.new_entry.name for *_, m in got} | {m.new_entry.name for *_, m in rest}
    assert names == {f"e{i}" for i in range(5)}
    q2.send_message("/k9", _event("e9"))
    assert q2.depth("g") == 4
    q2.close()


def test_segment_roll_and_trim(tmp_path):
    q = _mk(tmp_path, partitions=1, segment_bytes=256)
    for i in range(30):
        q.send_message("/k", _event(f"payload-{i:04d}"))
    part_dir = tmp_path / "q" / "p000"
    segs = _segments(part_dir)
    assert len(segs) > 1, "segments never rolled at 256B"
    assert len(q.poll("g", max_records=1000)) == 30
    q.commit("g", 0, 30)
    assert q.trim() >= 1
    assert len(_segments(part_dir)) < len(segs)
    q.close()


def test_corrupt_record_cut(tmp_path):
    q = _mk(tmp_path, partitions=1)
    for i in range(3):
        q.send_message("/k", _event(f"e{i}"))
    q.close()
    part_dir = tmp_path / "q" / "p000"
    seg = os.path.join(part_dir, next(iter(_segments(part_dir))))
    raw = open(seg, "rb").read()
    with open(seg, "wb") as f:  # flip a byte in the last record
        f.write(raw[:-2] + bytes([raw[-2] ^ 0xFF]) + raw[-1:])
    q2 = _mk(tmp_path, partitions=1)
    got = q2.poll("g", max_records=100)
    assert [m.new_entry.name for *_, m in got] == ["e0", "e1"]
    q2.close()


def test_failed_replicate_redelivers_then_succeeds(tmp_path):
    """At-least-once: an event whose replicate() raises is not committed
    past; the next poll redelivers it, in order behind the failure."""
    q = _mk(tmp_path, partitions=1)
    for i in range(3):
        q.send_message("/k", _event(f"e{i}"))

    class Flaky:
        def __init__(self):
            self.done, self.failures = [], 0

        def replicate(self, key, msg):
            if msg.new_entry.name == "e1" and self.failures < 2:
                self.failures += 1
                raise RuntimeError("sink down")
            self.done.append(msg.new_entry.name)

    r = Flaky()
    assert _consume_logqueue(q, r, poll_interval=0.01, stop_after_idle=0.3) == 0
    assert r.done == ["e0", "e1", "e2"]
    assert r.failures == 2
    assert q.committed("replicate", 0) == 3
    q.close()


def test_poison_event_skipped_after_max_retries(tmp_path):
    q = _mk(tmp_path, partitions=1)
    q.send_message("/k", _event("poison"))
    q.send_message("/k", _event("after"))

    class AlwaysFails:
        def __init__(self):
            self.done, self.attempts = [], 0

        def replicate(self, key, msg):
            if msg.new_entry.name == "poison":
                self.attempts += 1
                raise RuntimeError("boom")
            self.done.append(msg.new_entry.name)

    r = AlwaysFails()
    assert _consume_logqueue(q, r, poll_interval=0.0, stop_after_idle=5.0) == 0
    assert r.attempts == replicate_runner._MAX_EVENT_RETRIES == 8
    assert r.done == ["after"]
    assert q.committed("replicate", 0) == 2
    q.close()


def test_trim_protects_group_that_polled_but_not_committed(tmp_path):
    q = _mk(tmp_path, partitions=1, segment_bytes=256)
    for i in range(30):
        q.send_message("/k", _event(f"payload-{i:04d}"))
    part_dir = tmp_path / "q" / "p000"
    segs = _segments(part_dir)
    assert len(segs) > 1
    assert len(q.poll("slow", max_records=5)) == 5  # polls, never commits
    assert len(q.poll("fast", max_records=1000)) == 30
    q.commit("fast", 0, 30)
    assert q.trim() == 0, "trim deleted segments an active group hasn't read"
    assert _segments(part_dir) == segs
    assert len(q.poll("slow", max_records=1000)) == 30
    q.close()


def test_trim_unpins_abandoned_group_after_staleness(tmp_path):
    """A group whose cursor has not been touched for stale_group_seconds
    stops pinning retention. Its cursor's mtime is set back rather than
    waited for."""
    q = _mk(tmp_path, partitions=1, segment_bytes=256, stale_group_seconds=30.0)
    for i in range(30):
        q.send_message("/k", _event(f"payload-{i:04d}"))
    part_dir = tmp_path / "q" / "p000"
    segs = _segments(part_dir)
    q.poll("abandoned", max_records=5)  # registers, never returns
    q.poll("live", max_records=1000)
    q.commit("live", 0, 30)
    assert q.trim() == 0  # abandoned still fresh: protected
    old = time.time() - 60.0
    os.utime(part_dir / "offsets" / "abandoned", (old, old))
    assert q.trim() >= 1
    assert len(_segments(part_dir)) < len(segs)
    q.close()


def test_configure_builds_logqueue(tmp_path):
    cfg = Configuration({"notification": {"logqueue": {
        "enabled": True, "dir": str(tmp_path / "nq"), "partitions": "2"}}})
    q = notification.configure(cfg)
    try:
        assert isinstance(q, PartitionedLogQueue) and notification.queue is q
        assert len(q.partitions) == 2
    finally:
        q.close()
        notification.queue = None


def test_end_to_end_local_sink(tmp_path):
    """filer events -> logqueue -> the consumer-group drain
    filer.replicate runs -> LocalSink, over a port cluster."""
    qdir = str(tmp_path / "lq")
    notification.queue = PartitionedLogQueue(qdir, partitions=2)
    try:
        cluster = PortCluster(str(tmp_path / "src"))
    finally:
        notification.queue.close()
        notification.queue = None
    try:
        notification.queue = PartitionedLogQueue(qdir, partitions=2)
        try:
            post(cluster.filer_addr, "/buckets/lq/y.bin", b"logqueue-bytes")
        finally:
            notification.queue.close()
            notification.queue = None
        source = FilerSource(cluster.filer_addr, directory="/buckets")
        lq = PartitionedLogQueue(qdir, partitions=2)
        try:
            _consume_logqueue(lq, Replicator(source, LocalSink(str(tmp_path / "mirror"))),
                              poll_interval=0.05, stop_after_idle=0.3)
            assert (tmp_path / "mirror/lq/y.bin").read_bytes() == b"logqueue-bytes"
            assert lq.depth("replicate") == 0
        finally:
            lq.close()
            source.close()
    finally:
        cluster.stop()


def test_consumer_sees_segments_rolled_after_open(tmp_path):
    producer = _mk(tmp_path, partitions=1, segment_bytes=128)
    producer.send_message("/k", _event("early"))
    consumer = _mk(tmp_path, partitions=1, segment_bytes=128)
    assert len(consumer.poll("g", max_records=100)) == 1
    consumer.commit("g", 0, 1)
    for i in range(12):
        producer.send_message("/k", _event(f"late-{i:02d}"))
    got = consumer.poll("g", max_records=100)
    assert [m.new_entry.name for *_, m in got] == [f"late-{i:02d}" for i in range(12)]
    assert consumer.depth("g") == 12
    consumer.close()
    producer.close()


def test_partition_count_pinned_by_meta(tmp_path):
    q4 = _mk(tmp_path, partitions=4)
    for i in range(8):
        q4.send_message(f"/k{i}", _event(f"e{i}"))
    q4.close()
    q2 = _mk(tmp_path, partitions=2)
    assert len(q2.partitions) == 4
    assert len(q2.poll("g", max_records=100)) == 8
    q2.close()


def test_poll_fairness_hot_partition(tmp_path):
    q = _mk(tmp_path, partitions=2)
    k0 = next(f"/a{i}" for i in range(100) if _partition_of(f"/a{i}", 2) == 0)
    k1 = next(f"/b{i}" for i in range(100) if _partition_of(f"/b{i}", 2) == 1)
    for i in range(50):
        q.send_message(k0, _event(f"hot-{i}"))
    q.send_message(k1, _event("cold"))
    got = q.poll("g", max_records=10)
    assert 1 in {p for p, *_ in got}, "hot partition starved the cold one"
    assert len(got) == 10, "leftover budget not refilled from the hot partition"
    q.close()


def test_concurrent_producer_and_consumer_threads(tmp_path):
    """One producer thread appending while a consumer thread polls and
    commits on the same queue object: at-least-once, no loss, order
    kept per key."""
    q = _mk(tmp_path, partitions=2, segment_bytes=512)
    total = 300
    got: list = []
    errors: list = []
    produced_all = threading.Event()

    def producer():
        try:
            for i in range(total):
                q.send_message(f"/k{i % 5}", _event(f"m{i:04d}"))
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        finally:
            produced_all.set()

    def consumer():
        try:
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                batch = q.poll("g", max_records=32)
                if not batch:
                    if produced_all.is_set() and q.depth("g") == 0:
                        return
                    produced_all.wait(0.01)
                    continue
                high: dict[int, int] = {}
                for part, off, key, msg in batch:
                    got.append((key, msg.new_entry.name))
                    high[part] = off + 1
                for part, n in high.items():
                    q.commit("g", part, n)
            errors.append(TimeoutError("the consumer did not drain within 60 s"))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    tp = threading.Thread(target=producer)
    tc = threading.Thread(target=consumer)
    tp.start()
    tc.start()
    tp.join(60)
    tc.join(60)
    assert not errors, errors
    assert len(got) >= total
    assert {n for _, n in got} == {f"m{i:04d}" for i in range(total)}
    for k in range(5):
        names = [n for key, n in got if key == f"/k{k}"]
        assert names == sorted(names), f"key {k} out of order"
    q.close()


def test_cursor_commit_survives_every_crash_state(tmp_path):
    """A crash anywhere inside commit() leaves the cursor at the old or
    the new offset, never torn (the reference's crash enumerator over
    the port's util/durable publish)."""
    q = _mk(tmp_path, partitions=1)
    for i in range(10):
        q.send_message("/k", _event(f"m{i}"))
    assert len(q.poll("g", max_records=10)) == 10
    q.commit("g", 0, 5)
    assert q.committed("g", 0) == 5

    rec = ref_crash.Recorder(os.path.join(str(tmp_path / "q"), "p000", "offsets"))
    with rec:
        q.commit("g", 0, 9)
    states, truncated, _n = ref_crash.enumerate_states(rec.trace, budget=256)
    assert not truncated and states
    seen = set()
    for s in states:
        cur = s.files.get("g")
        assert cur in (b"5", b"9"), f"torn cursor {cur!r} at crash index {s.crash_index}"
        seen.add(cur)
    assert seen == {b"5", b"9"}
    q.close()


# ----------------------------------------------------------------------
# across the packages


def _appends(side: str, qdir: str, segment_bytes: int = 512):
    """The same 40 appends over 12 keys into a 4-partition queue of one
    package, a few records cut into several segments each; one group
    commits part of the way."""
    q = LQ[side].PartitionedLogQueue(qdir, partitions=4, segment_bytes=segment_bytes)
    for i in range(40):
        ev = PB[side].EventNotification(delete_chunks=bool(i % 3 == 0))
        ev.new_entry.name = f"n{i:03d}"
        ev.new_entry.chunks.add(fid=f"{i % 7 + 1},{i:08x}", size=i * 100)
        ev.new_parent_path = f"/d{i % 4}"
        q.send_message(f"/d{i % 4}/k{i % 12}", ev)
    for part, off, _, _ in q.poll("half", max_records=16):
        q.commit("half", part, off + 1)
    q.close()


def _read_all(side: str, qdir: str) -> tuple:
    q = LQ[side].PartitionedLogQueue(qdir, partitions=2)  # meta.json's 4 wins
    records = [(p, o, k, m.SerializeToString()) for p, o, k, m in
               q.poll("fresh", max_records=1000)]
    rest = [(p, o) for p, o, _, _ in q.poll("half", max_records=1000)]
    depths = (q.depth("fresh"), q.depth("half"), len(q.partitions))
    q.close()
    return records, rest, depths


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_package_reads_the_others_queue(tmp_path, writer, reader):
    """A queue directory one package wrote reads the same through the
    other: every record (partition, offset, key, message bytes), each
    group's cursor and the depths."""
    qdir = str(tmp_path / "q")
    _appends(writer, qdir)
    got = _read_all(reader, qdir)
    want = _read_all(writer, qdir)
    assert got == want
    records, rest, depths = got
    assert len(records) == 40 and depths == (40, 40 - 16, 4) and len(rest) == 24


def test_same_appends_write_the_same_bytes(tmp_path, monkeypatch):
    """The same appends through either package, with the record header's
    clock held at one value, leave the same files with the same bytes:
    meta.json, every segment and every cursor."""
    trees = {}
    for side in ("ref", "port"):
        monkeypatch.setattr(LQ[side], "time", types.SimpleNamespace(time=lambda: 1.75e9))
        root = tmp_path / side
        _appends(side, str(root))
        trees[side] = {os.path.relpath(os.path.join(d, n), root):
                       open(os.path.join(d, n), "rb").read()
                       for d, _, names in os.walk(root) for n in names}
    assert trees["port"] == trees["ref"]
    assert sum(n.endswith(".seg") for n in trees["port"]) > 4
    assert {n for n in trees["port"] if "offsets" in n} == {
        f"p{i:03d}/offsets/half" for i in range(4)}


def test_post_to_a_port_filer_reaches_the_logqueue(tmp_path):
    """A port filer publishes each mutation to the logqueue under its
    full path, and its /metrics lag gauge counts them."""
    qdir = str(tmp_path / "lq")
    notification.queue = PartitionedLogQueue(qdir, partitions=4)
    cluster = None
    try:
        cluster = PortCluster(str(tmp_path / "src"))
        post(cluster.filer_addr, "/buckets/g/a.bin", b"a" * 100)
        post(cluster.filer_addr, "/buckets/g/b.bin", b"b" * 200)
        depth = notification.queue.depth("replicate")
        assert depth >= 2
        with urllib.request.urlopen(f"http://{cluster.filer_addr}/metrics", timeout=30) as r:
            text = r.read().decode()
        assert f'weed_replication_lag_events{{group="replicate"}} {depth}' in text, [
            ln for ln in text.splitlines() if "replication_lag" in ln]
        keys = [k for _, _, k, _ in notification.queue.poll("look", max_records=100)]
        assert {"/buckets/g/a.bin", "/buckets/g/b.bin"} <= set(keys)
    finally:
        notification.queue.close()
        notification.queue = None
        if cluster is not None:
            cluster.stop()
